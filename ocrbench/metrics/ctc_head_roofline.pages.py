"""Kernel 1 (csrc/ctc_head.cu): the least time of its launches in the
window (ocrbench/flops.ctc_head_least_s from each launch's shapes) over
their device time in the trace, in percent."""


def read(run):
    return run.ctc_head_roofline()
