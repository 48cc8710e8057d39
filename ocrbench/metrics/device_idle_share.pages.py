"""Device: the share of the traced window with no operation on the
device, in percent."""


def read(run):
    return run.idle_share()
