"""Pipeline: the det stage's host wall ms a page (utils/profiling
GLOBAL "det": upload to boxes, the det batcher's wait included), over the
pages that ran while the stage timer was on."""


def read(run):
    return run.stage_ms("det")
