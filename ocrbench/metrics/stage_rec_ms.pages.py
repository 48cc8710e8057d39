"""Pipeline: the fused rec stage's host wall ms a page (utils/profiling
GLOBAL "cls_rec_fused": crops, scores and recognition, the rec batcher's
wait included), over the pages that ran while the stage timer was on."""


def read(run):
    return run.stage_ms("cls_rec_fused")
