"""Device: the model FLOPs of the det and rec forwards in the window
(ocrbench/flops: each real page at its det size, each real rec row at the
width its model reads) over the window and the float32 peak, in percent."""


def read(run):
    return run.mfu()
