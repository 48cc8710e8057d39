"""Batchers: real rows over padded rows of every rec call in the
window, in percent."""


def read(run):
    return run.rec_fill()
