"""Pipeline: text boxes handed to rec a page: real rec rows over the
pages the det waves took, both in the window."""


def read(run):
    pages = sum(len(w[2]) for w in run.det_waves())
    if not pages:
        return None
    return sum(len(c[2]) for c in run.rec_calls()) / pages
