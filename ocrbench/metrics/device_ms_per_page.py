"""Models: the device's busy ms (union of its operations in the
trace) a page answered in the window."""


def read(run):
    if not run.pages:
        return None
    return 1000.0 * run.busy_s / run.pages
