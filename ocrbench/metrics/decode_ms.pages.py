"""Codec: the mean ms of the benchmark's span around the port's
imcodec.imdecode, over the pages decoded in the window."""


def read(run):
    spans = [(a, b) for a, b in run.counts.spans.get("page decode", [])
             if run.within(a)]
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) / 1e6
