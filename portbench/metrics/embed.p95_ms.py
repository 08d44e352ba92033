"""embed.p95_ms (ms): the 95th percentile of the traced window's requests,
each from its submit until its results are on the host: the tail that the
search queries spend queued behind the index builder's waves and copies."""


def read(view, window, cell):
    return window.units.get("p95_ms")
