"""The median over every pass of the window of the time from its
dispatch to its frame on the host, in ms: a steadier statistic beside
the tail."""

import statistics


def read(run):
    if run.kind != "progressive":
        return None
    return statistics.median((done - start) * 1e3 for start, _, done in run.window.events)
