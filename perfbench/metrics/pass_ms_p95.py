"""The 95th percentile (nearest rank) over every pass of the window of
the time from its dispatch to its frame on the host, in ms."""

import math


def read(run):
    if run.kind != "progressive":
        return None
    ms = sorted((done - start) * 1e3 for start, _, done in run.window.events)
    return ms[max(0, math.ceil(0.95 * len(ms)) - 1)]
