"""Kernel B1rc's share of its roofline, in %: the bound of the work the
traced passes needed (counts_cull.py: the triangles whose boxes each
segment reaches, and the culled table's bytes) over the culled regen
pass kernel's device time in the trace, against the card's published
peaks. The note names the side that binds and the launches."""

from perfbench import counts

ENTRY = "B1rc"


def read(run):
    entry = (run.work or {}).get(ENTRY)
    if entry is None or run.trace is None or run.peak is None:
        return None
    launches, seconds = run.trace.kernel(entry["kernel"])
    if launches == 0 or seconds <= 0.0:
        return None
    share, side = counts.roofline(entry, launches, seconds, run.peak)
    return share, f"bound by {side}; {launches} launches, {seconds!r} s on the device"
