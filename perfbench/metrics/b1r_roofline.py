"""Kernel B1r's share of its roofline, in %: the bound of the work the
traced passes needed (counts.py: the triangles whose boxes each segment
reaches, and the entry's bytes) over the kernel's device time in the
trace, against the card's published peaks. The note names the side that
binds."""

from perfbench import counts

ENTRY = "B1r"


def read(run):
    entry = (run.work or {}).get(ENTRY)
    if entry is None or run.trace is None or run.peak is None:
        return None
    launches, seconds = run.trace.kernel(entry["kernel"])
    if launches == 0 or seconds <= 0.0:
        return None
    share, side = counts.roofline(entry, launches, seconds, run.peak)
    return share, f"bound by {side}; {launches} launches, {seconds!r} s on the device"
