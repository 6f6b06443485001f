"""The readers of the gradient step's kernel rooflines share this: a
kernel's calls and device time in the trace, against
``counts_grad.py``'s work a call."""

from __future__ import annotations

from . import counts


def read(run, name: str):
    """(share in %, note) of entry ``name`` of the run's work, or None
    where the run holds nothing to read."""
    entry = (run.work or {}).get(name)
    if entry is None or run.trace is None or run.peak is None:
        return None
    launches, seconds = run.trace.kernel(entry["kernel"])
    calls = launches // entry["launches_a_call"]
    if calls == 0 or seconds <= 0.0:
        return None
    share, side = counts.roofline(entry, calls, seconds, run.peak)
    return share, (f"bound by {side}; {calls} calls, {launches} launches, "
                   f"{seconds!r} s on the device")
