"""What the program kept of a traced run's window: its own spans' host
time and its pass kernel's counters, as
``montecarlopathtracer_tpu_torch.utils.profiling.traced()`` sums them
over the stretch of passes the profiler recorded. The readers of the
program's spans and counters share it."""

from __future__ import annotations

from typing import Optional


def record(run) -> Optional[dict]:
    """The program's record of the traced window, or None: an untraced
    run, a program that keeps no record, or a record that is not the
    window's (another count of passes)."""
    if run.kind != "progressive" or run.trace is None:
        return None
    from montecarlopathtracer_tpu_torch.utils import profiling

    traced = getattr(profiling, "traced", None)
    rec = traced() if traced is not None else None
    if rec is None or rec["passes"] != len(run.window.events):
        return None
    return rec
