"""What the program kept of a traced window of gradient steps: its own
spans' host time, as
``montecarlopathtracer_tpu_torch.utils.profiling.traced()`` sums them
over the stretch the profiler recorded. The readers of the step's spans
share it (``recorded.py`` is the Renderer's passes')."""

from __future__ import annotations

from typing import Optional


def record(run) -> Optional[dict]:
    """The program's record of the traced window, or None: an untraced
    run, a program that keeps no record or counts no steps, or a record
    that is not the window's (another count of steps)."""
    if run.kind != "progressive" or run.trace is None:
        return None
    from montecarlopathtracer_tpu_torch.utils import profiling

    traced = getattr(profiling, "traced", None)
    rec = traced() if traced is not None else None
    if rec is None or rec.get("steps") != len(run.window.events):
        return None
    return rec


def host_ms(run, span: str):
    """(host ms a step in the program's span ``span``, note), or None."""
    rec = record(run)
    got = (rec or {}).get("spans", {}).get(span)
    if not got:
        return None
    count, seconds = got
    return seconds / rec["steps"] * 1e3, f"{count} spans over {rec['steps']} steps"
