"""Kernel B1rc's useful share of its slots, in %: the slot-steps that
advanced a live lane (the kernel's own counters, summed over the traced
window's launches) over every slot-step its blocks ran. Read only where
the window's launches are the culled instance's. The note gives the
lanes over the staged bound (overflow) and the blocks that ran a step
against those launched."""

from perfbench import recorded


def read(run):
    rec = recorded.record(run)
    if rec is None or rec["slot_steps"] <= 0 or not rec["launches"].get("B1rc") \
            or rec["launches"].get("B1r"):
        return None
    return (100.0 * rec["live_steps"] / rec["slot_steps"],
            f"overflow {rec['overflow']}; blocks {rec['blocks']} of {rec['grid']} launched; "
            f"{rec['launches']['B1rc']} launches")
