"""The host's time folding a pass's stream keys and staging them for the
card: the program's span ``mcpt.regen.keys`` (``ops/regen_pass.py``:
``pass_keys`` and the pinned copy's enqueue), summed over the traced
window, over its passes, in ms."""

from perfbench import recorded


def read(run):
    rec = recorded.record(run)
    keys = (rec or {}).get("spans", {}).get("regen.keys")
    if not keys:
        return None
    count, seconds = keys
    return seconds / rec["passes"] * 1e3, f"{count} spans over {rec['passes']} passes"
