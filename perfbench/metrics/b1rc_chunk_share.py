"""The share of the culled table's chunks that kernel B1rc's vote tests
for a live lane-step, in %: the kernel's ``vote_chunks`` (the chunks a
block's vote tested, times the block-step's live lanes) over its live
lane-steps times the table's chunks (the program's ``chunks``, summed
over the launches, over the launches), over the traced window. Read
only where the window's launches are the culled instance's and the
program counts the chunks. The note gives the chunks a lane-step and
the table's."""

from perfbench import recorded


def read(run):
    rec = recorded.record(run)
    if rec is None or rec["live_steps"] <= 0 or not rec["launches"].get("B1rc") \
            or rec["launches"].get("B1r") or not rec.get("chunks"):
        return None
    per_pass = rec["chunks"] / rec["launches"]["B1rc"]
    per_step = rec["vote_chunks"] / rec["live_steps"]
    return (100.0 * per_step / per_pass,
            f"{per_step!r} chunks tested a live lane-step of {per_pass!r}")
