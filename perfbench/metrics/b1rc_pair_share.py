"""The share of the leaves kernel B1rc's warps tested that took its pair
path, in %: the kernel's ``pair_leaves`` (leaves that fewer than
``kPairFrom`` of the warp's rays reach, each reaching ray tested against
the leaf's records across a half-warp) over its ``leaf_visits`` (the
leaves a warp's vote took), summed over the traced window's launches.
Read only where the window's launches are the culled instance's and the
program counts its leaves. The note gives the leaves a live lane-step."""

from perfbench import recorded


def read(run):
    rec = recorded.record(run)
    if rec is None or not rec.get("leaf_visits") or rec.get("pair_leaves") is None \
            or rec["live_steps"] <= 0 or not rec["launches"].get("B1rc") \
            or rec["launches"].get("B1r"):
        return None
    return (100.0 * rec["pair_leaves"] / rec["leaf_visits"],
            f"{rec['leaf_visits'] / rec['live_steps']!r} leaves tested a live lane-step; "
            f"{rec['pair_leaves']} of {rec['leaf_visits']} by the pair path")
