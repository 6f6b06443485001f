"""The work of a gradient step's kernels, whatever implements them: the
yardstick of the rooflines of B1 (the segment forward), B2 (its vjp)
and B3 (the row scatter), a launch each per segment of each sample
batch of a step, every launch over the whole frame's lanes (a lane whose
path has ended passes its state through). Each entry gives the work of
one call (B3's three kernels are one call), averaged over a step's
calls, for :func:`.counts.roofline`.

The lanes each segment sees, counted by the plain reference on a seeded
sample of the frame's pixels for window step 1's batches and scaled to
the frame: those that enter it (live), that hit a triangle (hit), that
go on (still), and the triangles whose bounding box each live lane's
segment enters before its hit (its exit, on a miss).

- B1: operations, the boxes reached at :data:`.counts.OPS_PER_TEST` a
  test; bytes, the row table once, every lane's mask, position,
  direction, throughput and radiance read and its index, new state and
  ``still`` written, a live lane's three uniforms read.
- B2 (no operation count: bytes bound it): every lane's mask, hit flag,
  position, direction, throughput and four cotangents read and its four
  state adjoints and row adjoint written; a hit lane's shading row, a
  lane that goes on its geometry row and two uniforms (and ``urr``, live,
  in ``rr`` mode).
- B3: every lane's index read, a hit lane's row adjoint read, the
  table's adjoint written.
"""

from __future__ import annotations

import numpy as np
import torch

from .counts import F32, OPS_PER_TEST
from .reference import inverse as RI
from .reference import threefry as TF
from .reference import tracer as R

ROW = 48  # floats of a triangle's row
B3_KERNELS = 3  # the scatter's sort, sum and combine kernels, one launch each a call


def lanes(ctx, est: R.Estimator, n_pixels: int):
    """Window step 1's lanes on ``n_pixels`` pixels drawn from the seed,
    summed over its batches, per segment ({"live", "hit", "still",
    "boxes"}), and the pixels."""
    W, H = ctx.width, ctx.height
    dev = ctx.device
    pix = np.sort(ctx.rng(2).choice(W * H, size=min(n_pixels, W * H), replace=False))
    scene = R.prepare_scene(ctx.scene_arrays(), dev)
    cam = R.make_camera(ctx.camera(), W, H, dev)
    stats = {}
    with torch.no_grad():
        RI.render(scene, cam, est, torch.as_tensor(pix, device=dev),
                  TF.fold_in(TF.make_key(ctx.seed32), 1), int(ctx.traffic["spp_per_pass"]),
                  stats=stats)
    return stats, len(pix)


def work(ctx, est: R.Estimator) -> dict:
    """{"B1", "B2", "B3": {"kernel": the name in the trace (a part of it
    for B3's kernels), "launches_a_call", "ops", "bytes"}}, a call."""
    tr = ctx.traffic
    R_, spp = ctx.width * ctx.height, int(tr["spp_per_pass"])
    if tr["chunk_cull"] or tr["regen"] or tr["intersector"] != "megakernel":
        raise ValueError("the count covers the unculled segment loop's B1, B2 and B3 only")
    T = ctx.scene_arrays().num_triangles
    calls = spp * est.num_segments
    stats, n = lanes(ctx, est, int(tr["reach_pixels"]))
    total = {k: sum(s[k] for s in stats.values()) * R_ / n for k in ("live", "hit", "still",
                                                                     "boxes")}
    flags = 3 * F32
    # Every lane, every call: B1 reads its mask (1) and state (12 floats)
    # and writes its index, new state and still (1 + 12 + 1 words); B2
    # reads its mask and hit flag (2), position, direction and throughput
    # (9 floats) and four cotangents (12), and writes four adjoints (12)
    # and its row adjoint (48); B3 reads its index.
    b1 = calls * (T * ROW * F32 + R_ * (1 + 12 * F32 + 14 * F32) + flags) \
        + total["live"] * 3 * F32
    b2 = calls * (R_ * (2 + (9 + 12 + 12 + ROW) * F32) + flags) \
        + total["hit"] * 21 * F32 + total["still"] * (12 + 2) * F32 \
        + (total["live"] * F32 if est.mode == "rr" else 0.0)
    b3 = calls * (R_ * 4 + T * ROW * F32) + total["hit"] * ROW * F32
    return {
        "B1": {"kernel": "mega_segment_kernel<false>", "launches_a_call": 1,
               "ops": OPS_PER_TEST * total["boxes"] / calls, "bytes": b1 / calls},
        "B2": {"kernel": "segment_backward_kernel", "launches_a_call": 1, "ops": 0.0,
               "bytes": b2 / calls},
        "B3": {"kernel": "scatter_rows_", "launches_a_call": B3_KERNELS, "ops": 0.0,
               "bytes": b3 / calls},
    }
