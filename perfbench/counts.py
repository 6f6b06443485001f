"""The work a pass needs, whatever implements it: the yardstick of the
kernels' rooflines.

- Operations: for each ray segment of the pass, the triangles whose
  bounding box the segment enters before its hit (before it leaves the
  scene, for a miss), at :data:`OPS_PER_TEST` operations a test. Any
  triangle-granular method (brute force, culling, a tree) has to test
  those. Counted by the plain reference on a seeded sample of the pass's
  pixels and scaled to the frame.
- Bytes: the entry's declared inputs read once and its outputs written
  once.
- The bound: the larger of the operations over the card's float32 rate
  outside the tensor cores and the bytes over its memory bandwidth
  (``peaks.json``).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import threefry as TF
from .reference import tracer as R

OPS_PER_TEST = 17  # a ray-triangle test: its transform rows, t, beta, gamma and the accept chain
F32 = 4


def reach(ctx, est: R.Estimator, pass_index: int, spp: int, n_pixels: int):
    """Boxes reached per depth on ``n_pixels`` pixels drawn from the seed,
    for the samples of pass ``pass_index`` (a lane a pixel, its samples
    back to back): ({depth: boxes}, pixels)."""
    W, H = ctx.width, ctx.height
    dev = ctx.device
    pix = np.sort(ctx.rng(2).choice(W * H, size=min(n_pixels, W * H), replace=False))
    scene = R.prepare_scene(ctx.scene_arrays(), dev)
    cam = R.make_camera(ctx.camera(), W, H, dev)
    keys = TF.fold_in(TF.make_key(ctx.seed32)[None], [pass_index])
    keytab = torch.as_tensor(R.key_tables(keys, est.max_steps(spp)).astype(np.int64), device=dev)
    pixels = torch.as_tensor(pix, device=dev)
    group = torch.zeros(len(pix), dtype=torch.int64, device=dev)
    got = {}
    R.run_lanes(scene, cam, est, pixels, keytab, group, spp, reach=got, block=R.BLOCK)
    return got, len(pix)


def work(ctx, est: R.Estimator) -> dict:
    """The pass's work for the regen pass B1r: ``{"B1r": {"kernel": its
    name in the trace, "ops", "bytes"}}`` a pass. Bytes: the row table
    f32[T, 48], the key table, the camera and the arguments in; the
    accumulation f32[3, R] and the lane steps i32[R] out."""
    tr = ctx.traffic
    R_, spp = ctx.width * ctx.height, int(tr["spp_per_pass"])
    if tr["chunk_cull"] or not tr["regen"]:
        raise ValueError("the count covers the unculled regen pass B1r only")
    T = ctx.scene_arrays().num_triangles
    tested, n = reach(ctx, est, 1, spp, int(tr["reach_pixels"]))
    ops = OPS_PER_TEST * sum(tested.values()) * R_ / n
    keys = est.max_steps(spp) * 5 * 2 * 4
    nbytes = T * 48 * F32 + keys + 14 * F32 + R_ * (3 * F32 + 4) + 10 * 8
    return {"B1r": {"kernel": "regen_pass_kernel<false>", "ops": ops, "bytes": nbytes}}


def roofline(entry: dict, launches: int, device_s: float, peak: dict):
    """The share of the bound in the kernel's device time, in %, and the
    side that binds (``"ops"`` or ``"bytes"``), over ``launches`` passes'
    launches that took ``device_s`` on the device."""
    t_ops = entry["ops"] / peak["f32_flops"]
    t_bytes = entry["bytes"] / peak["bytes_per_s"]
    return 100.0 * max(t_ops, t_bytes) * launches / device_s, "ops" if t_ops >= t_bytes else "bytes"
