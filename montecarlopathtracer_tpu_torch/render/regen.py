"""Regenerating-wavefront renderer: a lane whose path ends starts the
next sample of its pixel at once.

The counterpart of ``montecarlopathtracer_tpu/render/regen.py``. The
scan integrator (:func:`.integrator.trace_radiance_soa`) runs every
segment at full width while the live share of an RR wavefront decays;
here lane ``i`` is pinned to pixel ``i`` and traces that pixel's ``spp``
samples back to back. The step a path ends (miss, emitter, final gather,
RR death, hard kill), its radiance is added to the lane's sum and the
lane restarts with a fresh camera ray, until every lane has finished its
quota. Each step is one whole segment with per-lane flags (kernel B1l,
B1l with chunk culling when ``chunk_cull`` is set, or B5 and B6l on the
traversal path), since one wavefront mixes path depths. As in the JAX
package, regen needs the ``"megakernel"`` or ``"traverse"`` intersector
and runs whole segments whatever ``whole_segment`` says.

Estimator: unbiased and deterministic, with the JAX package's stream
ids: a step's segment draws come from streams ``(step-1)*4 + k``, the
camera jitter of the first wavefront from ``1<<30`` and ``(1<<30)+1``
and that of step ``s`` from ``(1<<30)+2s`` and ``(1<<30)+2s+1``; fixed
mode draws no RR uniform. At ``spp = 1`` no lane regenerates and every
live lane is at depth ``step - 1``, so the result is bit-identical to
the scan integrator's.

The JAX while-loop becomes a Python loop that looks at the live mask
only every :data:`LIVE_CHECK_EVERY` steps, each look being one
device-to-host sync. A step with no live lane changes nothing, so the
extra steps leave the result bit-identical. The bound of
``spp * num_segments + 1`` steps stays as a backstop.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.rng import Key, stream_uniform
from ..scene.camera import Camera
from ..scene.scene import ScenePack
from .integrator import WHOLE_SEGMENT, SceneTables, TraceConfig, scene_tables, segment_step

LIVE_CHECK_EVERY = 8  # steps between two reads of the live mask


@torch.no_grad()
def render_regen_planar(
    scene: ScenePack,
    camera: Camera,
    key: Key,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
    tables: Optional[SceneTables] = None,
) -> torch.Tensor:
    """Mean radiance over ``spp`` samples per pixel as planar
    f32[3, H, W]. Inference only. The frame is one wavefront: a
    ``ray_chunk`` is refused rather than ignored. (The JAX function's
    row band ``y0``, ``n_rows`` serves its sharded renderer, which is not
    ported.)"""
    if config.intersector not in WHOLE_SEGMENT:
        raise ValueError("regen rendering needs intersector='megakernel' or 'traverse', "
                         f"got {config.intersector!r}")
    if config.ray_chunk:
        raise ValueError(
            "the regenerating wavefront renders the frame as one wavefront; "
            f"ray_chunk={config.ray_chunk} is not supported with it"
        )
    if spp < 1:
        raise ValueError(f"spp must be at least 1, got {spp}")
    dev = camera.device
    R = width * height
    if tables is None:
        tables = scene_tables(scene, config)
    lanes = torch.arange(R, device=dev)
    xs = lanes % width
    ys = lanes // width

    def camera_rays(step):
        base = (1 << 30) if step == 0 else (1 << 30) + 2 * step
        jx = stream_uniform(key, base, R, dev) * 2.0 - 1.0
        jy = stream_uniform(key, base + 1, R, dev) * 2.0 - 1.0
        return camera.generate_rays_soa(xs, ys, jx, jy, width, height)

    pos, dir_ = camera_rays(0)
    pos, dir_ = pos.contiguous(), dir_.contiguous()
    tput = torch.ones(3, R, device=dev)
    res = torch.zeros(3, R, device=dev)
    accum = torch.zeros(3, R, device=dev)
    live = torch.ones(R, dtype=torch.bool, device=dev)
    depth = torch.zeros(R, dtype=torch.int64, device=dev)  # within the current path
    done = torch.zeros(R, dtype=torch.int64, device=dev)  # samples completed
    urr = torch.zeros(R, device=dev)
    max_steps = spp * config.num_segments + 1
    step = 1  # the segment at depth step - 1 when spp = 1
    while step < max_steps:
        if (step - 1) % LIVE_CHECK_EVERY == 0 and not bool(live.any()):
            break
        u1 = stream_uniform(key, (step - 1) * 4, R, dev)
        u2 = stream_uniform(key, (step - 1) * 4 + 1, R, dev)
        if config.mode == "rr":
            urr = stream_uniform(key, (step - 1) * 4 + 3, R, dev)
        npos, ndir, ntput, nres, still = segment_step(
            tables, config, pos, dir_, tput, res, live, u1, u2, urr,
            config.lane_flags(depth))
        still = still > 0.0
        ended = live & ~still
        accum = accum + torch.where(ended[None, :], nres, 0.0)
        regen = ended & (done + 1 < spp)
        live = (live & still) | regen
        done = done + ended
        depth = torch.where(regen, 0, depth + 1)

        posr, dirr = camera_rays(step)
        rg = regen[None, :]
        pos = torch.where(rg, posr, npos)
        dir_ = torch.where(rg, dirr, ndir)
        tput = torch.where(rg, 1.0, ntput)
        res = torch.where(rg, 0.0, nres)
        step += 1
    return accum.reshape(3, height, width) / float(spp)


def render_regen_batch(
    scene: ScenePack,
    camera: Camera,
    key: Key,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
    tables: Optional[SceneTables] = None,
) -> torch.Tensor:
    """:func:`render_regen_planar` over the whole frame as f32[H, W, 3]."""
    return render_regen_planar(scene, camera, key, width, height, spp, config,
                               tables).permute(1, 2, 0)
