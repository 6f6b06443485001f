"""Regenerating-wavefront renderer: a lane whose path ends starts the
next sample of its pixel at once.

The counterpart of ``montecarlopathtracer_tpu/render/regen.py``. The
scan integrator (:func:`.integrator.trace_radiance_soa`) runs every
segment at full width while the live share of an RR wavefront decays;
here lane ``i`` is pinned to pixel ``i`` and traces that pixel's ``spp``
samples back to back. The step a path ends (miss, emitter, final gather,
RR death, hard kill), its radiance is added to the lane's sum and the
lane restarts with a fresh camera ray, until every lane has finished its
quota. Each step is one whole segment with per-lane flags, since one
wavefront mixes path depths. As in the JAX package, regen needs the
``"megakernel"`` or ``"traverse"`` intersector and runs whole segments
whatever ``whole_segment`` says.

Where the pass runs (:mod:`..ops.regen_pass`):

- ``"megakernel"``, with or without ``chunk_cull``: one call of
  :func:`..ops.regen_pass.regen_pass`. On the card that is one launch
  of kernel B1r, whose persistent blocks pull lanes from a work list and
  run every step of them inside the kernel (the counterpart of JAX's
  ``lax.while_loop``, one device program); on the CPU its plain version,
  the host loop. A :class:`LaneHistory` (the Renderer keeps one) hands
  B1r's list out longest lane first, by the lanes' steps in the previous
  pass of the same band, spp and tables; the culled instance keeps row
  order;
- ``"traverse"``: the host loop :func:`..ops.regen_pass.regen_pass_ref`,
  whose steps launch the walk B5 and the segment B6l on the card.

Estimator: unbiased and deterministic, with the JAX package's stream
ids: a step's segment draws come from streams ``(step-1)*4 + k``, the
camera jitter of the first wavefront from ``1<<30`` and ``(1<<30)+1``
and that of step ``s`` from ``(1<<30)+2s`` and ``(1<<30)+2s+1``; fixed
mode draws no RR uniform. At ``spp = 1`` no lane regenerates and every
live lane is at depth ``step - 1``, so the result is bit-identical to
the scan integrator's.

The host loop looks at the live mask only every
:data:`..ops.regen_pass.LIVE_CHECK_EVERY` steps, each look being one
device-to-host sync; a step with no live lane changes nothing, so the
extra steps leave the result bit-identical. In the kernel each lane
counts its own steps, which are the loop's, and leaves its slot when it
is done. The bound of ``spp * num_segments + 1`` steps stays as a
backstop.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import regen_pass as RP
from ..ops.rng import Key
from ..scene.camera import Camera
from ..scene.scene import ScenePack
from ..utils.profiling import span
from .integrator import WHOLE_SEGMENT, SceneTables, TraceConfig, scene_tables


class LaneHistory:
    """The work-list order for the next pass, learned from the last: the
    lanes' ``lane_steps`` of a pass on the card, sorted longest first
    (:func:`..ops.regen_pass.longest_first`, enqueued right after the
    pass's launch, no host sync), kept for the pass's shape (band, spp,
    config, tables). A pass of another shape, or the first, or one on the
    CPU, runs in row order. A pixel's lanes take about as many steps from
    pass to pass, and an order that no longer fits (the scene changed)
    costs balance, never correctness. :func:`render_regen_planar` uses it
    for the plain instance (B1r) only."""

    def __init__(self):
        self.shape = None
        self.order = None

    def order_for(self, shape) -> Optional[torch.Tensor]:
        return self.order if shape == self.shape else None

    def learn(self, shape, lane_steps: torch.Tensor) -> None:
        if lane_steps.device.type != "cuda":
            return
        with span("regen.order"):
            self.shape, self.order = shape, RP.longest_first(lane_steps)


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
    y0: int = 0,
    n_rows: int = 0,
    lanes: Optional[LaneHistory] = None,
) -> torch.Tensor:
    """Mean radiance over ``spp`` samples per pixel as planar
    f32[3, n_rows, W] for image rows [y0, y0+n_rows) (``n_rows=0``: the
    whole frame). Inference only. The band is one wavefront: a
    ``ray_chunk`` is refused rather than ignored. The row band serves
    the sharded renderer (:func:`..parallel.sharded.sharded_regen_pass`):
    lanes pin to the band's pixels, and every stream draws one value per
    lane of the band, as in the JAX package. ``lanes``: the caller's
    :class:`LaneHistory`, which orders this pass's work list from the
    last pass of its shape and learns from this one."""
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
    if not n_rows:
        n_rows = height
    if tables is None:
        tables = scene_tables(scene, config)
    if config.intersector != "megakernel":
        accum, _ = RP.regen_pass_ref(tables, config, camera, key, width, height, spp, y0, n_rows)
    elif lanes is None or config.chunk_cull:
        # The culled instance (B1rc) ran 2.6-5.6 % slower longest first on
        # the glossy stage, though its tail fell (PERF.md §6): its cost a
        # step follows the chunks its warps' rays reach, not its live lanes.
        accum, _ = RP.regen_pass(tables, config, camera, key, width, height, spp, y0, n_rows)
    else:
        shape = (width, height, y0, n_rows, spp, config, id(tables))
        accum, steps = RP.regen_pass(tables, config, camera, key, width, height, spp, y0,
                                     n_rows, order=lanes.order_for(shape))
        lanes.learn(shape, steps)
    return accum.reshape(3, n_rows, width) / float(spp)


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
