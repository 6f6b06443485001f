"""Wavefront path-tracing integrator (SoA layout).

The counterpart of ``montecarlopathtracer_tpu/render/integrator.py`` on
its whole-segment megakernel path. All R rays advance one path segment
per step; terminated lanes are masked. Each step is ONE call of
:func:`..ops.segment_fused.mega_segment` (a kernel launch for CUDA
tensors), and the steps are a Python loop.

Termination strategies (:class:`TraceConfig`):

- ``mode="fixed"`` — CUDA semantics: exactly ``max_depth`` scatter
  bounces, then one extra intersection that collects emission only;
  emitters scale by ``illum``.
- ``mode="rr"`` — HLSL semantics: Russian roulette after ``rr_depth``
  bounces (survive w.p. max(throughput), compensate by 1/p) and a hard
  kill at ``3*rr_depth``; use ``illum=1``.

Random streams are those of the JAX package, so a render here equals
the JAX package's CPU render up to float rounding: segment ``s`` draws
u1, u2 and (RR only) urr from streams ``4s``, ``4s+1`` and ``4s+3`` of
the sample key; pixel jitter uses streams ``1<<30`` and ``(1<<30)+1``;
ray tile ``i`` (``ray_chunk``) traces under ``fold_in(key, (1<<29)+i)``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.rng import Key, fold_in, stream_uniform
from ..ops.segment_fused import mega_segment, pack_rows_full
from ..scene.camera import Camera
from ..scene.scene import ScenePack


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Integrator configuration."""

    mode: str = "fixed"  # "fixed" (CUDA) or "rr" (HLSL)
    max_depth: int = 7  # scatter bounces in "fixed" mode
    rr_depth: int = 5  # RR start in "rr" mode
    illum: float = 10.0  # emitter scale; 1.0 for HLSL
    eps_offset: float = 0.01  # self-intersection offset
    refract_kd: bool = True  # CUDA multiplies Kd on refract; HLSL doesn't
    phong_model: str = "blinn"  # "blinn" (half-vector) or "phong"
    intersector: str = "megakernel"
    ray_chunk: int = 0  # rays per wavefront tile; 0 = whole frame

    def __post_init__(self):
        if self.intersector != "megakernel":
            raise NotImplementedError(
                f"intersector {self.intersector!r} is not ported yet; only "
                "'megakernel' is (see ROADMAP.md, queue A8 and B4-B7)"
            )
        if self.mode not in ("fixed", "rr"):
            raise ValueError(f"unknown mode {self.mode!r}")

    @property
    def num_segments(self) -> int:
        """Intersections per path."""
        if self.mode == "fixed":
            return self.max_depth + 1  # + final emission gather
        return 3 * self.rr_depth + 1  # hard kill boundary

    def segment_flags(self, device) -> torch.Tensor:
        """f32[num_segments, 3, 1]: [final_gather, do_rr, hard_kill] per
        segment."""
        flags = torch.zeros(self.num_segments, 3, 1)
        for s in range(self.num_segments):
            if self.mode == "fixed":
                flags[s, 0] = float(s == self.max_depth)
            else:
                flags[s, 1] = float(self.rr_depth <= s < 3 * self.rr_depth)
                flags[s, 2] = float(s >= 3 * self.rr_depth)
        return flags.to(device)


def trace_radiance_soa(
    scene: ScenePack,
    pos3: torch.Tensor,  # f32[3, R]
    dir3: torch.Tensor,  # f32[3, R] unit
    key: Key,
    config: TraceConfig,
    rows: torch.Tensor = None,
) -> torch.Tensor:
    """Estimate radiance along R rays. Returns f32[3, R].

    ``rows`` is :func:`pack_rows_full` of ``scene``; pass it to reuse
    one table across calls."""
    dev = pos3.device
    R = pos3.shape[1]
    if rows is None:
        rows = pack_rows_full(scene)
    flags = config.segment_flags(dev)
    pos = pos3.contiguous()
    dir_ = dir3.contiguous()
    tput = torch.ones(3, R, device=dev)
    result = torch.zeros(3, R, device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    urr = torch.zeros(R, device=dev)
    for seg in range(config.num_segments):
        u1 = stream_uniform(key, seg * 4 + 0, R, dev)
        u2 = stream_uniform(key, seg * 4 + 1, R, dev)
        if config.mode == "rr":
            urr = stream_uniform(key, seg * 4 + 3, R, dev)
        _, pos, dir_, tput, result, still = mega_segment(
            rows, pos, dir_, tput, result, active, u1, u2, urr, flags[seg],
            mode=config.mode, illum=config.illum,
            eps_offset=config.eps_offset, refract_kd=config.refract_kd,
            phong_model=config.phong_model,
        )
        active = still > 0.0
    return result


def render_rows_planar(
    scene: ScenePack,
    camera: Camera,
    key: Key,
    width: int,
    height: int,
    y0: int,
    n_rows: int,
    config: TraceConfig,
    rows: torch.Tensor = None,
) -> torch.Tensor:
    """One sample per pixel for image rows [y0, y0+n_rows). Returns
    planar f32[3, n_rows, W]."""
    dev = camera.device
    R = width * n_rows
    pix = torch.arange(R, device=dev)
    xs = pix % width
    ys = pix // width + y0
    jx = stream_uniform(key, 1 << 30, R, dev) * 2.0 - 1.0
    jy = stream_uniform(key, (1 << 30) + 1, R, dev) * 2.0 - 1.0
    pos3, dir3 = camera.generate_rays_soa(xs, ys, jx, jy, width, height)
    if rows is None:
        rows = pack_rows_full(scene)

    rc = config.ray_chunk
    if rc <= 0 or rc >= R:
        radiance = trace_radiance_soa(scene, pos3, dir3, key, config, rows)
    else:
        # Ray tiles trace one after another; the padded tail rays start
        # at the origin looking +z, as in the JAX package.
        pad = (-R) % rc
        if pad:
            pos3 = torch.cat([pos3, torch.zeros(3, pad, device=dev)], dim=1)
            dpad = torch.tensor([[0.0], [0.0], [1.0]], device=dev).expand(3, pad)
            dir3 = torch.cat([dir3, dpad], dim=1)
        tiles = [
            trace_radiance_soa(
                scene, pos3[:, s:s + rc], dir3[:, s:s + rc],
                fold_in(key, (1 << 29) + i), config, rows,
            )
            for i, s in enumerate(range(0, R + pad, rc))
        ]
        radiance = torch.cat(tiles, dim=1)[:, :R]
    return radiance.reshape(3, n_rows, width)


def render_sample_batch(
    scene: ScenePack,
    camera: Camera,
    key: Key,
    width: int,
    height: int,
    config: TraceConfig,
) -> torch.Tensor:
    """One sample per pixel over the full frame. Returns f32[H, W, 3]."""
    return render_rows_planar(
        scene, camera, key, width, height, 0, height, config
    ).permute(1, 2, 0)
