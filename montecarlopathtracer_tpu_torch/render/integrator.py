"""Wavefront path-tracing integrator (SoA layout).

The counterpart of ``montecarlopathtracer_tpu/render/integrator.py`` on
its whole-segment paths. All R rays advance one path segment per step;
terminated lanes are masked; the steps are a Python loop. Intersectors
(``TraceConfig.intersector``):

- ``"megakernel"``: each step is ONE call of
  :func:`..ops.segment_fused.mega_segment` (kernel B1: brute nearest hit
  and the whole segment; a launch for CUDA tensors);
- ``"traverse"``, for large scenes: the triangle table is in Morton
  order, and each step is :func:`..ops.traverse_walk.traverse_select`
  (kernel B5: a per-tile walk over reachable chunks, front to back, with
  early exit) followed by :func:`..ops.segment_fused.rows_segment`
  (kernel B6: the segment from the known winners).

The scene-side tables (the row table, and for ``"traverse"`` the Morton
permutation and the chunk boxes) are built once per scene and device by
:func:`scene_tables`; pass them to reuse them across calls.

``ray_sort``: each step first sorts the wavefront by
:func:`..ops.morton.ray_sort_keys` (origin Morton code and direction
octant; lanes that are not live last), so that a tile of the walk holds
coherent rays and dead tiles are skipped at once. Rays carry their
original id and draw their own random streams, so the estimator is
bit-identical to the unsorted trace.

Gradients: when autograd is on (``torch.is_grad_enabled()``), each step
runs through :func:`..ops.segment_fused.whole_segment_megakernel` or
:func:`..ops.segment_fused.whole_segment_rows` instead, whose backward is
the segment vjp kernel and the row scatter (detached sampling with path
replay, as in the JAX package's ``diff/grad.py``). The backward keeps
only each segment's inputs and winner index and recomputes the rest from
them, so the JAX package's ``remat_segments`` policies have nothing
further to save here. Under ``torch.no_grad()`` (the :class:`Renderer`)
no graph is built.

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
from typing import Optional

import torch

from ..ops import segment_fused as F
from ..ops import traverse_walk as TW
from ..ops.morton import DEAD_KEY, chunk_aabbs_padded, morton_order, ray_sort_keys
from ..ops.rng import Key, fold_in, stream_uniform
from ..scene.camera import Camera
from ..scene.scene import ScenePack

INTERSECTORS = ("megakernel", "traverse")
_UNPORTED = ("fused", "brute", "kdtree")  # ROADMAP B4, B7 and A8


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
    intersector: str = "megakernel"  # or "traverse" (large scenes)
    ray_sort: bool = False  # sort the wavefront each segment
    chunk_cull: bool = False  # not ported (kernel B1c)
    ray_chunk: int = 0  # rays per wavefront tile; 0 = whole frame

    def __post_init__(self):
        if self.intersector in _UNPORTED:
            raise NotImplementedError(
                f"intersector {self.intersector!r} is not ported yet; "
                f"{' and '.join(map(repr, INTERSECTORS))} are (see ROADMAP.md, "
                "queues A8 and B4-B7)"
            )
        if self.intersector not in INTERSECTORS:
            raise ValueError(f"unknown intersector {self.intersector!r}")
        if self.chunk_cull:
            raise NotImplementedError(
                "chunk_cull (kernel B1c) is not ported yet; use "
                "intersector='traverse' (see ROADMAP.md, queue B1)"
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

    def lane_flags(self, depth: torch.Tensor) -> torch.Tensor:
        """f32[3, R]: the flags of :meth:`segment_flags` per lane, for
        lanes at path depth ``depth`` i64[R]."""
        zero = torch.zeros(depth.shape, device=depth.device)
        if self.mode == "fixed":
            return torch.stack([(depth == self.max_depth).float(), zero, zero])
        rr = self.rr_depth
        return torch.stack([zero, ((depth >= rr) & (depth < 3 * rr)).float(),
                            (depth >= 3 * rr).float()])

    def kernel_options(self) -> dict:
        return dict(mode=self.mode, illum=self.illum, eps_offset=self.eps_offset,
                    refract_kd=self.refract_kd, phong_model=self.phong_model)


@dataclasses.dataclass(frozen=True)
class SceneTables:
    """What the segment kernels read of a scene, on its device."""

    rows: torch.Tensor  # f32[T, 48] pack_rows_full; Morton order for "traverse"
    perm: Optional[torch.Tensor] = None  # i64[T] the Morton order ("traverse")
    clo: Optional[torch.Tensor] = None  # f32[nc, 3] chunk boxes ("traverse")
    chi: Optional[torch.Tensor] = None
    lo: Optional[torch.Tensor] = None  # f32[3] scene box (ray_sort)
    hi: Optional[torch.Tensor] = None


def scene_tables(scene: ScenePack, config: TraceConfig) -> SceneTables:
    """Build the scene's :class:`SceneTables` for ``config``. The row
    table carries gradients to the scene's fields; the permutation and
    boxes, which only choose which triangles are tested, do not."""
    rows = F.pack_rows_full(scene)
    extra = {}
    with torch.no_grad():
        if config.ray_sort:
            extra["lo"], extra["hi"] = scene.aabb()
        if config.intersector == "traverse":
            a, b, c = scene.triangle_vertices()
            perm = morton_order(a, b, c, scene.tri_valid)
            extra["clo"], extra["chi"] = chunk_aabbs_padded(
                a, b, c, scene.tri_valid, perm, TW.CHUNK)
            extra["perm"] = perm
    if config.intersector == "traverse":
        rows = rows[extra["perm"]]
    return SceneTables(rows=rows, **extra)


def segment_step(tables: SceneTables, config: TraceConfig, pos, dir_, tput, res,
                 live, u1, u2, urr, flags):
    """One path segment of every lane: (new_pos, new_dir, new_tput,
    new_res f32[3, R], still f32[R]). ``flags`` is f32[3, 1] or, for the
    regenerating wavefront, f32[3, R]. Differentiable when autograd is on
    (scalar flags only)."""
    kw = config.kernel_options()
    grad = torch.is_grad_enabled()
    if config.intersector == "traverse":
        idx = TW.traverse_select(tables.rows.detach(), tables.clo, tables.chi,
                                 pos.detach(), dir_.detach(), live)
        segment = F.whole_segment_rows if grad else F.rows_segment
        return segment(tables.rows, idx, pos, dir_, tput, res, live, u1, u2, urr,
                       flags, **kw)
    segment = F.whole_segment_megakernel if grad else F.mega_segment
    return segment(tables.rows, pos, dir_, tput, res, live, u1, u2, urr, flags, **kw)[1:]


def trace_radiance_soa(
    scene: ScenePack,
    pos3: torch.Tensor,  # f32[3, R]
    dir3: torch.Tensor,  # f32[3, R] unit
    key: Key,
    config: TraceConfig,
    tables: Optional[SceneTables] = None,
) -> torch.Tensor:
    """Estimate radiance along R rays. Returns f32[3, R].

    ``tables`` is :func:`scene_tables` of ``scene``; pass it to reuse it
    across calls."""
    dev = pos3.device
    R = pos3.shape[1]
    if tables is None:
        tables = scene_tables(scene, config)
    if config.ray_sort and R >= 2**24:
        # Ray ids ride the sort's gather as f32, exact below 2^24.
        raise ValueError(f"ray_sort supports wavefronts < 2^24 rays, got {R}; "
                         "tile the frame with TraceConfig.ray_chunk")
    flags = config.segment_flags(dev)
    pos = pos3.contiguous()
    dir_ = dir3.contiguous()
    tput = torch.ones(3, R, device=dev)
    result = torch.zeros(3, R, device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    rid = torch.arange(R, device=dev)
    urr = torch.zeros(R, device=dev)

    def draw(sid):
        u = stream_uniform(key, sid, R, dev)
        return u[rid] if config.ray_sort else u

    for seg in range(config.num_segments):
        if config.ray_sort:
            keys = torch.where(active, ray_sort_keys(pos, dir_, tables.lo, tables.hi),
                               DEAD_KEY)
            order = torch.argsort(keys, stable=True)
            # One gather of the 14 state rows; the ray id rides as f32.
            state = torch.cat([pos, dir_, tput, result, active[None].float(),
                               rid[None].float()])[:, order]
            pos, dir_, tput, result = state[0:3], state[3:6], state[6:9], state[9:12]
            active, rid = state[12] > 0.0, state[13].long()
        u1 = draw(seg * 4 + 0)
        u2 = draw(seg * 4 + 1)
        if config.mode == "rr":
            urr = draw(seg * 4 + 3)
        pos, dir_, tput, result, still = segment_step(
            tables, config, pos, dir_, tput, result, active, u1, u2, urr, flags[seg])
        active = still > 0.0
    if config.ray_sort:  # back to the rays' own order
        result = torch.zeros_like(result).index_copy(1, rid, result)
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
    tables: Optional[SceneTables] = None,
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
    if tables is None:
        tables = scene_tables(scene, config)

    rc = config.ray_chunk
    if rc <= 0 or rc >= R:
        radiance = trace_radiance_soa(scene, pos3, dir3, key, config, tables)
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
                fold_in(key, (1 << 29) + i), config, tables,
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
    tables: Optional[SceneTables] = None,
) -> torch.Tensor:
    """One sample per pixel over the full frame. Returns f32[H, W, 3]."""
    return render_rows_planar(
        scene, camera, key, width, height, 0, height, config, tables
    ).permute(1, 2, 0)
