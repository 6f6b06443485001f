"""Wavefront path-tracing integrator (SoA layout).

The counterpart of ``montecarlopathtracer_tpu/render/integrator.py``.
All R rays advance one path segment per step; terminated lanes are
masked; the steps are a Python loop. Intersectors
(``TraceConfig.intersector``):

- ``"megakernel"``: each step is ONE call of
  :func:`..ops.segment_fused.mega_segment` (kernel B1: brute nearest hit
  and the whole segment; a launch for CUDA tensors). With ``chunk_cull``
  the triangle table is in Morton order and the kernel skips the
  128-triangle chunks that no ray of a block can reach (B1c);
- ``"traverse"``, for large scenes: the triangle table is in Morton
  order, and each step is :func:`..ops.traverse_walk.traverse_select`
  (kernel B5: a per-tile walk over reachable chunks, front to back, with
  early exit) followed by :func:`..ops.segment_fused.rows_segment`
  (kernel B6: the segment from the known winners);
- ``"brute"``: :func:`..ops.intersect.intersect_brute`, plain torch on
  any device (the JAX package's lax oracle), on the split path;
- ``"fused"``: :func:`..ops.nearest_shade.intersect_fused` (kernel B7's
  nearest index, then a differentiable recompute of the hit), on the
  split path;
- ``"kdtree"``: :func:`..ops.traverse.intersect_kdtree` (the stackless
  walk of a KD tree in torch ops; no hand-written kernel), then the same
  differentiable recompute, on the split path. The tree is built once
  per scene on the host (:func:`..accel.kdtree.build_flat_kdtree`, the
  native C++ build when its library builds) or passed in as ``accel``. The JAX
  package refuses this intersector on the TPU, whose runtime it faulted;
  here it runs on the card like the others.

The split path (``whole_segment=False``, and always for ``"brute"``,
``"fused"`` and ``"kdtree"``) runs each segment as an intersector call,
which returns the winner's distance, barycentrics, hit point, corner
normals and material (:func:`make_intersect_shade`; kernel B4, or B4c
with ``chunk_cull``, for ``"megakernel"``; B5 and a differentiable
recompute for ``"traverse"``), followed by the segment body in torch ops
(:func:`split_segment`). It
computes what the whole segment computes, with the JAX package's split
body: its Russian roulette takes ``tput.amax`` (whose adjoint splits a
three-way tie in thirds), where the whole segment nests pairwise maxima.

The scene-side tables (the row table, for ``"traverse"`` and
``chunk_cull`` the Morton permutation and the chunk boxes, for
``"brute"``, ``"fused"`` and ``"kdtree"`` the triangle transforms, for
``"kdtree"`` the tree) are built once per scene and device by
:func:`scene_tables`; pass them to reuse them across calls.

``ray_sort`` (``"megakernel"`` and ``"traverse"`` only, as in the JAX
package): each step first sorts the wavefront by
:func:`..ops.morton.ray_sort_keys` (origin Morton code and direction
octant; lanes that are not live last), so that a tile of the walk holds
coherent rays and dead tiles are skipped at once. Rays carry their
original id and draw their own random streams, so the estimator is
bit-identical to the unsorted trace.

Gradients: when autograd is on (``torch.is_grad_enabled()``), a whole
segment runs through :func:`..ops.segment_fused.whole_segment_megakernel`
or :func:`..ops.segment_fused.whole_segment_rows` instead, whose backward
is the segment vjp kernel and the row scatter (detached sampling with
path replay, as in the JAX package's ``diff/grad.py``); the split path
is differentiable through :class:`..ops.nearest_shade.NearestShadeFull`
(a row gather and the row scatter), :func:`..ops.nearest_shade.refine_hit`
and plain autograd. The backward keeps only each segment's inputs and
winner index and recomputes the rest from them, so the JAX package's
``remat_segments`` policies have nothing further to save here. Under
``torch.no_grad()`` (the :class:`Renderer`) no graph is built.

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
import functools
from typing import Optional

import torch

from ..ops import nearest_shade as NS
from ..ops import segment_fused as F
from ..ops import traverse_walk as TW
from ..ops.intersect import intersect_brute, triangle_transforms
from ..ops.morton import DEAD_KEY, chunk_aabbs_padded, morton_order, ray_sort_keys
from ..ops.rng import Key, fold_in, stream_uniform
from ..ops.sampling import (
    dot3,
    normalize3,
    sample_fresnel,
    sample_hemi,
    sample_phong,
    sample_phong_reflect,
)
from ..ops.traverse import KDArrays, intersect_kdtree
from ..scene.camera import Camera
from ..scene.scene import ScenePack

INTERSECTORS = ("megakernel", "traverse", "brute", "fused", "kdtree")
WHOLE_SEGMENT = ("megakernel", "traverse")  # the intersectors with a whole-segment kernel


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
    intersector: str = "megakernel"  # "megakernel" | "traverse" | "brute" | "fused" | "kdtree"
    whole_segment: bool = True  # one kernel per segment ("megakernel", "traverse");
    # False runs the split path (intersector call + segment body in torch ops)
    ray_sort: bool = False  # sort the wavefront each segment ("megakernel", "traverse")
    chunk_cull: bool = False  # "megakernel": Morton order, skip unreachable chunks
    ray_chunk: int = 0  # rays per wavefront tile; 0 = whole frame

    def __post_init__(self):
        if self.intersector not in INTERSECTORS:
            raise ValueError(f"unknown intersector {self.intersector!r}")
        if self.chunk_cull and self.intersector != "megakernel":
            raise ValueError(
                "chunk_cull applies to intersector='megakernel' only "
                f"(got {self.intersector!r}; 'traverse' culls by itself)"
            )
        if self.mode not in ("fixed", "rr"):
            raise ValueError(f"unknown mode {self.mode!r}")

    @property
    def num_segments(self) -> int:
        """Intersections per path."""
        if self.mode == "fixed":
            return self.max_depth + 1  # + final emission gather
        return 3 * self.rr_depth + 1  # hard kill boundary

    @property
    def use_whole(self) -> bool:
        """Each segment is one whole-segment kernel (else the split path)."""
        return self.whole_segment and self.intersector in WHOLE_SEGMENT

    @property
    def use_sort(self) -> bool:
        return self.ray_sort and self.intersector in WHOLE_SEGMENT

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
    """What the intersectors read of a scene, on its device."""

    rows: Optional[torch.Tensor] = None  # f32[T, 48] pack_rows_full; Morton order
    # for "traverse" and chunk_cull; None for "brute" and "fused"
    perm: Optional[torch.Tensor] = None  # i64[T] the Morton order
    clo: Optional[torch.Tensor] = None  # f32[nc, 3] chunk boxes
    chi: Optional[torch.Tensor] = None
    lo: Optional[torch.Tensor] = None  # f32[3] scene box (ray_sort)
    hi: Optional[torch.Tensor] = None
    m: Optional[torch.Tensor] = None  # f32[T, 3, 3] transforms ("brute", "fused", "kdtree")
    m_a: Optional[torch.Tensor] = None  # f32[T, 3]
    geom: Optional[torch.Tensor] = None  # f32[T, 12] B7's table ("fused")
    kd: Optional[KDArrays] = None  # the KD tree ("kdtree")

    @property
    def cull_boxes(self) -> dict:
        """The chunk boxes as the culling kernels' keyword arguments."""
        return dict(clo=self.clo, chi=self.chi)


def kd_tree(scene: ScenePack) -> KDArrays:
    """The KD tree of the scene's valid triangles, built on the host
    (:func:`..accel.kdtree.build_flat_kdtree`: the native C++ build when its
    library builds) and put on the scene's device."""
    from ..accel.kdtree import build_flat_kdtree

    a, b, c = (x.detach().cpu().numpy() for x in scene.triangle_vertices())
    flat = build_flat_kdtree(a, b, c, scene.tri_valid.cpu().numpy())
    return KDArrays.from_flat(flat, scene.vertices.device)


def scene_tables(scene: ScenePack, config: TraceConfig,
                 accel: Optional[KDArrays] = None) -> SceneTables:
    """Build the scene's :class:`SceneTables` for ``config``. The row
    table and the transforms carry gradients to the scene's fields; the
    permutation, the boxes, B7's table and the KD tree, which only choose
    which triangles win, do not. ``accel`` is a prebuilt KD tree for
    ``"kdtree"`` (JAX's ``accel`` argument); without it the tree is
    built here (:func:`kd_tree`)."""
    extra = {}
    with torch.no_grad():
        if config.use_sort:
            extra["lo"], extra["hi"] = scene.aabb()
        if config.intersector == "traverse" or config.chunk_cull:
            a, b, c = scene.triangle_vertices()
            perm = morton_order(a, b, c, scene.tri_valid)
            extra["clo"], extra["chi"] = chunk_aabbs_padded(
                a, b, c, scene.tri_valid, perm, TW.CHUNK)
            extra["perm"] = perm
    if config.intersector in ("brute", "fused", "kdtree"):
        m, m_a = triangle_transforms(*scene.triangle_vertices())
        if config.intersector == "fused":
            extra["geom"] = NS.pack_geom_rows(m.detach(), m_a.detach(), scene.tri_valid)
        if config.intersector == "kdtree":
            extra["kd"] = kd_tree(scene) if accel is None else accel
        return SceneTables(m=m, m_a=m_a, **extra)
    rows = F.pack_rows_full(scene)
    if "perm" in extra:
        rows = rows[extra["perm"]]
    return SceneTables(rows=rows, **extra)


def segment_step(tables: SceneTables, config: TraceConfig, pos, dir_, tput, res,
                 live, u1, u2, urr, flags):
    """One whole path segment of every lane (``"megakernel"`` or
    ``"traverse"``): (new_pos, new_dir, new_tput, new_res f32[3, R], still
    f32[R]). ``flags`` is f32[3, 1] or, for the regenerating wavefront,
    f32[3, R]. Differentiable when autograd is on (scalar flags only)."""
    kw = config.kernel_options()
    grad = torch.is_grad_enabled()
    if config.intersector == "traverse":
        idx = TW.traverse_select(tables.rows.detach(), tables.clo, tables.chi,
                                 pos.detach(), dir_.detach(), live)
        segment = F.whole_segment_rows if grad else F.rows_segment
        return segment(tables.rows, idx, pos, dir_, tput, res, live, u1, u2, urr,
                       flags, **kw)
    if config.chunk_cull:
        kw.update(tables.cull_boxes)
    segment = F.whole_segment_megakernel if grad else F.mega_segment
    return segment(tables.rows, pos, dir_, tput, res, live, u1, u2, urr, flags, **kw)[1:]


_YHAT = (0.0, 1.0, 0.0)


def make_intersect_shade(scene: ScenePack, config: TraceConfig,
                         tables: Optional[SceneTables] = None):
    """The split path's intersector (JAX ``_make_intersect_shade``):
    ``intersect_shade(pos3, dir3, live=None)`` returns a dict of [R]
    ``miss, t, beta, gamma, ns, tr, ni`` and [3, R] ``point, n0, n1, n2,
    ka, kd, ks``, differentiable in the scene's tables and the rays.

    ``"megakernel"`` runs B4 (B4c with ``chunk_cull``), ``"traverse"`` B5
    and :func:`..ops.nearest_shade.recompute_winner`; a miss there has
    t = 3e38, the normals +Y and Ni = 1 (zero normals would make the
    Fresnel sampler's square roots 0·∞ = NaN under autograd).
    ``"brute"``, ``"fused"`` and ``"kdtree"`` gather the material and
    corner normals of the winner (of triangle 0 for a miss, whose t is
    inf and whose point is the origin); ``"kdtree"`` recomputes the hit
    of the walk's winner with :func:`..ops.nearest_shade.refine_hit`."""
    if tables is None:
        tables = scene_tables(scene, config)

    if config.intersector in WHOLE_SEGMENT:
        cull = tables.cull_boxes if config.chunk_cull else {}

        def intersect_shade(pos3, dir3, live=None):
            if live is None:
                live = torch.ones(pos3.shape[1], dtype=torch.bool, device=pos3.device)
            if config.intersector == "traverse":
                idx = TW.traverse_select(tables.rows.detach(), tables.clo, tables.chi,
                                         pos3.detach(), dir3.detach(), live)
                tbg, shade = NS.recompute_winner(tables.rows, idx, pos3, dir3)
            else:
                _, tbg, shade = NS.nearest_shade_full_diff(tables.rows, pos3, dir3, live,
                                                           **cull)
            hitf = tbg[3]
            hit = hitf > 0.0
            yhat = torch.tensor(_YHAT, device=pos3.device)[:, None]
            return dict(
                miss=~hit, t=tbg[0], beta=tbg[1], gamma=tbg[2],
                point=pos3 + (tbg[0] * hitf)[None, :] * dir3,
                n0=torch.where(hit[None, :], shade[0:3], yhat),
                n1=torch.where(hit[None, :], shade[3:6], yhat),
                n2=torch.where(hit[None, :], shade[6:9], yhat),
                ka=shade[9:12], kd=shade[12:15], ks=shade[15:18],
                ns=shade[18], tr=shade[19], ni=torch.where(hit, shade[20], 1.0),
            )

        return intersect_shade

    def intersect_shade(pos3, dir3, live=None):
        # The brute, fused and kdtree intersectors gain nothing from the mask.
        if config.intersector == "brute":
            hit = intersect_brute(tables.m, tables.m_a, scene.tri_valid, pos3.T, dir3.T)
        elif config.intersector == "kdtree":
            tri_id = intersect_kdtree(tables.kd, tables.m.detach(), tables.m_a.detach(),
                                      scene.tri_valid, pos3.detach().T, dir3.detach().T).tri_id
            hit = NS.refine_hit(tables.m, tables.m_a, pos3.T, dir3.T, tri_id)
        else:
            hit = NS.intersect_fused(tables.m, tables.m_a, scene.tri_valid, pos3.T, dir3.T,
                                     geom=tables.geom)
        tid = hit.tri_id.clamp_min(0).long()
        mid = scene.tri_mat.long()[tid]
        tn = scene.tri_n.long()[tid]
        return dict(
            miss=hit.tri_id < 0, t=hit.t, beta=hit.beta, gamma=hit.gamma,
            point=hit.point.T,
            n0=scene.normals[tn[:, 0]].T, n1=scene.normals[tn[:, 1]].T,
            n2=scene.normals[tn[:, 2]].T,
            ka=scene.mat_ka[mid].T, kd=scene.mat_kd[mid].T, ks=scene.mat_ks[mid].T,
            ns=scene.mat_ns[mid], tr=scene.mat_tr[mid], ni=scene.mat_ni[mid],
        )

    return intersect_shade


def interp_normal(n0, n1, n2, beta, gamma) -> torch.Tensor:
    """Smooth normal from corner normals [3, R]: barycentric
    interpolation, then a safe normalize (JAX ``_interp_normal``)."""
    w0 = (1.0 - beta - gamma)[None, :]
    return normalize3(n0 * w0 + n1 * beta[None, :] + n2 * gamma[None, :])


def split_segment(intersect_shade, config: TraceConfig, pos, dir_, tput, res, live,
                  u1, u2, urr, flags):
    """One path segment on the split path (JAX ``trace_radiance_soa``'s
    split body): ``intersect_shade``, then emission or final gather,
    Russian roulette, the three samplers, the two-sided diffuse flip, the
    albedo and the state update in torch ops. ``flags`` is f32[3, 1].
    Returns (new_pos, new_dir, new_tput, new_res f32[3, R], still f32[R]).

    Russian roulette takes p = ``tput.amax(dim=0)`` as the JAX split body
    does (a three-way tie splits the adjoint in thirds). Its compensation
    divides only where it is selected, so a lane of zero throughput gets a
    zero gradient where JAX's ``tput / max(p, 1e-20)`` gets 0/0 (ROADMAP
    C7)."""
    s = intersect_shade(pos, dir_, live)
    miss = s["miss"]
    is_emit = (s["ka"] > 0.0).any(dim=0)
    fg, do_rr, hard_kill = flags[0] > 0.0, flags[1] > 0.0, flags[2] > 0.0
    if config.mode == "rr":
        p = tput.amax(dim=0)
        survive = p > urr
        comp = do_rr & survive
        tput = torch.where(comp[None, :],
                           tput / torch.where(comp, p.clamp_min(1e-20), 1.0)[None, :], tput)
        dead_now = miss | (do_rr & ~survive) | hard_kill
    else:
        dead_now = miss

    emit_now = live & ~dead_now & (is_emit | fg)
    res = torch.where(emit_now[None, :], tput * s["ka"] * config.illum, res)
    still = live & ~dead_now & ~emit_now

    normal = interp_normal(s["n0"], s["n1"], s["n2"], s["beta"], s["gamma"])
    d_fresnel = sample_fresnel(u1, normal, dir_, s["tr"], s["ni"])
    phong_fn = sample_phong_reflect if config.phong_model == "phong" else sample_phong
    d_phong = phong_fn(u1, u2, normal, dir_, s["ns"])
    d_hemi = sample_hemi(u1, u2, normal)
    flip = dot3(dir_, normal) > 0.0  # two-sided diffuse
    d_diff = torch.where(flip[None, :], -d_hemi, d_hemi)

    is_fresnel = (s["tr"] > 0.0)[None, :]
    is_phong = ~is_fresnel & (s["ns"] > 1.0)[None, :]
    new_dir = torch.where(is_fresnel, d_fresnel, torch.where(is_phong, d_phong, d_diff))
    albedo_fresnel = s["kd"] if config.refract_kd else torch.ones_like(s["kd"])
    albedo = torch.where(is_fresnel, albedo_fresnel,
                         torch.where(is_phong, s["ks"], s["kd"]))
    still3 = still[None, :]
    new_tput = torch.where(still3, tput * albedo, tput)
    new_pos = torch.where(still3, s["point"] + new_dir * config.eps_offset, pos)
    new_dir = torch.where(still3, new_dir, dir_)
    return new_pos, new_dir, new_tput, res, still.to(torch.float32)


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
    if config.use_whole:
        step = functools.partial(segment_step, tables, config)
    else:
        step = functools.partial(split_segment, make_intersect_shade(scene, config, tables),
                                 config)
    sort = config.use_sort
    if sort and R >= 2**24:
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
        return u[rid] if sort else u

    for seg in range(config.num_segments):
        if sort:
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
        pos, dir_, tput, result, still = step(pos, dir_, tput, result, active, u1, u2, urr,
                                              flags[seg])
        active = still > 0.0
    if sort:  # back to the rays' own order
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
