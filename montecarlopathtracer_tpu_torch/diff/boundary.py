"""Boundary (visibility and silhouette) gradients by edge sampling.

The counterpart of ``montecarlopathtracer_tpu/diff/boundary.py``, with
its estimators, stream ids and sample layout, so that with the same key
the port's estimate equals the JAX package's up to float rounding, given
the image gradient the pixel footprint makes of it (below).

With the reference's material model every geometric factor cancels
against its importance sampler, so path radiance is piecewise constant
in the vertex positions and the interior vertex gradient is exactly
zero (:mod:`.grad`). All geometry gradient lives in visibility
discontinuities, and these estimators sample them:

- :func:`boundary_grad_vertices` / :func:`boundary_grad_translation`:
  *primary* visibility. Points on the marked mesh's edges are sampled in
  proportion to their projected screen length; two probe rays through
  the screen point s ∓ ε·n̂ measure the radiance on either side of the
  edge; the difference, weighted by the loss's image gradient at the
  pixel and by the edge point's screen velocity along n̂, is the sample's
  contribution (Li et al. 2018's edge sampling, restricted to camera
  edges). Non-silhouette and occluded samples cancel (both probes see
  the same surface).
- :func:`shadow_boundary_grad_vertices` /
  :func:`shadow_boundary_grad_translation`: the one-bounce *shadow*
  term. A uniform screen point gives a receiver through the split path's
  intersector (:func:`..render.integrator.make_intersect_shade`); an
  edge point sampled by world length gives a direction ω from it; two
  probes along ω ∓ eps·n̂ trace the rest of the path.
- :func:`make_translation_problem`: ``step(theta, key) -> (loss,
  grad3)`` for recovering a rigid translation θ of a triangle subset
  from a target image (the reference's geometry optimisation).

A sample weighs the loss's image gradient over the pixels whose jittered
footprint holds its screen point (:func:`_footprint_grad`); the JAX
package reads one pixel there, which biases its estimate by ~40% at
800×600 (ROADMAP C8), and otherwise the two agree. Each sample's
contribution scatters into its edge's two end vertices with barycentric
weights (``index_add_``), so a translation's gradient is the row sum of
the per-vertex one. Probes trace with
:func:`..render.integrator.trace_radiance_soa` under the caller's
:class:`..render.integrator.TraceConfig`, on the device of the scene.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.rng import Key, fold_in, stream_uniform
from ..render.integrator import (
    TraceConfig,
    interp_normal,
    make_intersect_shade,
    render_sample_batch,
    scene_tables,
    trace_radiance_soa,
)
from ..scene.camera import Camera
from ..scene.scene import ScenePack

# Probe offsets: small enough that a probe stays inside the pixel (or
# near the edge's spherical image), large enough that the two probes
# straddle the edge despite rounding in the projection.
EPS_PX = 0.3  # primary: screen offset along the edge normal, in pixels
EPS_ANG = 1e-3  # shadow: angular offset along the edge image's normal


def unique_edges(tri_v, tri_mask) -> np.ndarray:
    """Unique undirected edges i32[E, 2] of the masked triangles. A closed
    mesh shares every edge between two faces; sampling it twice would
    double the silhouette term."""
    tv = np.asarray(tri_v)[np.asarray(tri_mask)]
    e = np.concatenate([tv[:, [0, 1]], tv[:, [1, 2]], tv[:, [2, 0]]], axis=0)
    return np.unique(np.sort(e, axis=1), axis=0).astype(np.int32)


def _project(camera: Camera, p: torch.Tensor, width: int, height: int):
    """World points [3, N] to continuous pixel coordinates (sx, sy) and
    the forward depth; the inverse of ``Camera.generate_rays_soa``'s
    pixel-to-direction map."""
    d = p - camera.eye[:, None]
    df = torch.sum(d * camera.forward[:, None], dim=0)
    safe = torch.where(df.abs() < 1e-8, 1.0, df)
    xc = torch.sum(d * camera.right[:, None], dim=0) / safe / camera.tan_half_x
    yc = torch.sum(d * camera.up[:, None], dim=0) / safe / camera.tan_half_y
    return (xc + 1.0) * 0.5 * width, (1.0 - yc) * 0.5 * height, df


def _footprint_grad(image_grad: torch.Tensor, camera: Camera, sx, sy) -> torch.Tensor:
    """f32[3, N]: the loss gradient that screen points (sx, sy) [N] carry,
    summed over the pixels whose footprint holds them. The camera samples
    pixel (x, y) uniformly over [x − j, x + j) × [y − j, y + j), j =
    ``camera.jitter`` (``Camera.generate_rays_soa``), so a point lies in
    the pixels x ∈ (sx − j, sx + j] (and likewise in y), each weighted by
    the footprint's density 1/(2j) per axis; pixels outside the frame
    count 0. The JAX package reads the one pixel floor(s) with weight 1,
    which is half a pixel off and ignores the footprint; next to an edge,
    where the image gradient jumps from pixel to pixel, that biases the
    estimate (ROADMAP C8)."""
    height, width = image_grad.shape[:2]
    j = float(camera.jitter)
    r = math.ceil(j)

    def axis(s, n):
        f = torch.floor(s).long()
        for k in range(-r, r + 1):
            x = f + k
            inside = (x > s - j) & (x <= s + j) & (x >= 0) & (x < n)
            yield x.clamp(0, n - 1), inside.to(s.dtype) / (2.0 * j)

    return sum(image_grad[y, x, :].T * (wx * wy)[None, :]
               for x, wx in axis(sx, width) for y, wy in axis(sy, height))


def _edge_pick(wgt: torch.Tensor, key: Key, ids, n: int):
    """Sample n edges ∝ ``wgt`` [E] and a parameter along each, from
    streams ``ids`` of ``key``: (cumulative total, eidx i64[n], u_along
    f32[n])."""
    dev = wgt.device
    total = torch.sum(wgt)
    cdf = torch.cumsum(wgt, dim=0) / torch.clamp_min(total, 1e-20)
    u_pick = stream_uniform(key, ids[0], n, dev)
    u_along = stream_uniform(key, ids[1], n, dev)
    eidx = torch.searchsorted(cdf, u_pick).clamp(0, wgt.shape[0] - 1)
    return total, eidx, u_along


def _scatter_to_vertices(edges, eidx, u_along, contrib, V) -> torch.Tensor:
    """f32[V, 3]: each sample's ``contrib`` [n, 3] added into its edge's
    end vertices with weights (1 − u, u)."""
    out = torch.zeros(V, 3, device=contrib.device)
    out.index_add_(0, edges[eidx, 0], contrib * (1.0 - u_along)[:, None])
    out.index_add_(0, edges[eidx, 1], contrib * u_along[:, None])
    return out


@torch.no_grad()
def boundary_grad_vertices(
    scene: ScenePack,
    camera: Camera,
    edges,  # i32[E, 2] vertex-index pairs (unique_edges)
    image_grad: torch.Tensor,  # f32[H, W, 3] = dLoss/dI
    key: Key,
    *,
    width: int,
    height: int,
    config: TraceConfig,
    n_samples: int = 4096,
) -> torch.Tensor:
    """Per-vertex primary boundary gradient dLoss/dvertices f32[V, 3].

    An edge sample at parameter u on edge (i0, i1) moves with world
    velocity (1 − u)·v̇_i0 + u·v̇_i1, so its screen-velocity term scatters
    into the two end vertices with those weights; vertices on no sampled
    edge get exactly 0. The probes sit ``EPS_PX`` pixels either side of
    the edge."""
    dev = camera.device
    edges = torch.as_tensor(edges, device=dev).long()
    V = scene.vertices.shape[0]
    v = scene.vertices.T  # [3, V]
    p0, p1 = v[:, edges[:, 0]], v[:, edges[:, 1]]  # [3, E]
    x0, y0, z0 = _project(camera, p0, width, height)
    x1, y1, z1 = _project(camera, p1, width, height)
    seg_len = torch.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2)
    vis = (z0 > 1e-6) & (z1 > 1e-6)
    total_len, eidx, u_along = _edge_pick(torch.where(vis, seg_len, 0.0), key, (11, 12),
                                          n_samples)

    sx0, sy0, sx1, sy1 = x0[eidx], y0[eidx], x1[eidx], y1[eidx]
    sx = sx0 + (sx1 - sx0) * u_along
    sy = sy0 + (sy1 - sy0) * u_along
    tx, ty = sx1 - sx0, sy1 - sy0
    tlen = torch.sqrt(tx * tx + ty * ty)
    safe_t = torch.clamp_min(tlen, 1e-12)
    nx, ny = -ty / safe_t, tx / safe_t

    zeros = torch.zeros(2 * n_samples, device=dev)
    xs = torch.cat([sx + EPS_PX * nx, sx - EPS_PX * nx])
    ys = torch.cat([sy + EPS_PX * ny, sy - EPS_PX * ny])
    pos3, dir3 = camera.generate_rays_soa(xs, ys, zeros, zeros, width, height)
    rad = trace_radiance_soa(scene, pos3.contiguous(), dir3.contiguous(), fold_in(key, 13),
                             config)
    l_plus, l_minus = rad[:, :n_samples], rad[:, n_samples:]

    scal = torch.sum(_footprint_grad(image_grad, camera, sx, sy) * (l_minus - l_plus), dim=0)
    scal = torch.where((tlen > 1e-9) & vis[eidx], scal, 0.0)

    # Screen velocity of the sample under a unit world displacement along
    # each axis: the forward-mode derivative of the projection, as JAX's
    # jvp (linear in the velocity, so the barycentric weights apply after).
    p3 = p0[:, eidx] + (p1[:, eidx] - p0[:, eidx]) * u_along[None, :]

    def proj_xy(q):
        a, b, _ = _project(camera, q, width, height)
        return torch.stack([a, b])

    per_axis = []
    for k in range(3):
        ek = torch.zeros(3, 1, device=dev)
        ek[k, 0] = 1.0
        _, dv = torch.func.jvp(proj_xy, (p3,), (ek.expand(p3.shape),))
        per_axis.append(scal * (dv[0] * nx + dv[1] * ny) * total_len / n_samples)
    return _scatter_to_vertices(edges, eidx, u_along, torch.stack(per_axis, dim=1), V)


def boundary_grad_translation(scene, camera, edges, image_grad, key, *, width, height,
                              config, n_samples=4096) -> torch.Tensor:
    """dLoss/dθ f32[3] for a unit translation θ of the edge mesh: the row
    sum of :func:`boundary_grad_vertices` (the estimator is linear in the
    velocity field, and a translation moves every vertex alike)."""
    return boundary_grad_vertices(
        scene, camera, edges, image_grad, key, width=width, height=height, config=config,
        n_samples=n_samples).sum(dim=0)


@torch.no_grad()
def shadow_boundary_grad_vertices(
    scene: ScenePack,
    camera: Camera,
    edges,  # i32[E, 2] vertex-index pairs (unique_edges)
    image_grad: torch.Tensor,  # f32[H, W, 3] = dLoss/dI
    key: Key,
    *,
    width: int,
    height: int,
    config: TraceConfig,
    n_samples: int = 4096,
) -> torch.Tensor:
    """Per-vertex secondary-edge (shadow) boundary gradient f32[V, 3]:
    the one-bounce visibility term that the primary estimator cannot see
    (the blocker may lie outside the frustum).

    dI_p/dθ_k = Σ_edges ∫ ρ(x, ω_e) (L⁻ − L⁺)(x, ω_e) (v_k·n̂)(ω_e)
    |dω_e/dl| dl, with ρ = albedo·cosθ/π at a diffuse receiver x, ω_e the
    direction to the edge point, n̂ the normal of the edge's spherical
    image and v_k·n̂ = n̂_k / dist for a unit translation. Receivers that
    are emitters, specular or transmissive get zero weight."""
    dev = camera.device
    edges = torch.as_tensor(edges, device=dev).long()
    n = n_samples
    V = scene.vertices.shape[0]
    v = scene.vertices.T
    p0, p1 = v[:, edges[:, 0]], v[:, edges[:, 1]]
    elen = torch.sqrt(torch.sum((p1 - p0) ** 2, dim=0))

    # Receiver: one primary hit per sample at a uniform screen point.
    xs = stream_uniform(key, 31, n, dev) * width
    ys = stream_uniform(key, 32, n, dev) * height
    zeros = torch.zeros(n, device=dev)
    cpos, cdir = camera.generate_rays_soa(xs, ys, zeros, zeros, width, height)
    cpos, cdir = cpos.contiguous(), cdir.contiguous()
    s = make_intersect_shade(scene, config, scene_tables(scene, config))(cpos, cdir)
    is_emit = (s["ka"] > 0.0).any(dim=0)
    receiver = ~s["miss"] & ~is_emit & ~(s["tr"] > 0.0) & ~(s["ns"] > 1.0)
    x = s["point"]
    normal = interp_normal(s["n0"], s["n1"], s["n2"], s["beta"], s["gamma"])
    flip = torch.sum(cdir * normal, dim=0) > 0.0  # two-sided diffuse
    n_eff = torch.where(flip[None, :], -normal, normal)

    # Edge point ∝ world length.
    total_len, eidx, u_along = _edge_pick(elen, key, (33, 34), n)
    q0, q1 = p0[:, eidx], p1[:, eidx]
    dvec = q0 + (q1 - q0) * u_along[None, :] - x
    dist = torch.sqrt(torch.sum(dvec * dvec, dim=0))
    safe_d = torch.clamp_min(dist, 1e-9)
    omega = dvec / safe_d[None, :]
    lvec = q1 - q0
    lhat = lvec / torch.clamp_min(torch.sqrt(torch.sum(lvec * lvec, dim=0)), 1e-12)[None, :]
    # Tangent of the edge's spherical image (per arc length) and its
    # in-sphere normal.
    tang = lhat - omega * torch.sum(omega * lhat, dim=0)[None, :]
    tlen = torch.sqrt(torch.sum(tang * tang, dim=0))
    nhat = torch.stack([
        omega[1] * tang[2] - omega[2] * tang[1],
        omega[2] * tang[0] - omega[0] * tang[2],
        omega[0] * tang[1] - omega[1] * tang[0],
    ]) / torch.clamp_min(tlen, 1e-12)[None, :]

    cosw = torch.sum(omega * n_eff, dim=0)
    rho = s["kd"] * (cosw / math.pi)[None, :]

    # Probe both sides of the edge image with the rest of the path (the
    # camera bounce used one scatter).
    cfg2 = dataclasses.replace(config, max_depth=max(config.max_depth - 1, 1))
    d_plus = omega + EPS_ANG * nhat
    d_plus = d_plus / torch.sqrt(torch.sum(d_plus * d_plus, dim=0))[None, :]
    d_minus = omega - EPS_ANG * nhat
    d_minus = d_minus / torch.sqrt(torch.sum(d_minus * d_minus, dim=0))[None, :]
    pos_p = torch.cat([x + d_plus * config.eps_offset, x + d_minus * config.eps_offset], dim=1)
    rad = trace_radiance_soa(scene, pos_p.contiguous(),
                             torch.cat([d_plus, d_minus], dim=1).contiguous(),
                             fold_in(key, 35), cfg2)
    delta_l = rad[:, n:] - rad[:, :n]  # L⁻ − L⁺

    scal = torch.sum(_footprint_grad(image_grad, camera, xs, ys) * rho * delta_l, dim=0)
    valid = receiver & (cosw > 0.0) & (dist > 1e-6) & (tlen > 1e-9)
    scal = torch.where(valid, scal, 0.0)

    # v_k·n̂ = n̂_k / dist; one factor of the sampling measure each for the
    # screen (W·H / n) and the edge length.
    norm_f = total_len * (width * height) / n
    contrib = (scal * (tlen / safe_d) / safe_d * norm_f)[:, None] * nhat.T
    return _scatter_to_vertices(edges, eidx, u_along, contrib, V)


def shadow_boundary_grad_translation(scene, camera, edges, image_grad, key, *, width,
                                     height, config, n_samples=4096) -> torch.Tensor:
    """dLoss/dθ f32[3] of the shadow boundary term for a rigid translation
    of the edge mesh: the row sum of :func:`shadow_boundary_grad_vertices`."""
    return shadow_boundary_grad_vertices(
        scene, camera, edges, image_grad, key, width=width, height=height, config=config,
        n_samples=n_samples).sum(dim=0)


def make_translation_problem(
    scene: ScenePack,
    camera: Camera,
    tri_mask,  # bool[T] triangles that translate with θ
    target: torch.Tensor,  # f32[H, W, 3]
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
    n_edge_samples: int = 4096,
):
    """Loss and gradient for recovering a rigid translation θ of the
    triangles ``tri_mask``: ``step(theta, key) -> (loss, grad3)`` renders
    ``spp`` samples (sample i under ``fold_in(key, i)``) with the masked
    triangles' vertices shifted by θ, takes the mean-squared pixel loss
    against ``target`` and estimates dLoss/dθ with
    :func:`boundary_grad_translation` under ``fold_in(key, 99)`` (the
    interior term is exactly zero for this material model). It runs on
    the device of ``scene`` and ``camera``; put them on the card to run
    there."""
    dev = camera.device
    tm = np.asarray(tri_mask)
    vids = np.unique(np.asarray(scene.tri_v.cpu())[tm].ravel())
    vmask = torch.zeros(scene.vertices.shape[0], 1, device=dev)
    vmask[torch.as_tensor(vids, device=dev).long()] = 1.0
    edges = unique_edges(scene.tri_v.cpu(), tm)
    target = target.to(dev)

    @torch.no_grad()
    def step(theta, key):
        theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)
        s = dataclasses.replace(scene, vertices=scene.vertices + vmask * theta[None, :])
        tables = scene_tables(s, config)
        total = torch.zeros(height, width, 3, device=dev)
        for i in range(spp):
            total += render_sample_batch(s, camera, fold_in(key, i), width, height, config,
                                         tables)
        img = total / spp
        loss = torch.mean((img - target) ** 2)
        image_grad = 2.0 * (img - target) / (height * width * 3)
        grad = boundary_grad_translation(s, camera, edges, image_grad, fold_in(key, 99),
                                         width=width, height=height, config=config,
                                         n_samples=n_edge_samples)
        return loss, grad

    return step
