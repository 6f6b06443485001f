"""Band-sharded rendering, training, regen and the geometry step over a
(rays × spp) mesh of ranks (:mod:`.mesh`).

The counterpart of ``montecarlopathtracer_tpu/parallel/sharded.py``.
There one SPMD program (``shard_map``) runs over a mesh of devices; here
each rank is a process running the same code on its own device, and each
function below returns the rank's local function. The decomposition is JAX's:

- rank (ri, si) renders rows ``[ri·H/n_rays, (ri+1)·H/n_rays)`` for
  ``spp/n_spp`` samples, sample ``s`` under ``fold_in(dev_key, s)`` with
  ``dev_key = fold_in(key, ri·65536 + si)``, through
  :func:`..render.integrator.render_rows`;
- the band's total is summed over the spp group and divided by ``spp``:
  the forward pass's one collective;
- the film stays banded over rays: each rank holds its band
  (:func:`film_band`), and :func:`gather_film` assembles the frame for a
  PNG or a check, as reading a ``P("rays")`` array whole does in JAX.

Collectives are all-reduces only (``torch.distributed.all_reduce``,
through :meth:`.mesh.Mesh.psum`): gloo takes them on CUDA tensors, so two
ranks may share one card with ``backend="gloo"``, which NCCL refuses.
The frame is assembled by an all-reduce over the rays group of a zero
frame holding this rank's band, which is exact: adding zeros changes no
bit.

Gradients (:func:`make_train_step`) equal ``jax.grad`` through
``shard_map``: each rank backpropagates its own band's cotangent
``2 (band − target) / (H·W·3)`` through its own samples (the spp sum
passes the cotangent through unchanged, and the band's division by
``spp`` scales it by ``1/spp``), and the parameter gradients are then
summed over all ranks with one all-reduce after ``backward()``. The
differentiable collectives of ``torch.distributed.nn`` are not used:
their backward sums the cotangents of every rank, which multiplies a
replicated loss's gradient by the number of ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..diff.boundary import boundary_grad_translation, translation_support
from ..diff.grad import merge_params
from ..ops.rng import Key, fold_in
from ..render.film import Film, film_update
from ..render.integrator import TraceConfig, render_rows, scene_tables
from ..render.regen import render_regen_planar
from ..scene.camera import Camera
from ..scene.scene import ScenePack
from .mesh import ALL_AXES, RAYS_AXIS, SPP_AXIS, Mesh

RANK_KEY_STRIDE = 65536  # dev_key = fold_in(key, ri * 65536 + si), as in JAX
PROBE_KEY_BASE = 7777  # the geometry step's probes: fold_in(key, 7777 + ri * 65536 + si)


def _split(mesh: Mesh, height: int, spp: int) -> Tuple[int, int]:
    """(rows, samples) of each rank; raises unless both divide."""
    if height % mesh.n_rays:
        raise ValueError(f"height {height} not divisible by rays shards {mesh.n_rays}")
    if spp % mesh.n_spp:
        raise ValueError(f"spp {spp} not divisible by spp shards {mesh.n_spp}")
    return height // mesh.n_rays, spp // mesh.n_spp


def rank_key(mesh: Mesh, key: Key) -> Key:
    """This rank's key, ``fold_in(key, ri·65536 + si)``."""
    return fold_in(key, mesh.ri * RANK_KEY_STRIDE + mesh.si)


def film_band(mesh: Mesh, height: int) -> Tuple[int, int]:
    """``(y0, n_rows)``: the image rows this rank's film holds."""
    if height % mesh.n_rays:
        raise ValueError(f"height {height} not divisible by rays shards {mesh.n_rays}")
    rows = height // mesh.n_rays
    return mesh.ri * rows, rows


@torch.no_grad()
def gather_film(mesh: Mesh, band: torch.Tensor) -> torch.Tensor:
    """The whole frame f32[H, W, 3] from every rank's band f32[H/n_rays,
    W, 3], on every rank: an all-reduce over the rays group of a zero
    frame holding this rank's band at its rows (exact)."""
    if mesh.n_rays == 1:
        return band
    rows = band.shape[0]
    frame = torch.zeros((rows * mesh.n_rays, *band.shape[1:]), dtype=band.dtype,
                        device=band.device)
    frame[mesh.ri * rows:(mesh.ri + 1) * rows] = band
    return mesh.psum(frame, RAYS_AXIS)


def sharded_sample_pass(mesh: Mesh, *, width: int, height: int, spp: int,
                        config: TraceConfig):
    """This rank's pass: ``sample_pass(scene, camera, key)`` returns its
    band f32[H/n_rays, W, 3] of the mean image of ``spp`` samples, the
    same on every rank of its spp group. The scene tables are built once
    a call and serve every sample; under autograd the band is
    differentiable in the scene's fields.

    Requires ``height % n_rays == 0`` and ``spp % n_spp == 0``."""
    rows, spp_local = _split(mesh, height, spp)
    y0 = mesh.ri * rows

    def sample_pass(scene: ScenePack, camera: Camera, key: Key) -> torch.Tensor:
        tables = scene_tables(scene, config)
        dev_key = rank_key(mesh, key)
        total = torch.zeros(rows, width, 3, device=camera.device)
        for s in range(spp_local):
            total = total + render_rows(scene, camera, fold_in(dev_key, s), width, height,
                                        y0, rows, config, tables)
        return mesh.psum(total, SPP_AXIS) / spp

    return sample_pass


def sharded_regen_pass(mesh: Mesh, *, width: int, height: int, spp: int,
                       config: TraceConfig):
    """This rank's regenerating-wavefront pass (:mod:`..render.regen`):
    ``regen_pass(scene, camera, key)`` drains its band's quota of
    ``spp/n_spp`` samples per pixel with one wavefront of the band's
    pixels, under this rank's key, and returns its band f32[H/n_rays, W,
    3] of the mean of ``spp`` samples. The only collective is the spp
    group's sum. Inference only."""
    rows, spp_local = _split(mesh, height, spp)

    @torch.no_grad()
    def regen_pass(scene: ScenePack, camera: Camera, key: Key) -> torch.Tensor:
        img = render_regen_planar(scene, camera, rank_key(mesh, key), width, height,
                                  spp_local, config, y0=mesh.ri * rows, n_rows=rows)
        return (mesh.psum(img * spp_local, SPP_AXIS) / spp).permute(1, 2, 0)

    return regen_pass


def make_progressive_step(mesh: Mesh, *, width: int, height: int, spp: int,
                          config: TraceConfig):
    """``step(scene, camera, film, key) -> film``: one sharded pass of
    ``spp`` samples folded into this rank's film, which holds its band
    (``Film.zeros(n_rows, W)``, :func:`film_band`) with
    :func:`..render.film.film_update`. The weight is the whole frame's;
    the Welford moment ``m2`` is the band's own."""
    sample_pass = sharded_sample_pass(mesh, width=width, height=height, spp=spp,
                                      config=config)

    @torch.no_grad()
    def step(scene: ScenePack, camera: Camera, film: Film, key: Key) -> Film:
        return film_update(film, sample_pass(scene, camera, key), float(spp))

    return step


def _band_sq(band: torch.Tensor, target: torch.Tensor, y0: int) -> torch.Tensor:
    """Σ (band − target's rows of the band)² (a scalar)."""
    return ((band - target[y0:y0 + band.shape[0]]) ** 2).sum()


def make_train_step(
    mesh: Mesh,
    scene: ScenePack,
    camera: Camera,
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
    lr: float = 0.5,
):
    """Sharded inverse-rendering step: ``step(params, target, key) ->
    (new_params, loss)``, the same on every rank.

    ``params`` is a dict of scene fields (:func:`..diff.grad.split_params`);
    ``target`` the whole frame f32[H, W, 3]. The loss is the frame's
    ``mean((img − target)²)``: the rays group's sum of the bands' squared
    residuals over ``H·W·3``. Each rank backpropagates its band's term,
    the parameter gradients are summed over all ranks, and the step is
    SGD projected to ``[0, ∞)``, as :func:`..diff.grad.make_sgd_step`."""
    sample_pass = sharded_sample_pass(mesh, width=width, height=height, spp=spp,
                                      config=config)
    y0, _ = film_band(mesh, height)
    n = height * width * 3

    def step(params: Dict[str, torch.Tensor], target: torch.Tensor, key: Key):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        sq = _band_sq(sample_pass(merge_params(scene, p), camera, key), target, y0)
        (sq / n).backward()
        grads = [torch.zeros_like(v) if v.grad is None else v.grad for v in p.values()]
        flat = mesh.psum(torch.cat([g.reshape(-1) for g in grads]), ALL_AXES)
        loss = mesh.psum(sq.detach(), RAYS_AXIS) / n
        new, off = {}, 0
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                gk = flat[off:off + g.numel()].view_as(g)
                off += g.numel()
                new[k] = torch.clamp_min(v - lr * gk, 0.0)
        return new, loss

    return step


def make_geom_train_step(
    mesh: Mesh,
    scene: ScenePack,
    camera: Camera,
    tri_mask,  # bool[T] triangles that translate with θ
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
    n_edge_samples: int = 2048,
    lr: float = 2.0,
):
    """Sharded geometry step (BASELINE config 5): recover a rigid
    translation θ ∈ R³ of the triangles ``tri_mask`` from a target image.
    ``step(theta, target, key) -> (theta', loss)``, the same on every
    rank.

    The interior vertex gradient is exactly zero for this material model
    (:mod:`..diff.grad`), so dLoss/dθ is the boundary term
    (:func:`..diff.boundary.boundary_grad_translation`). Each rank
    renders its band as :func:`sharded_sample_pass` does; the loss is the
    rays group's sum of the bands' squared residuals over ``H·W·3``; the
    bands are assembled into the frame (the probes' pixels lie anywhere
    in it) for the image gradient ``2 (img − target) / (H·W·3)``; each
    rank traces ``n_edge_samples / n_ranks`` edge samples under
    ``fold_in(key, 7777 + ri·65536 + si)``; the θ-gradient is the mean of
    the ranks' estimates (a sum over all ranks over their number)."""
    rows, _ = _split(mesh, height, spp)
    if n_edge_samples % mesh.size:
        raise ValueError(f"n_edge_samples {n_edge_samples} not divisible by {mesh.size}")
    n_local = n_edge_samples // mesh.size
    dev = camera.device
    vmask, edges = translation_support(scene, tri_mask, dev)
    sample_pass = sharded_sample_pass(mesh, width=width, height=height, spp=spp,
                                      config=config)
    y0 = mesh.ri * rows
    n = height * width * 3

    @torch.no_grad()
    def step(theta, target: torch.Tensor, key: Key):
        theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)
        s = dataclasses.replace(scene, vertices=scene.vertices + vmask * theta[None, :])
        band = sample_pass(s, camera, key)
        loss = mesh.psum(_band_sq(band, target, y0), RAYS_AXIS) / n
        image_grad = 2.0 * (gather_film(mesh, band) - target) / n
        probe_key = fold_in(key, PROBE_KEY_BASE + mesh.ri * RANK_KEY_STRIDE + mesh.si)
        g = boundary_grad_translation(s, camera, edges, image_grad, probe_key, width=width,
                                      height=height, config=config, n_samples=n_local)
        return theta - lr * (mesh.psum(g, ALL_AXES) / mesh.size), loss

    return step
