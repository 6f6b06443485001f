"""Differentiable rendering: pixel-loss gradients with respect to scene
parameters.

The counterpart of ``montecarlopathtracer_tpu/diff/grad.py``, with the
same strategy, *detached sampling with path replay*:

- every sampling decision (directions, lobe and RR choices, the winning
  triangle) is a function of counter-based uniforms and carries no
  gradient;
- the radiance estimate is differentiable through the throughput
  products (× Kd / Ks / Ka), the emitter value (Ka × illum) and the hit
  geometry (t, β, γ through the per-triangle transforms to the vertex
  positions; shading normals through the normal buffer);
- a whole segment's backward is the segment vjp kernel and the row
  scatter (:func:`..ops.segment_fused.whole_segment_megakernel`, or
  :func:`..ops.segment_fused.whole_segment_rows` on the traversal path),
  which keep only the segment's inputs and winner index. On the split
  path (``whole_segment=False``, ``"brute"``, ``"fused"``) the
  intersector's backward is a row gather, elementwise autograd and the
  row scatter (:class:`..ops.nearest_shade.NearestShadeFull`), or plain
  autograd through :func:`..ops.nearest_shade.refine_hit` and the brute
  oracle, and the segment body is torch ops. With chunk culling or on
  the traversal path the row table is in Morton order, and its gradient
  flows back through the permutation to the scene's fields.

Parameters are a plain dict of :class:`ScenePack` fields
(``split_params``), overlaid on the scene with ``merge_params``, so only
the fields asked for take gradients: ``{"mat_kd", "mat_ka"}`` to recover
albedo and emitter radiance, ``{"vertices"}`` for geometry.

Known limitation (by the math, as in the JAX package): with the
reference's material model every geometric factor cancels against its
importance sampler, so path radiance is a product of albedos × Ka and
the vertex gradient is exactly zero in the interior. Nonzero geometry
gradients come from the boundary terms of :mod:`.boundary`.

Random streams: ``key`` is a :mod:`..ops.rng` key, and sample batch
``i`` renders under ``fold_in(key, i)`` as in the JAX package, so a
gradient here equals the JAX package's CPU gradient up to float
rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..ops.rng import Key, fold_in
from ..render.integrator import TraceConfig, render_sample_batch, scene_tables
from ..scene.camera import Camera
from ..scene.scene import ScenePack

PARAM_FIELDS = (
    "vertices",
    "normals",
    "mat_ka",
    "mat_kd",
    "mat_ks",
    "mat_ns",
    "mat_tr",
    "mat_ni",
)


def split_params(scene: ScenePack, fields: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """The optimizable fields as a flat dict (the scene's own tensors)."""
    for f in fields:
        if f not in PARAM_FIELDS:
            raise ValueError(f"not a differentiable field: {f}")
    return {f: getattr(scene, f) for f in fields}


def merge_params(scene: ScenePack, params: Dict[str, torch.Tensor]) -> ScenePack:
    """Overlay parameter values onto a scene pack."""
    return dataclasses.replace(scene, **params)


def render_image(
    params: Dict[str, torch.Tensor],
    scene: ScenePack,
    camera: Camera,
    key: Key,
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
) -> torch.Tensor:
    """Differentiable ``spp``-sample render f32[H, W, 3] as a function of
    ``params``: the mean of ``spp`` sample batches under
    ``fold_in(key, i)``."""
    s = merge_params(scene, params)
    tables = scene_tables(s, config)
    total = torch.zeros(height, width, 3, device=camera.device)
    for i in range(spp):
        total = total + render_sample_batch(s, camera, fold_in(key, i), width,
                                            height, config, tables)
    return total / spp


def make_loss_fn(
    scene: ScenePack,
    camera: Camera,
    target: torch.Tensor,
    *,
    width: int,
    height: int,
    spp: int,
    config: TraceConfig,
):
    """L2 pixel loss against ``target`` as a function of (params, key)."""

    def loss_fn(params, key):
        img = render_image(params, scene, camera, key, width=width,
                           height=height, spp=spp, config=config)
        return torch.mean((img - target) ** 2)

    return loss_fn


def value_and_grad(loss_fn, params: Dict[str, torch.Tensor], key: Key):
    """``(loss, grads)`` of ``loss_fn(params, key)``, the counterpart of
    ``jax.value_and_grad``: one ``loss.backward()`` on detached copies of
    the parameters."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(p, key)
    loss.backward()
    return loss.detach(), {
        k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in p.items()
    }


def make_sgd_step(loss_fn, lr: float = 0.5, param_min: float = 0.0):
    """One SGD step with projection to [param_min, ∞) (radiance and
    albedo parameters are nonnegative): ``step(params, key)`` returns
    ``(new_params, loss)``."""

    def step(params, key):
        loss, grads = value_and_grad(loss_fn, params, key)
        with torch.no_grad():
            new = {k: torch.clamp_min(params[k] - lr * grads[k], param_min)
                   for k in params}
        return new, loss

    return step
