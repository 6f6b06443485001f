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

Where the gradient's samples come from (:func:`make_loss_fn`'s
``seed_grad``, after Mitsuba's ``mi.render(..., seed_grad=...)``):

- ``"shared"`` (the default, the JAX package's): one taped render I
  gives the loss mean((I − T)²) and, through autograd, its gradient.
  Both come from the same samples, so the gradient's mean is that of
  the loss's mean, E[I²] included: it carries the gradient of the
  estimate's variance.
- ``"own"``: Mitsuba's decorrelated step. The primal I_a renders batch
  ``i`` under ``fold_in(key, i)`` (the samples of ``"shared"``) with no
  tape (``torch.no_grad()``, so the segment loop runs B1 without
  saving anything), under the span ``mcpt.grad.primal`` and
  :func:`..utils.profiling.primal` (its launches counted as B1p and
  RNGp too); the adjoint I_b renders batch ``i`` under
  ``fold_in(fold_in(key, GRAD_KEY), i)`` with a tape, at the same
  sample count (Mitsuba's default ``spp_grad = spp``). The loss is the
  surrogate ``mean((I_a − T)²) + (s − s.detach())`` with ``s =
  mean(2 (I_a − T) I_b)``, ``I_a`` held constant: its value is the
  primal's mean squared error, its gradient (2/N) Σ (I_a − T) ∂I_b/∂θ,
  whose mean is the gradient of (E[I] − T)², unbiased.

Steps: :func:`make_sgd_step` (projected SGD, as in the JAX package) and
:func:`make_adam_step` (projected Adam over chosen rows of each field,
with its moments on the parameters' device, as an inverse-rendering
job runs it: Mitsuba's ``Adam`` followed by a clip to the bounds). A
step enqueues its forward, ``backward()`` and update without waiting
for the card; it runs under the spans ``mcpt.grad.step`` (Adam's with
its index in the job), ``mcpt.grad.forward`` (render and loss),
``mcpt.grad.backward`` and ``mcpt.grad.update``, and counts itself in
``utils/profiling.py``'s records (``steps``). On a card both steps run
their loss as a pair of CUDA graphs (:func:`graphed_loss`): a step's
~1,000 launches cost the host more than the card takes to run them, and
a replay costs it two calls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.rng import DeviceKey, Key, fold_in
from ..render.integrator import TraceConfig, render_sample_batch, scene_tables
from ..scene.camera import Camera
from ..scene.scene import ScenePack
from ..utils import profiling
from ..utils.profiling import count_step, span

GRAPH_WARMUP = 3  # eager runs of a loss before its CUDA graphs are captured
GRAD_KEY = 0x80000000  # the adjoint's word, beyond any batch index: fold_in(key, GRAD_KEY)
SEED_GRAD = ("shared", "own")  # make_loss_fn's choices of the gradient's samples

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
    seed_grad: str = "shared",
):
    """L2 pixel loss against ``target`` as a function of (params, key),
    its gradient's samples chosen by ``seed_grad`` (one of
    :data:`SEED_GRAD`; the module docstring)."""
    if seed_grad not in SEED_GRAD:
        raise ValueError(f"seed_grad must be one of {SEED_GRAD}, got {seed_grad!r}")

    def render(params, key):
        return render_image(params, scene, camera, key, width=width, height=height, spp=spp,
                            config=config)

    def loss_fn(params, key):
        return torch.mean((render(params, key) - target) ** 2)

    def decorrelated(params, key):
        with span("grad.primal"), profiling.primal(), torch.no_grad():
            err = render(params, key) - target
        adjoint = render(params, fold_in(key, GRAD_KEY))
        s = torch.mean(2.0 * err * adjoint)
        return torch.mean(err ** 2) + (s - s.detach())

    return loss_fn if seed_grad == "shared" else decorrelated


def value_and_grad(loss_fn, params: Dict[str, torch.Tensor], key: Key):
    """``(loss, grads)`` of ``loss_fn(params, key)``, the counterpart of
    ``jax.value_and_grad``: one ``loss.backward()`` on detached copies of
    the parameters."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with span("grad.forward"):
        loss = loss_fn(p, key)
    with span("grad.backward"):
        loss.backward()
    return loss.detach(), {
        k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in p.items()
    }


def graphed_loss(loss_fn, params: Dict[str, torch.Tensor], key: Key):
    """``loss_fn`` on a card as ``torch.cuda.make_graphed_callables``'s
    pair of CUDA graphs (the forward, and its backward for ``backward()``),
    captured after :data:`GRAPH_WARMUP` eager runs on ``params`` (their
    names, shapes and devices fixed from then on) under ``key``. The
    graphs draw from a key on the card (:class:`..ops.rng.DeviceKey`), into
    which each call writes its own key without a sync. Returns
    ``(loss(params, key), launches)``: the graphed function, whose
    arguments are ``loss_fn``'s, and the kernel launches one replay of
    both graphs holds, ``{name: n}`` by :data:`..utils.profiling.KERNELS`'
    names."""
    names = sorted(params)
    base = torch.empty(2, dtype=torch.int32, device=params[names[0]].device)
    DeviceKey.stage(key, base)

    def flat(*args):
        *fields, words = args
        return loss_fn(dict(zip(names, fields)), DeviceKey(words))

    sample = tuple(params[k].detach().clone().requires_grad_(True) for k in names)
    before = profiling.launches()
    graphed = torch.cuda.make_graphed_callables(flat, sample + (base,),
                                                num_warmup_iters=GRAPH_WARMUP)
    runs = GRAPH_WARMUP + 1  # the eager runs and the captures, each forward and backward
    made = profiling.launches() - before
    launches = {k: n // runs for k, n in made.items() if n // runs}

    def loss(p, k: Key):
        DeviceKey.stage(k, base)
        return graphed(*(p[name] for name in names), base)

    return loss, launches


def _stepped(loss_fn):
    """``run(params, key)``: the loss a step takes the gradient of. On a
    card, :func:`graphed_loss`'s, built at the first step there (its
    names, shapes and device fixed then), each replay counted as the
    launches it holds; the loss and the gradient it gives are
    overwritten by the next step. Elsewhere ``loss_fn`` itself."""
    graphs = {}  # device -> (the graphed loss, the launches of a replay)

    def run(params, key):
        dev = next(iter(params.values())).device
        if dev.type != "cuda":
            return loss_fn
        if dev not in graphs:
            graphs[dev] = graphed_loss(loss_fn, params, key)
        fn, held = graphs[dev]
        profiling.count_replay(held)
        return fn

    return run


def make_sgd_step(loss_fn, lr: float = 0.5, param_min: float = 0.0):
    """One SGD step with projection to [param_min, ∞) (radiance and
    albedo parameters are nonnegative): ``step(params, key)`` returns
    ``(new_params, loss)``. The gradient is :func:`value_and_grad`'s of
    the step's loss (:func:`_stepped`: CUDA graphs on a card)."""
    run = _stepped(loss_fn)

    def step(params, key):
        count_step()
        with span("grad.step"):
            loss, grads = value_and_grad(run(params, key), params, key)
            with span("grad.update"), torch.no_grad():
                new = {k: torch.clamp_min(params[k] - lr * grads[k], param_min)
                       for k in params}
        return new, loss

    return step


@dataclasses.dataclass
class AdamState:
    """Adam's state over the chosen rows: the steps taken and each
    field's first and second moments, ``[len(rows), ...]`` on the
    parameters' device."""

    t: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def make_adam_step(loss_fn, *, lr: float, betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, bounds: Tuple[float, float] = (0.0, 1.0),
                   rows: Optional[Sequence[int]] = None):
    """One projected Adam step: ``step(params, key, state=None)`` returns
    ``(new_params, loss, new_state)``. The gradient is
    :func:`value_and_grad`'s of the step's loss (:func:`_stepped`: CUDA
    graphs on a card); only ``rows`` of each field move (every row when
    None), by ``torch.optim.Adam``'s update (no weight decay, no AMSGrad)
    followed by a clamp to ``bounds``; the other rows are returned
    unchanged. ``state`` None starts a fresh job (zero moments, no
    steps). Nothing waits for the card: the row index and the key's
    words are put on the device without a sync."""
    beta1, beta2 = betas
    lo, hi = bounds
    index = {}  # device -> i64[len(rows)]
    run = _stepped(loss_fn)

    def on(dev):
        if dev not in index:
            index[dev] = torch.as_tensor(list(rows), dtype=torch.int64).to(dev)
        return index[dev]

    def pick(x):
        return x if rows is None else x.index_select(0, on(x.device))

    def step(params, key, state: Optional[AdamState] = None):
        if state is None:
            state = AdamState(0, {k: torch.zeros_like(pick(v)) for k, v in params.items()},
                              {k: torch.zeros_like(pick(v)) for k, v in params.items()})
        t = state.t + 1
        count_step()
        with span("grad.step", {"step": t}):
            loss, grads = value_and_grad(run(params, key), params, key)
            with span("grad.update"), torch.no_grad():
                new, m, v = dict(params), {}, {}
                for k, p in params.items():
                    g = pick(grads[k])
                    m[k] = state.m[k].lerp(g, 1.0 - beta1)
                    v[k] = (state.v[k] * beta2).addcmul_(g, g, value=1.0 - beta2)
                    denom = (v[k].sqrt() / math.sqrt(1.0 - beta2**t)).add_(eps)
                    moved = pick(p).addcdiv(m[k], denom, value=-lr / (1.0 - beta1**t))
                    moved = moved.clamp_(lo, hi)
                    new[k] = moved if rows is None else p.index_copy(0, on(p.device), moved)
        return new, loss, AdamState(t, m, v)

    return step
