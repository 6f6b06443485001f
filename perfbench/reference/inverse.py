"""A gradient step of inverse rendering with the plain path tracer
(:mod:`.tracer`), drawn as the program's segment loop draws it.

- A step renders ``spp`` sample batches of the whole frame, batch ``i``
  under key ``fold_in(step key, i)``: element ``pixel`` (row-major) of
  the batch key's streams, the first ray's jitter from streams 2^30 and
  2^30 + 1, segment ``s``'s u1, u2 (and urr, in ``rr`` mode) from
  streams 4s, 4s + 1 (4s + 3). A lane holds one (pixel, batch) sample
  and drops out when its path ends; every batch of a block of pixels is
  traced together.
- The image is the mean of the batches; the loss is the mean over
  pixels and channels of (image − target)^2.
- The gradient with respect to one material's Kd is autograd through
  the tracer's segments (the sampling carries none), in blocks of pixels
  (the loss is a sum over pixels): the tracer's arithmetic in ``dtype``
  (float32, or a lower precision for the control), each lane's radiance,
  the image, the loss and the blocks' sums in float64.
- Matrix products, where any, in float32 (``allow_tf32`` off while it
  runs).
- The update is ``torch.optim.Adam``'s (no weight decay, no AMSGrad) in
  float64, then a clamp to the bounds.

It imports nothing of the program and takes nothing the program made
but the target image, which the check holds to this tracer at its own
pixels first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from . import threefry as TF
from . import tracer as R

JITTER_STREAM = R.JITTER_STREAM
BLOCK = 1 << 17  # pixels traced together (each with every batch of its step)


def exact_f32(fn):
    """Run ``fn`` with float32 matrix products in float32, not TF32 (the
    tracer has none; one added later cannot round lower unseen)."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        flags = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = [f.allow_tf32 for f in flags]
        with contextlib.ExitStack() as undo:
            for f, was in zip(flags, saved):
                f.allow_tf32 = False
                undo.callback(setattr, f, "allow_tf32", was)
            return fn(*args, **kwargs)
    return run


def batch_keys(step_key: np.ndarray, spp: int) -> np.ndarray:
    """The keys of a step's sample batches, u32[spp, 2]."""
    return TF.fold_in(np.asarray(step_key, np.uint32)[None], np.arange(spp))


def stream_table(keys: np.ndarray, est: R.Estimator) -> np.ndarray:
    """The streams a batch draws, folded into each batch key of ``keys``
    u32[B, 2]: u32[B, 2 + 3 S, 2]; slots 0 and 1 the first ray's jitter,
    2 + 3 s + k segment ``s``'s u1, u2, urr (k = 0, 1, 2)."""
    ids = [JITTER_STREAM, JITTER_STREAM + 1]
    for s in range(est.num_segments):
        ids += [4 * s, 4 * s + 1, 4 * s + 3]
    return TF.fold_in(np.asarray(keys, np.uint32)[:, None, :], np.asarray(ids)[None])


def _draw(table: torch.Tensor, batch: torch.Tensor, slot: int, pixels: torch.Tensor):
    """Element ``pixels[i]`` of stream ``slot`` of batch ``batch[i]``: f32[n]."""
    return TF.uniform_lanes(table[batch, slot], pixels)


def trace_lanes(scene: R.Scene, cam: R.Camera, est: R.Estimator, pixels: torch.Tensor,
                batch: torch.Tensor, table: torch.Tensor, stats: Optional[dict] = None):
    """One sample of pixel ``pixels[i]`` (i64[n]) in batch ``batch[i]``,
    drawn from ``table`` (:func:`stream_table`, i64 on the device): each
    lane's radiance, f64[3, n], differentiable in the scene's albedos.
    ``stats``, a dict, gains per segment the lanes that entered it
    (``live``), hit a triangle (``hit``), went on (``still``) and the
    boxes they reached (``boxes``)."""
    dt = cam.eye.dtype
    n = pixels.shape[0]
    pos, dir_ = R.camera_rays(cam, pixels, _draw(table, batch, 0, pixels).to(dt),
                              _draw(table, batch, 1, pixels).to(dt))
    tput = torch.ones(3, n, dtype=dt, device=pixels.device)
    total = torch.zeros(3, n, dtype=torch.float64, device=pixels.device)
    lanes = torch.arange(n, device=pixels.device)
    for s in range(est.num_segments):
        if lanes.numel() == 0:
            break
        px, bt = pixels[lanes], batch[lanes]
        u1, u2 = (_draw(table, bt, 2 + 3 * s + k, px).to(dt) for k in (0, 1))
        urr = _draw(table, bt, 2 + 3 * s + 2, px).to(dt) if est.mode == "rr" else None
        depth = torch.full((lanes.numel(),), s, dtype=torch.int64, device=pixels.device)
        reach = {} if stats is not None else None
        hit = R.intersect(scene, pos, dir_)[0] if stats is not None else None
        pos, dir_, tput, res, still = R.segment(scene, est, pos, dir_, tput, depth, u1, u2, urr,
                                                reach=reach)
        if stats is not None:
            got = stats.setdefault(s, dict(live=0, hit=0, still=0, boxes=0))
            got["live"] += lanes.numel()
            got["hit"] += int(hit.sum())
            got["still"] += int(still.sum())
            got["boxes"] += sum(reach.values())
        total = total.index_add(1, lanes, res.double())
        lanes, pos, dir_, tput = lanes[still], pos[:, still], dir_[:, still], tput[:, still]
    return total


@exact_f32
def render(scene: R.Scene, cam: R.Camera, est: R.Estimator, pixels: torch.Tensor,
           step_key: np.ndarray, spp: int, stats: Optional[dict] = None,
           block: int = BLOCK) -> torch.Tensor:
    """The mean of a step's ``spp`` batches at ``pixels``, f64[3, n], in
    blocks of ``block`` pixels (``stats``: :func:`trace_lanes`')."""
    dev = pixels.device
    table = torch.as_tensor(stream_table(batch_keys(step_key, spp), est).astype(np.int64),
                            device=dev)
    out = []
    for s in range(0, pixels.shape[0], block):
        px = pixels[s:s + block]
        n = px.shape[0]
        batch = torch.arange(spp, device=dev).repeat_interleave(n)
        total = trace_lanes(scene, cam, est, px.repeat(spp), batch, table, stats)
        out.append(total.reshape(3, spp, n).sum(dim=1) / spp)
    return torch.cat(out, dim=1)


def with_albedo(scene: R.Scene, material: int, kd: torch.Tensor) -> R.Scene:
    """The scene with material ``material``'s Kd set to ``kd`` (f64[3]),
    differentiably."""
    rows = scene.kd.clone()
    rows = rows.index_put((torch.tensor([material], device=rows.device),),
                          kd.to(rows.dtype)[None])
    return dataclasses.replace(scene, kd=rows)


@exact_f32
def loss_and_grad(scene: R.Scene, cam: R.Camera, est: R.Estimator, step_key: np.ndarray,
                  spp: int, target: torch.Tensor, material: int, kd, *, block: int = BLOCK):
    """The step's loss and its gradient with respect to material
    ``material``'s Kd at ``kd`` (3 numbers), against ``target`` f32[H, W,
    3]: (float, f64[3] numpy)."""
    H, W = cam.height, cam.width
    dev = cam.eye.device
    flat = target.reshape(-1, 3).to(device=dev, dtype=torch.float64)
    p = torch.tensor(np.asarray(kd, np.float64), device=dev, requires_grad=True)
    sc = with_albedo(scene, material, p)
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    grad = torch.zeros(3, dtype=torch.float64, device=dev)
    for s in range(0, H * W, block):
        pixels = torch.arange(s, min(s + block, H * W), device=dev)
        img = render(sc, cam, est, pixels, step_key, spp, block=block)
        part = ((img - flat[pixels].T) ** 2).sum() / (3 * H * W)
        g, = torch.autograd.grad(part, p, retain_graph=True)
        loss += part.detach()
        grad += g
    return float(loss), grad.cpu().numpy()


def adam(kd, m, v, t: int, g, *, lr: float, betas, eps: float, bounds):
    """``torch.optim.Adam``'s step ``t`` (from 1) from moments ``m``,
    ``v`` with gradient ``g``, then the clamp: (kd, m, v), f64[3] each."""
    b1, b2 = betas
    kd, m, v, g = (np.asarray(x, np.float64) for x in (kd, m, v, g))
    m = m + (1.0 - b1) * (g - m)
    v = b2 * v + (1.0 - b2) * g * g
    denom = np.sqrt(v) / math.sqrt(1.0 - b2**t) + eps
    kd = np.clip(kd - lr / (1.0 - b1**t) * m / denom, bounds[0], bounds[1])
    return kd, m, v
