"""A decorrelated gradient step of inverse rendering with the plain path
tracer, drawn as Mitsuba's ``mi.render(..., seed_grad=...)`` draws it:
the primal and the adjoint under keys of their own.

- The primal renders the step's ``spp`` batches as :mod:`.inverse` does,
  batch ``i`` under ``fold_in(step key, i)``, with no tape; the loss is
  its mean over pixels and channels of (image − target)^2, the sums in
  float64.
- The adjoint renders ``spp_grad`` batches (Mitsuba's default: ``spp``),
  batch ``i`` under ``fold_in(fold_in(step key, GRAD_KEY), i)``.
- The gradient with respect to one material's Kd is autograd, in blocks
  of pixels, of (2 / N) Σ (I_a − T) I_b with I_a − T held constant (N
  the pixels times 3): unbiased for the gradient of (E[I] − T)^2, where
  one estimate's samples shared between the two factors add that of the
  estimate's variance.
- The update is :func:`.inverse.adam`'s.
- Matrix products, where any, in float32 (``allow_tf32`` off while it
  runs).

It imports nothing of the program; its render, key layout and Adam are
:mod:`.inverse`'s.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import inverse as RI
from . import threefry as TF

GRAD_KEY = 0x80000000  # the adjoint's word, folded into the step's key
adam = RI.adam


def adjoint_key(step_key: np.ndarray) -> np.ndarray:
    """The key under which the adjoint's batches are folded."""
    return TF.fold_in(np.asarray(step_key, np.uint32), GRAD_KEY)


@RI.exact_f32
def loss_and_grad(scene, cam, est, step_key: np.ndarray, spp: int, target: torch.Tensor,
                  material: int, kd, *, spp_grad: Optional[int] = None,
                  grad_key: Optional[np.ndarray] = None, block: int = RI.BLOCK):
    """The step's loss (the primal's) and its decorrelated gradient with
    respect to material ``material``'s Kd at ``kd`` (3 numbers), against
    ``target`` f32[H, W, 3]: (float, f64[3] numpy). ``spp_grad`` (default
    ``spp``) and ``grad_key`` (default :func:`adjoint_key` of the step's
    key) are the adjoint's."""
    H, W = cam.height, cam.width
    dev = cam.eye.device
    spp_grad = spp if spp_grad is None else spp_grad
    grad_key = adjoint_key(step_key) if grad_key is None else grad_key
    flat = target.reshape(-1, 3).to(device=dev, dtype=torch.float64)
    p = torch.tensor(np.asarray(kd, np.float64), device=dev, requires_grad=True)
    sc = RI.with_albedo(scene, material, p)
    n = 3 * H * W
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    grad = torch.zeros(3, dtype=torch.float64, device=dev)
    for s in range(0, H * W, block):
        pixels = torch.arange(s, min(s + block, H * W), device=dev)
        with torch.no_grad():
            err = RI.render(sc, cam, est, pixels, step_key, spp, block=block) - flat[pixels].T
        loss += (err ** 2).sum() / n
        img_b = RI.render(sc, cam, est, pixels, grad_key, spp_grad, block=block)
        g, = torch.autograd.grad((2.0 * err * img_b).sum() / n, p, retain_graph=True)
        grad += g
    return float(loss), grad.cpu().numpy()
