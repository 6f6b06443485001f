"""Progressive film: running-mean accumulation and tonemapping.

The counterpart of ``montecarlopathtracer_tpu/render/film.py``. The film
is the per-pixel running mean plus the total sample weight, all
float32, so film + weight is an exact, restartable checkpoint.

- :func:`film_update` — linear running mean (the CUDA estimator).
- :func:`film_update_gamma` — MCRT's gamma-space running mean
  ``new = ((old^2.2 * prev + batch * w) / (prev + w))^(1/2.2)``, a
  different (biased) estimator kept for backend parity.

``m2`` is a Welford second moment over batch means (pixel-averaged), so
the renderer can report an online noise estimate each pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Film:
    """Running-mean image plus accumulated sample weight."""

    color: torch.Tensor  # f32[H, W, 3], mean radiance so far
    weight: torch.Tensor  # f32[], total accumulated sample weight
    m2: torch.Tensor  # f32[], Welford second moment (batch-mean spread)

    @classmethod
    def zeros(cls, height: int, width: int, device="cpu") -> "Film":
        return cls(
            color=torch.zeros(height, width, 3, device=device),
            weight=torch.zeros((), device=device),
            m2=torch.zeros((), device=device),
        )


def film_update(film: Film, batch_mean: torch.Tensor, batch_weight: float) -> Film:
    """Fold a batch mean with the given weight into the running mean."""
    w = float(batch_weight)
    new_weight = film.weight + w
    color = (film.color * film.weight + batch_mean * w) / torch.clamp_min(
        new_weight, 1e-20
    )
    # Welford: m2 += mean_px[w · (b − M_{k−1}) · (b − M_k)], counted
    # only once a prior mean exists.
    dev = torch.mean(w * (batch_mean - film.color) * (batch_mean - color))
    m2 = film.m2 + torch.where(film.weight > 0.0, dev, 0.0)
    return Film(color=color, weight=new_weight, m2=m2)


def film_update_gamma(
    film: Film, batch_mean: torch.Tensor, batch_weight: float, gamma: float = 2.2
) -> Film:
    """MCRT's gamma-space progressive average: the stored film is
    gamma-encoded; each update decodes, folds the linear batch in and
    re-encodes."""
    w = float(batch_weight)
    new_weight = film.weight + w
    lin = torch.pow(torch.clamp_min(film.color, 0.0), gamma)
    mixed = (lin * film.weight + batch_mean * w) / torch.clamp_min(
        new_weight, 1e-20
    )
    color = torch.pow(torch.clamp_min(mixed, 0.0), 1.0 / gamma)
    dev = torch.mean(w * (batch_mean - lin) * (batch_mean - mixed))
    m2 = film.m2 + torch.where(film.weight > 0.0, dev, 0.0)
    return Film(color=color, weight=new_weight, m2=m2)


def _to_numpy(color: torch.Tensor) -> np.ndarray:
    return color.detach().cpu().numpy()


def tonemap_linear(color: torch.Tensor) -> np.ndarray:
    """Linear → 8-bit with clipping, no gamma (the CUDA backend's
    output: color × 255)."""
    return np.clip(_to_numpy(color) * 255.0, 0.0, 255.0).astype(np.uint8)


def tonemap_gamma(color: torch.Tensor, gamma: float = 2.2) -> np.ndarray:
    """Linear → gamma-encoded 8-bit (the MCRT display transform)."""
    enc = np.power(np.clip(_to_numpy(color), 0.0, None), 1.0 / gamma)
    return np.clip(enc * 255.0, 0.0, 255.0).astype(np.uint8)


def tonemap_identity(color: torch.Tensor) -> np.ndarray:
    """8-bit passthrough for a film that already stores encoded values
    (``film_update_gamma`` accumulation)."""
    return np.clip(_to_numpy(color) * 255.0, 0.0, 255.0).astype(np.uint8)
