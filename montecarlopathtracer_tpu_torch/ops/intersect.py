"""Ray/triangle-soup intersection through per-triangle affine transforms.

The counterpart of ``montecarlopathtracer_tpu/ops/intersect.py``. Each
triangle gets the "unit triangle" transform

    M_t = inv([b-a, c-a, n])           (columns; n = (b-a)×(c-a))

so that for a ray (o, d):

    o' = M_t (o - a)        d' = M_t d
    t  = -o'_z / d'_z
    β  = o'_x + t d'_x      γ = o'_y + t d'_y

and the reference's accept test is β > 0, γ > 0, β + γ < 1, t > 0,
nearest t; the hit point is ``a (1-β-γ) + b β + c γ``.

:func:`intersect_brute` is the plain f32 oracle that the segment kernel
is checked against. It contracts with elementwise multiply-adds, never
a matmul, so no TF32 path can touch the selection.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

_DET_EPS = 1e-12


class Hit(NamedTuple):
    """Closest-hit record for R rays; ``tri_id < 0`` means miss."""

    tri_id: torch.Tensor  # i32[R]
    t: torch.Tensor  # f32[R] (inf on miss)
    beta: torch.Tensor  # f32[R]
    gamma: torch.Tensor  # f32[R]
    point: torch.Tensor  # f32[R, 3]


def triangle_transforms(
    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-triangle unit-triangle transforms ``(m f32[T,3,3], m_a
    f32[T,3])`` with ``m_a = m @ a``, so ``o' = m o − m_a`` and
    ``d' = m d``.

    A degenerate (zero-area or padding) triangle has det = n·n < 1e-12;
    its determinant is clamped to 1 so the transform stays finite, and
    its (β, γ, t) then fail the accept test.
    """
    e_b = b - a
    e_c = c - a
    n = torch.linalg.cross(e_b, e_c)
    det = torch.sum(n * n, dim=-1)
    safe_det = torch.where(det.abs() < _DET_EPS, torch.ones_like(det), det)
    inv_det = 1.0 / safe_det
    # Rows of adj(E) for E = [e_b, e_c, n] (det(E) = n·n).
    r0 = torch.linalg.cross(e_c, n)
    r1 = torch.linalg.cross(n, e_b)
    m = torch.stack([r0, r1, n], dim=-2) * inv_det[:, None, None]
    m_a = (m * a[:, None, :]).sum(dim=-1)
    return m, m_a


def intersect_brute(
    m: torch.Tensor,  # f32[T, 3, 3]
    m_a: torch.Tensor,  # f32[T, 3]
    tri_valid: torch.Tensor,  # bool[T]
    origins: torch.Tensor,  # f32[R, 3]
    dirs: torch.Tensor,  # f32[R, 3]
    ray_chunk: Optional[int] = 4096,
) -> Hit:
    """Closest hit of every ray against every triangle (brute force).

    Semantics of the JAX oracle: parallel rays (|d'_z| < 1e-12) never
    hit; ties on t go to the smallest triangle index. ``ray_chunk``
    bounds the materialized ``[rays, T]`` intermediates.
    """
    R = origins.shape[0]
    step = R if not ray_chunk else ray_chunk
    tri_id, t_out, beta_out, gamma_out = [], [], [], []
    cols = torch.arange(m.shape[0], device=m.device)
    for s in range(0, R, step):
        o = origins[s:s + step, None, :]  # (r, 1, 3) against m (T, 3, 3)
        d = dirs[s:s + step, None, :]
        op = [(m[:, k] * o).sum(dim=-1) - m_a[:, k] for k in range(3)]
        dp = [(m[:, k] * d).sum(dim=-1) for k in range(3)]
        dz = dp[2]
        par = dz.abs() < _DET_EPS
        t = torch.where(par, -1.0, -op[2] / torch.where(par, 1.0, dz))
        beta = op[0] + t * dp[0]
        gamma = op[1] + t * dp[1]
        ok = (
            (beta > 0.0) & (gamma > 0.0) & (beta + gamma < 1.0) & (t > 0.0)
            & tri_valid[None, :]
        )
        tm = torch.where(ok, t, torch.inf)
        best = tm.amin(dim=1)
        idx = torch.where(tm == best[:, None], cols, m.shape[0]).amin(dim=1)
        r = torch.arange(idx.shape[0], device=m.device)
        tri_id.append(torch.where(torch.isinf(best), -1, idx).to(torch.int32))
        t_out.append(best)
        beta_out.append(beta[r, idx])
        gamma_out.append(gamma[r, idx])
    tri_id = torch.cat(tri_id)
    t = torch.cat(t_out)
    miss = tri_id < 0
    beta = torch.where(miss, 0.0, torch.cat(beta_out))
    gamma = torch.where(miss, 0.0, torch.cat(gamma_out))
    point = origins + torch.where(miss, 0.0, t)[:, None] * dirs
    return Hit(tri_id=tri_id, t=t, beta=beta, gamma=gamma, point=point)
