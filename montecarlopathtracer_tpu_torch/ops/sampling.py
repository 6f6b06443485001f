"""BSDF importance samplers on the ray wavefront (SoA ``[3, R]``).

The counterpart of ``montecarlopathtracer_tpu/ops/sampling.py``, op for
op: every conditional is a ``torch.where`` over all lanes, and every
square root and division is guarded so unselected lanes stay finite.
All functions take explicit uniforms, drawn by the caller from the
counter-based streams in :mod:`.rng`.

Conventions (those of the reference):
- local frames are built about +Y; a local direction
  ``(sinT cosφ, cosT, sinT sinφ)`` is rotated so +Y maps to the normal,
  with exact special cases for normal = ±Y;
- `sample_phong` samples the half-vector from the cos^Ns lobe and
  mirrors the incident direction about it;
- `sample_fresnel` refracts with probability ``Tr * (1 - (1-|n·i|)^5)``
  (Snell, total internal reflection on exit), else mirrors.
"""

from __future__ import annotations

import math

import torch

_EPS = 1.19209290e-7  # FLT_EPSILON, matching the reference's guards
_TWO_PI = 2.0 * math.pi


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product of [3, R] vectors → [R]."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def normalize3(v: torch.Tensor) -> torch.Tensor:
    """Safe-normalize [3, R] vectors."""
    n = torch.sqrt(torch.clamp_min(dot3(v, v), _EPS * _EPS))
    return v / n[None, :]


def _sqrt_nonneg(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) whose adjoint is 0, not ∞, where x ≤ 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _rotate_to_frame(local: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Rotate +Y-frame directions [3, R] into the frame of ``normal``:
    normal ≈ -Y → negate; normal ≈ +Y → identity; otherwise the
    closed-form rotation with invlen = 1/sqrt(1-ny²)."""
    nx, ny, nz = normal[0], normal[1], normal[2]
    dx, dy, dz = local[0], local[1], local[2]
    s2 = torch.clamp_min(1.0 - ny * ny, _EPS * _EPS)
    inv_len = 1.0 / torch.sqrt(s2)
    length = torch.sqrt(s2)
    rx = (nz * dx + nx * ny * dz) * inv_len + nx * dy
    ry = ny * dy - dz * length
    rz = (-nx * dx + nz * ny * dz) * inv_len + nz * dy
    rotated = torch.stack([rx, ry, rz])
    near_neg_y = (torch.abs(ny + 1.0) < _EPS)[None, :]
    near_pos_y = (torch.abs(ny - 1.0) < _EPS)[None, :]
    out = torch.where(near_pos_y, local, rotated)
    return torch.where(near_neg_y, -local, out)


def _lobe(u1, u2, ns) -> torch.Tensor:
    """Local +Y-frame direction from the cos^Ns lobe.

    sinθ goes through the guarded square root: with Ns = 1000, cosθ
    rounds to exactly 1 for u1 above ~1 − 6e-5, where the plain sqrt's
    adjoint is ∞ and a zero cotangent would make it NaN. The forward
    value is the same; the adjoint there is 0."""
    cos_t = torch.pow(torch.clamp_min(u1, 1e-30), 1.0 / (ns + 1.0))
    sin_t = _sqrt_nonneg(1.0 - cos_t * cos_t)
    phi = _TWO_PI * u2
    return torch.stack([sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi)])


def sample_hemi(u1, u2, normal) -> torch.Tensor:
    """Cosine-weighted hemisphere sample about ``normal`` [3, R]:
    sinθ = √u1, cosθ = √(1-u1), φ = 2πu2."""
    sin_t = torch.sqrt(u1)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    phi = _TWO_PI * u2
    local = torch.stack([sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi)])
    return _rotate_to_frame(local, normal)


def sample_phong(u1, u2, normal, indir, ns) -> torch.Tensor:
    """Blinn-Phong sample: a half-vector from the cos^Ns lobe about
    ``normal`` (cosθ = u1^{1/(Ns+1)}), the incident direction mirrored
    about it."""
    half = _rotate_to_frame(_lobe(u1, u2, ns), normal)
    return indir - half * (2.0 * dot3(indir, half))[None, :]


def _reflect(indir, normal) -> torch.Tensor:
    return indir - normal * (2.0 * dot3(indir, normal))[None, :]


def sample_phong_reflect(u1, u2, normal, indir, ns) -> torch.Tensor:
    """Classic-Phong sample: the outgoing direction from the cos^Ns lobe
    about the mirror reflection of ``indir``."""
    return _rotate_to_frame(_lobe(u1, u2, ns), _reflect(indir, normal))


def sample_fresnel(u, normal, indir, tr, ni) -> torch.Tensor:
    """Schlick/Snell refract-or-reflect sample: refract w.p.
    ``Tr (1 - (1-|n·i|)^5)``; entering (n·i ≤ 0) uses 1/Ni, exiting uses
    Ni with total-internal-reflection fallback; otherwise mirror."""
    ndoti = dot3(indir, normal)
    tr_eff = tr * (1.0 - torch.pow(1.0 - torch.abs(ndoti), 5.0))
    refract = u < tr_eff
    entering = ndoti <= 0.0

    in_rad = 1.0 - (1.0 - ndoti * ndoti) / (ni * ni)
    in_alpha = -ndoti / ni - _sqrt_nonneg(in_rad)
    d_in = normalize3(normal * in_alpha[None, :] + indir / ni[None, :])

    test = 1.0 - (1.0 - ndoti * ndoti) * ni * ni
    out_alpha = -ndoti * ni + _sqrt_nonneg(test)
    d_out = normalize3(normal * out_alpha[None, :] + indir * ni[None, :])

    d_reflect = _reflect(indir, normal)
    d_refract = torch.where(
        entering[None, :], d_in,
        torch.where((test < 0.0)[None, :], d_reflect, d_out),
    )
    return torch.where(refract[None, :], d_refract, d_reflect)
