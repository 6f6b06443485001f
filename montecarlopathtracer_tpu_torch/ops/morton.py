"""Morton (Z-curve) orders of triangles and rays, and chunk boxes.

The counterparts of ``morton_order``, ``chunk_aabbs``,
``chunk_aabbs_padded``, ``ray_sort_keys`` and ``_part1by2`` in
``montecarlopathtracer_tpu/ops/intersect_pallas.py``, as torch ops on
any device, bit-equal to the JAX package's on the same inputs.

- :func:`morton_order` orders triangles by the Morton code of their
  centroid (10 bits per axis within the centroids' box), so that fixed
  chunks of 128 triangles are spatially tight; their boxes
  (:func:`chunk_aabbs`) are what the traversal walk culls with.
- :func:`ray_sort_keys` gives each ray a key of its origin's Morton code
  (9 bits per axis within the scene box) with its direction octant, so
  that a wavefront sorted by it puts coherent rays into one tile.

Codes are int64 holding unsigned 32-bit values (torch's uint32 sorts and
compares only partly on CUDA). Sorts are stable, as JAX's ``argsort``
and its ``(key, iota)`` sort are: Morton codes tie often, and another tie
order would give another permutation.
"""

from __future__ import annotations

from typing import Tuple

import torch

DEAD_KEY = 0xFFFFFFFF  # sort key of a ray that is not live: last
_BIG = 3.0e38


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` (int64) to every third bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_order(a, b, c, tri_valid) -> torch.Tensor:
    """Permutation i64[T] of the triangles ``a, b, c`` (f32[T, 3] corners)
    by the Morton code of their centroids; invalid triangles last."""
    cent = (a + b + c) / 3.0
    vm = tri_valid[:, None]
    lo = torch.where(vm, cent, _BIG).amin(dim=0)
    hi = torch.where(vm, cent, -_BIG).amax(dim=0)
    q = ((cent - lo) / torch.clamp_min(hi - lo, 1e-20)).clamp(0.0, 1.0)
    q = (q * 1023.0).to(torch.int64)
    code = _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) | (_part1by2(q[:, 2]) << 2)
    code = torch.where(tri_valid, code, DEAD_KEY)
    return torch.argsort(code, stable=True)


def chunk_aabbs(a, b, c, tri_valid, perm, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk boxes (clo, chi f32[nc, 3]) over the permuted triangle
    axis; T must divide into chunks. A chunk of invalid triangles only
    gets the point box at the origin."""
    T = a.shape[0]
    if T % chunk:
        raise ValueError(f"{T} triangles do not divide into chunks of {chunk}")
    tlo = torch.minimum(torch.minimum(a, b), c)[perm]
    thi = torch.maximum(torch.maximum(a, b), c)[perm]
    v = tri_valid[perm][:, None]
    tlo = torch.where(v, tlo, _BIG)
    thi = torch.where(v, thi, -_BIG)
    nc = T // chunk
    clo = tlo.reshape(nc, chunk, 3).amin(dim=1)
    chi = thi.reshape(nc, chunk, 3).amax(dim=1)
    empty = (clo[:, 0] > chi[:, 0])[:, None]
    return torch.where(empty, 0.0, clo), torch.where(empty, 0.0, chi)


def chunk_aabbs_padded(a, b, c, tri_valid, perm, chunk: int):
    """:func:`chunk_aabbs` for any T: the triangle axis is padded with
    invalid triangles to a multiple of ``chunk``."""
    T = a.shape[0]
    pad = -T % chunk
    if pad:
        zf = torch.zeros(pad, 3, dtype=a.dtype, device=a.device)
        a, b, c = (torch.cat([x, zf]) for x in (a, b, c))
        tri_valid = torch.cat([tri_valid, torch.zeros(pad, dtype=torch.bool,
                                                      device=a.device)])
        perm = torch.cat([perm, torch.arange(T, T + pad, dtype=perm.dtype,
                                             device=perm.device)])
    return chunk_aabbs(a, b, c, tri_valid, perm, chunk)


def ray_sort_keys(pos3, dir3, lo, hi) -> torch.Tensor:
    """Wavefront sort key i64[R] in [0, 2**32): the Morton code of the
    origin (9 bits per axis within the scene box ``lo``, ``hi`` f32[3]),
    laid out as [15 coarse origin bits | 3 octant bits | 12 fine origin
    bits], so that a tile is "rays from one coarse cell going the same
    way" (the JAX package's ``dir_bits=3`` layout)."""
    span = torch.clamp_min(hi - lo, 1e-20)
    q = ((pos3 - lo[:, None]) / span[:, None]).clamp(0.0, 1.0)
    qi = (q * 511.0).to(torch.int64) & 0x1FF
    morton = _part1by2(qi[0]) | (_part1by2(qi[1]) << 1) | (_part1by2(qi[2]) << 2)
    octant = ((dir3[0] > 0).long() | ((dir3[1] > 0).long() << 1)
              | ((dir3[2] > 0).long() << 2))
    return ((morton >> 12) << 15) | (octant << 12) | (morton & 0xFFF)
