"""Chunk culling's tables and its plain per-lane reach.

The culling kernels (B1c in ``csrc/segment_fused.cu``, B4c in
``csrc/nearest_shade.cu``, and the entries B10c and B11 over B4c) take
the triangles in Morton order and skip a 128-triangle chunk whose box a
ray's segment [0, best t] cannot enter. The exact pair test accepts hits
up to its rounding slack outside an ill-conditioned triangle, so the
vertices' box alone is not conservative: each chunk's box is widened,
for a ray with |o| = on, by ext + grow·on, the largest sphere slack
K0 − ρ and growth per unit of |o| of its triangles
(``sphere_select.cuh::triangle_sphere_split``), as the traversal walk's
tree widens its nodes.

- :func:`chunk_slack` builds that widening once per table, in torch ops
  on the table's device;
- :func:`chunk_reach` is the plain version of the kernels' per-lane test
  (``nearest_common.cuh::slab_reach``).
"""

from __future__ import annotations

import torch

from .traverse_walk import CHUNK, sphere_split_ref

_BIG = 3.0e38


def chunk_slack(rows, chunk: int = CHUNK) -> torch.Tensor:
    """f32[ceil(T / chunk), 2]: per chunk of ``chunk`` consecutive rows of
    ``rows`` f32[T, 48] (or the geometry table f32[T, 12]), ext = the
    largest sphere slack and grow = the largest radius growth per unit of
    |o| of its triangles (:func:`.traverse_walk.sphere_split_ref`). An
    ill-conditioned or non-finite triangle makes ext infinite; a triangle
    whose geometry is zero (padding) can never be accepted (d'_z = 0) and
    widens nothing."""
    _, grow, ext = sphere_split_ref(rows)
    never = (rows[:, :12] == 0).all(dim=1)
    T = rows.shape[0]
    pad = -T % chunk
    cols = [torch.nn.functional.pad(torch.where(never, 0.0, x), (0, pad)).reshape(-1, chunk)
            .amax(dim=1) for x in (ext, grow)]
    return torch.stack(cols, dim=1).contiguous()


def chunk_reach(clo, chi, o, d, t_best, slack=None) -> torch.Tensor:
    """bool[s, nc]: whether the segment [0, t_best] of each ray ``o``, ``d``
    f32[s, 3] (``t_best`` f32[s]) can enter the box of chunk j (``clo``,
    ``chi`` f32[nc, 3]) widened as the kernels widen it: the box margin
    1e-5·(1 + max |coordinate|), plus ext + grow·|o| with ``slack``
    f32[nc, 2] (:func:`chunk_slack`). An axis with |d| < 1e-12 is tested
    by containment. In f32, with ``fmin``/``fmax`` as the kernels'
    ``fminf``/``fmaxf``."""
    m = 1e-5 * (1.0 + torch.maximum(clo.abs(), chi.abs()))[None]  # [1, nc, 3]
    if slack is not None:
        on = torch.sqrt((o * o).sum(dim=1))
        m = m + (slack[None, :, 1] * on[:, None] + slack[None, :, 0])[..., None]
    lo, hi = clo[None] - m, chi[None] + m
    o, d = o[:, None, :], d[:, None, :]
    flat = d.abs() < 1e-12
    inv = 1.0 / torch.where(flat, 1.0, d)
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    outside = (o < lo) | (o > hi)
    # fmaxf/fminf pass over a NaN distance: it bounds nothing.
    near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
    tn = torch.where(flat, torch.where(outside, _BIG, -_BIG), near.masked_fill(near.isnan(), -_BIG))
    tf = torch.where(flat, torch.where(outside, -_BIG, _BIG), far.masked_fill(far.isnan(), _BIG))
    tn, tf = tn.amax(dim=2).clamp_min(-_BIG), tf.amin(dim=2).clamp_max(_BIG)
    return (tn <= tf) & (tf >= 0.0) & (tn <= t_best[:, None])
