"""Stackless KD-tree traversal in torch ops.

The counterpart of ``montecarlopathtracer_tpu/ops/traverse.py``. The
flat tree of :mod:`..accel.kdtree` lists its nodes in pre-order with
skip links, so a ray's walk is a single monotone cursor:

    hit box & interior → cursor + 1      (descend into the left child)
    hit box & leaf     → test the leaf's triangles, then cursor = skip
    miss box           → cursor = skip   (jump over the subtree)

All rays advance together, one node per step; a ray is done when its
cursor reaches N (the node count) and stays there. The box test is JAX's
``_slab_test`` (explicit zero-direction guards, pruned against the
current closest t and behind the ray); the triangle test is its
unit-triangle transform with |d'_z| > 1e-12, β > 0, γ > 0, β + γ < 1,
0 < t < closest t.

What differs from the JAX walk, with the same result:

- JAX tests a leaf's triangles one after another in a 64-step masked
  loop. Here the rays that enter a leaf on a step are gathered and test
  the leaf's triangles together, in blocks of up to 16 over the tree's
  largest leaf (never more than 64), keeping the least t with ties to
  the earliest triangle in the leaf: what the strict ``t < closest t``
  of the sequential loop keeps.
- JAX checks every step whether any ray is still walking; here the
  finished rays are dropped from the walk every 8 steps (a finished
  ray's step is a no-op, so the check's period does not change the
  result).

This is not a Pallas kernel in the JAX package and has no hand-written
kernel here; a per-ray CUDA walk of the tree is later work (ROADMAP).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel.kdtree import FlatKDTree
from .intersect import Hit

LEAF_MAX = 64  # JAX _LEAF_MAX: the tree's small-node threshold
_LEAF_BLOCK = 16  # leaf triangles tested together
_CHECK_EVERY = 8  # steps between drops of the finished rays


class KDArrays(NamedTuple):
    """The flat KD tree as tensors on one device."""

    node_lo: torch.Tensor  # f32[N, 3]
    node_hi: torch.Tensor  # f32[N, 3]
    node_skip: torch.Tensor  # i64[N] next cursor when the box test fails
    leaf_start: torch.Tensor  # i64[N] offset into leaf_tris (interior: 0)
    leaf_count: torch.Tensor  # i64[N] 0 for interior nodes
    leaf_tris: torch.Tensor  # i64[L] concatenated leaf triangle ids
    max_leaf: int  # the largest leaf_count

    @classmethod
    def from_flat(cls, flat: FlatKDTree, device) -> "KDArrays":
        """The tree's arrays on ``device`` (explicit: a tree is built on the
        host and walked where the rays are)."""

        def t(x, dtype):
            return torch.as_tensor(np.asarray(x), device=device).to(dtype)

        count = np.asarray(flat.leaf_count)
        return cls(
            node_lo=t(flat.node_lo, torch.float32), node_hi=t(flat.node_hi, torch.float32),
            node_skip=t(flat.node_skip, torch.int64), leaf_start=t(flat.leaf_start, torch.int64),
            leaf_count=t(count, torch.int64), leaf_tris=t(flat.leaf_tris, torch.int64),
            max_leaf=int(count.max(initial=0)),
        )

    @property
    def num_nodes(self) -> int:
        return int(self.node_lo.shape[0])


def _slab_test(o, d, lo, hi, tmax):
    """JAX ``_slab_test``: bool[n], the ray segment [0, tmax] enters the
    box [lo, hi] (an axis with d = 0 by containment)."""
    zero = d == 0.0
    inside = (o >= lo) & (o <= hi)
    inv = torch.where(zero, 1.0, 1.0 / torch.where(zero, 1.0, d))
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.where(zero, torch.where(inside, -torch.inf, torch.inf), torch.minimum(t0, t1))
    tf = torch.where(zero, torch.where(inside, torch.inf, -torch.inf), torch.maximum(t0, t1))
    t_near = tn.amax(dim=-1)
    t_far = tf.amin(dim=-1)
    return (t_near <= t_far) & (t_near <= tmax) & (t_far >= 0.0)


def _leaf_tests(kd, m_rows, m_a, tri_valid, o, d, start, count, tmin):
    """The nearest accepted triangle of each ray's leaf (rays o, d f32[n,
    3]; the leaf's triangles leaf_tris[start : start + count]) with t
    below ``tmin``: (found bool[n], t, id, β, γ)."""
    n = o.shape[0]
    dev = o.device
    L = kd.leaf_tris.shape[0]
    best_t = tmin.clone()
    best_id = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_b = torch.zeros(n, device=dev)
    best_g = torch.zeros(n, device=dev)
    rows = torch.arange(n, device=dev)
    for k0 in range(0, min(kd.max_leaf, LEAF_MAX), _LEAF_BLOCK):
        ks = torch.arange(k0, min(k0 + _LEAF_BLOCK, kd.max_leaf, LEAF_MAX), device=dev)
        in_leaf = ks[None, :] < count[:, None]
        tid = kd.leaf_tris[(start[:, None] + ks[None, :]).clamp(0, L - 1)]
        tid = torch.where(in_leaf, tid, 0)
        ok = in_leaf & (tid >= 0) & tri_valid[tid.clamp_min(0)]
        tid = tid.clamp_min(0)
        mw = m_rows[tid].reshape(n, -1, 3, 3)
        o_p = (mw * o[:, None, None, :]).sum(dim=-1) - m_a[tid]
        d_p = (mw * d[:, None, None, :]).sum(dim=-1)
        dz = d_p[..., 2]
        safe = dz.abs() > 1e-12
        t = torch.where(safe, -o_p[..., 2] / torch.where(safe, dz, 1.0), -1.0)
        beta = o_p[..., 0] + t * d_p[..., 0]
        gamma = o_p[..., 1] + t * d_p[..., 1]
        ok &= (beta > 0.0) & (gamma > 0.0) & (beta + gamma < 1.0) & (t > 0.0)
        tm = torch.where(ok, t, torch.inf)
        low = tm.amin(dim=1)
        first = torch.where(tm == low[:, None], ks[None, :] - k0, _LEAF_BLOCK).amin(dim=1)
        better = low < best_t
        best_t = torch.where(better, low, best_t)
        best_id = torch.where(better, tid[rows, first], best_id)
        best_b = torch.where(better, beta[rows, first], best_b)
        best_g = torch.where(better, gamma[rows, first], best_g)
    return best_id >= 0, best_t, best_id, best_b, best_g


def intersect_kdtree(kd: KDArrays, m, m_a, tri_valid, origins, dirs) -> Hit:
    """Closest hit of rays ``origins``, ``dirs`` f32[R, 3] over the
    triangles of transforms ``m`` f32[T, 3, 3], ``m_a`` f32[T, 3]
    (``tri_valid`` bool[T]) by the KD walk: JAX ``intersect_kdtree``.
    Equal to :func:`.intersect.intersect_brute` up to the order of the
    min-reduction (near-ties). A miss has tri_id −1, t = inf, β = γ = 0
    and point = origin. Not differentiable: the integrator recomputes
    the hit from the winners (:func:`.nearest_shade.refine_hit`)."""
    with torch.no_grad():
        return _walk(kd, m, m_a, tri_valid, origins, dirs)


def _walk(kd, m, m_a, tri_valid, origins, dirs) -> Hit:
    R = origins.shape[0]
    N = kd.num_nodes
    dev = origins.device
    m_rows = m.reshape(-1, 9)
    tmin = torch.full((R,), torch.inf, device=dev)
    best_id = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_b = torch.zeros(R, device=dev)
    best_g = torch.zeros(R, device=dev)
    lanes = torch.arange(R, device=dev)  # the rays still walking
    o, d = origins, dirs
    cursor = torch.zeros(R, dtype=torch.int64, device=dev)
    step = 0
    while lanes.numel():
        node = cursor.clamp_max(N - 1)
        active = cursor < N
        count = torch.where(active, kd.leaf_count[node], 0)
        box_hit = active & _slab_test(o, d, kd.node_lo[node], kd.node_hi[node], tmin[lanes])
        is_leaf = count > 0
        sel = (box_hit & is_leaf).nonzero()[:, 0]
        if sel.numel():
            ray = lanes[sel]
            found, t, tid, b, g = _leaf_tests(kd, m_rows, m_a, tri_valid, o[sel], d[sel],
                                              kd.leaf_start[node[sel]], count[sel], tmin[ray])
            ray = ray[found]
            tmin[ray], best_id[ray], best_b[ray], best_g[ray] = (
                t[found], tid[found], b[found], g[found])
        cursor = torch.where(box_hit & ~is_leaf, cursor + 1,
                             torch.where(active, kd.node_skip[node], cursor))
        step += 1
        if step % _CHECK_EVERY == 0:
            keep = (cursor < N).nonzero()[:, 0]
            lanes, o, d, cursor = lanes[keep], o[keep], d[keep], cursor[keep]
    miss = best_id < 0
    point = origins + torch.where(miss, 0.0, tmin)[:, None] * dirs
    return Hit(tri_id=best_id.to(torch.int32), t=tmin, beta=best_b, gamma=best_g, point=point)
