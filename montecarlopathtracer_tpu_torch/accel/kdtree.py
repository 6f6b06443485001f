"""SAH/median hybrid KD-tree construction (host side) + flat device layout.

The port's numpy copy of ``montecarlopathtracer_tpu/accel/kdtree.py``
(the port imports nothing of the JAX package): the same construction, the
same flat arrays bit for bit, with :func:`build_flat_kdtree` dispatching
to the port's own native loader (:mod:`..native`).

Reproduces the build *policy* of the reference's KD-tree
(`MCRT/QuinEngine/Utils/KDTree.hpp:55-402`):

- BFS construction with a depth cap of 32 (KDTree.hpp:103-106);
- nodes with > 64 triangles: spatial median split on the longest AABB
  axis (KDTree.hpp:107-162);
- nodes with ≤ 64 triangles: exact SAH sweep over all triangle-vertex
  coordinates on the 3 axes as candidate planes, cost
  ``(AL·nL + AR·nR)/A0`` with zero traversal cost, splitting only when
  it beats the leaf cost ``numTri`` (KDTree.hpp:163-240);
- straddling triangles are duplicated into both children; a triangle
  lying flat *on* the split plane goes left (KDTree.hpp:129-153);
- child AABBs are clipped to the intersection of the split half and the
  union of the contained triangles' AABBs (KDTree.hpp:154-155).

The device layout is *not* the reference's BFS array with a 64-slot
triangle pad and a runtime stack (ShaderResource.hpp:128-179,
rtx.hlsl:151-209). Nodes are emitted in **pre-order with skip links**:
traversal is a single monotone cursor per ray (hit → descend to
``i+1``, miss → jump to ``skip[i]``), which the port walks with masked
torch ops and no per-lane stack memory (:mod:`..ops.traverse`), and leaf
triangles live in one CSR id buffer with no padding.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

LEAF_MAX = 64  # small-node threshold (KDTree.hpp:108)
DEPTH_CAP = 32  # (KDTree.hpp:103)


@dataclasses.dataclass
class _Node:
    lo: np.ndarray
    hi: np.ndarray
    tri_ids: np.ndarray  # int32 ids into the triangle soup
    axis: int = -1  # -1 = leaf, else 0/1/2
    value: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None


def _half_area(lo: np.ndarray, hi: np.ndarray) -> float:
    d = np.maximum(hi - lo, 0.0)
    return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def _clip_union(
    lo: np.ndarray, hi: np.ndarray, tlo: np.ndarray, thi: np.ndarray, ids
) -> Tuple[np.ndarray, np.ndarray]:
    """Intersect a node box with the union of the given triangles' boxes
    (the reference's ``aabb *= GetNodeAABB(...)``, KDTree.hpp:154-155)."""
    if len(ids) == 0:
        return lo.copy(), hi.copy()
    ulo = tlo[ids].min(axis=0)
    uhi = thi[ids].max(axis=0)
    return np.maximum(lo, ulo), np.minimum(hi, uhi)


def _partition(
    tlo: np.ndarray, thi: np.ndarray, ids: np.ndarray, axis: int, value: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference distribution rule (KDTree.hpp:129-153): flat-on-plane →
    left only; else min < value → left, max > value → right (both
    allowed → duplication)."""
    lo_a = tlo[ids, axis]
    hi_a = thi[ids, axis]
    flat_on = (lo_a == hi_a) & (lo_a == value)
    to_left = flat_on | (lo_a < value)
    to_right = ~flat_on & (hi_a > value)
    return ids[to_left], ids[to_right]


def _sah_split(
    node: _Node, tlo: np.ndarray, thi: np.ndarray, verts: List[np.ndarray]
) -> Optional[Tuple[int, float]]:
    """Exact SAH sweep over triangle-vertex candidate planes
    (KDTree.hpp:163-240). Returns (axis, value) or None for leaf."""
    ids = node.tri_ids
    n = len(ids)
    if n == 0:
        return None
    a0 = _half_area(node.lo, node.hi)
    if a0 <= 0.0:
        return None
    sah_leaf = float(n)
    best = None
    best_sah = np.inf
    for axis in range(3):
        cands = np.unique(
            np.concatenate([v[ids, axis] for v in verts])
        )
        cands = cands[(cands >= node.lo[axis]) & (cands <= node.hi[axis])]
        for value in cands:
            l_ids, r_ids = _partition(tlo, thi, ids, axis, float(value))
            nl, nr = len(l_ids), len(r_ids)
            lo_l, hi_l = node.lo.copy(), node.hi.copy()
            hi_l[axis] = value
            lo_r, hi_r = node.lo.copy(), node.hi.copy()
            lo_r[axis] = value
            al = 0.0
            ar = 0.0
            if nl:
                clo, chi = _clip_union(lo_l, hi_l, tlo, thi, l_ids)
                al = _half_area(clo, chi)
            if nr:
                clo, chi = _clip_union(lo_r, hi_r, tlo, thi, r_ids)
                ar = _half_area(clo, chi)
            sah = (al * nl + ar * nr) / a0
            if sah < best_sah:
                best_sah = sah
                best = (axis, float(value))
    if best is not None and best_sah < sah_leaf:
        return best
    return None


def build_kdtree(
    a: np.ndarray, b: np.ndarray, c: np.ndarray, valid: Optional[np.ndarray] = None
) -> _Node:
    """Build the KD-tree over triangle soup (a, b, c: f32[T, 3]).

    ``valid`` masks out padding triangles. Returns the root `_Node`.
    """
    T = a.shape[0]
    verts = [np.asarray(a, np.float64), np.asarray(b, np.float64), np.asarray(c, np.float64)]
    tlo = np.minimum(np.minimum(verts[0], verts[1]), verts[2])
    thi = np.maximum(np.maximum(verts[0], verts[1]), verts[2])
    ids = np.arange(T, dtype=np.int32)
    if valid is not None:
        ids = ids[np.asarray(valid, bool)]

    root = _Node(
        lo=tlo[ids].min(axis=0) if len(ids) else np.zeros(3),
        hi=thi[ids].max(axis=0) if len(ids) else np.zeros(3),
        tri_ids=ids,
    )
    work: List[Tuple[_Node, int]] = [(root, 0)]
    while work:
        node, depth = work.pop(0)
        if depth >= DEPTH_CAP:
            continue
        n = len(node.tri_ids)
        if n > LEAF_MAX:
            # Large node: spatial median on the longest axis
            # (KDTree.hpp:107-128).
            size = node.hi - node.lo
            axis = int(np.argmax(size))
            value = 0.5 * float(node.hi[axis] + node.lo[axis])
            split = (axis, value)
        else:
            split = _sah_split(node, tlo, thi, verts)
            if split is None:
                continue
            axis, value = split

        l_ids, r_ids = _partition(tlo, thi, node.tri_ids, axis, value)
        lo_l, hi_l = node.lo.copy(), node.hi.copy()
        hi_l[axis] = value
        lo_r, hi_r = node.lo.copy(), node.hi.copy()
        lo_r[axis] = value
        lo_l, hi_l = _clip_union(lo_l, hi_l, tlo, thi, l_ids)
        lo_r, hi_r = _clip_union(lo_r, hi_r, tlo, thi, r_ids)

        node.axis = axis
        node.value = value
        node.left = _Node(lo=lo_l, hi=hi_l, tri_ids=l_ids)
        node.right = _Node(lo=lo_r, hi=hi_r, tri_ids=r_ids)
        node.tri_ids = np.empty((0,), np.int32)
        work.append((node.left, depth + 1))
        work.append((node.right, depth + 1))
    return root


@dataclasses.dataclass
class FlatKDTree:
    """Pre-order + skip-link device layout (all numpy; converted to
    tensors by :meth:`..ops.traverse.KDArrays.from_flat`)."""

    node_lo: np.ndarray  # f32[N, 3]
    node_hi: np.ndarray  # f32[N, 3]
    node_skip: np.ndarray  # i32[N] next cursor when the AABB test fails
    leaf_start: np.ndarray  # i32[N] CSR offset into leaf_tris (interior: 0)
    leaf_count: np.ndarray  # i32[N] 0 for interior nodes
    leaf_tris: np.ndarray  # i32[L] concatenated leaf triangle ids

    @property
    def num_nodes(self) -> int:
        return int(self.node_lo.shape[0])


def flatten_kdtree(root: _Node, pad_leaf_to: int = 1) -> FlatKDTree:
    """Emit pre-order nodes with skip links and CSR leaf triangles."""
    lo, hi, skip, lstart, lcount = [], [], [], [], []
    leaf_tris: List[np.ndarray] = []
    total = 0

    def emit(node: _Node) -> int:
        nonlocal total
        idx = len(lo)
        lo.append(node.lo)
        hi.append(node.hi)
        skip.append(-1)  # patched after subtree emission
        if node.axis < 0:
            lstart.append(total)
            lcount.append(len(node.tri_ids))
            leaf_tris.append(np.asarray(node.tri_ids, np.int32))
            total += len(node.tri_ids)
        else:
            lstart.append(0)
            lcount.append(0)
            emit(node.left)
            emit(node.right)
        skip[idx] = len(lo)
        return idx

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        emit(root)
    finally:
        sys.setrecursionlimit(old)

    tris = (
        np.concatenate(leaf_tris)
        if leaf_tris
        else np.empty((0,), np.int32)
    )
    if pad_leaf_to > 1 and len(tris) % pad_leaf_to:
        pad = pad_leaf_to - len(tris) % pad_leaf_to
        tris = np.concatenate([tris, np.full((pad,), -1, np.int32)])
    return FlatKDTree(
        node_lo=np.asarray(lo, np.float32),
        node_hi=np.asarray(hi, np.float32),
        node_skip=np.asarray(skip, np.int32),
        leaf_start=np.asarray(lstart, np.int32),
        leaf_count=np.asarray(lcount, np.int32),
        leaf_tris=tris,
    )


def build_flat_kdtree(
    a: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    valid: Optional[np.ndarray] = None,
    pad_leaf_to: int = 1,
    backend: str = "auto",
) -> FlatKDTree:
    """Build + flatten in one call, choosing the implementation.

    ``backend``: ``"native"`` forces the C++ build (:mod:`..native`,
    the repository's ``native/mcpt_native.cpp`` — the analog of the
    reference's C++ `KDTree.hpp` host build), ``"python"`` forces this
    module, ``"auto"`` prefers native and falls back to this module
    when the library cannot be built, as the JAX package does. Both
    produce identical flat arrays (tested).
    The ``MCPT_NATIVE`` env var (0/1) overrides ``"auto"``.
    """
    import os

    if backend == "auto":
        env = os.environ.get("MCPT_NATIVE")
        if env is not None:
            backend = "native" if env not in ("0", "false", "") else "python"
    if backend in ("auto", "native"):
        from ..native import available, build_kdtree_native

        if available():
            return build_kdtree_native(a, b, c, valid, pad_leaf_to=pad_leaf_to)
        if backend == "native":
            from ..native import build_error

            raise RuntimeError(f"native KD build unavailable: {build_error()}")
    return flatten_kdtree(build_kdtree(a, b, c, valid), pad_leaf_to=pad_leaf_to)


def validate_kdtree(root: _Node, tlo: np.ndarray, thi: np.ndarray, n_tris: int):
    """Structural checks (the reference only has debug asserts +
    a visual OBJ dump): every triangle reachable from some leaf; leaf
    AABBs contained in parents; triangle boxes overlap their leaves."""
    seen = np.zeros(n_tris, bool)
    stack = [root]
    while stack:
        n = stack.pop()
        if n.axis < 0:
            seen[n.tri_ids] = True
            for t in n.tri_ids:
                assert (thi[t] >= n.lo - 1e-6).all() and (
                    tlo[t] <= n.hi + 1e-6
                ).all(), f"triangle {t} outside its leaf box"
        else:
            for ch in (n.left, n.right):
                assert (ch.lo >= n.lo - 1e-6).all() and (
                    ch.hi <= n.hi + 1e-6
                ).all(), "child AABB escapes parent"
            stack += [n.left, n.right]
    return seen


def dump_obj(root: _Node, path: str) -> None:
    """Write split planes as OBJ quads for visual inspection — parity
    with the reference's debug `KDTree::Dump` (KDTree.hpp:321-385)."""
    lines = ["g default"]
    nv = 0
    stack = [(root, root.lo.copy(), root.hi.copy())]
    while stack:
        node, lo, hi = stack.pop(0)
        if node.axis < 0:
            continue
        ax, v = node.axis, node.value
        o1, o2 = [i for i in range(3) if i != ax]
        corners = []
        for u, w in ((lo[o1], lo[o2]), (hi[o1], lo[o2]), (hi[o1], hi[o2]), (lo[o1], hi[o2])):
            p = [0.0, 0.0, 0.0]
            p[ax] = v
            p[o1] = u
            p[o2] = w
            corners.append(p)
        for p in corners:
            lines.append(f"v {p[0]} {p[1]} {p[2]}")
        lines.append(f"f {nv + 1} {nv + 2} {nv + 3} {nv + 4}")
        nv += 4
        lo_l, hi_l = lo.copy(), hi.copy()
        hi_l[ax] = v
        lo_r, hi_r = lo.copy(), hi.copy()
        lo_r[ax] = v
        stack.append((node.left, lo_l, hi_l))
        stack.append((node.right, lo_r, hi_r))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
