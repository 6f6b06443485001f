"""The port's large-scene path against the JAX package's, on the CPU.

- The procedural bunny (``models/bunny.py``): every field and the camera
  equal to the JAX package's (its first T triangles).
- Morton helpers (``ops/morton.py``): bit-equal to the JAX package's on
  a subdiv-3 bunny (the port's pack is not padded to 128 triangles, so
  the first T entries are compared).
- ``tile_chunk_order``: equal to JAX's (no lane groups), and
  conservative: every chunk that holds a live ray's nearest hit is in its
  tile's list, with tmin at most the hit distance + 1e-4.
- The walk's tree (``walk_tables``): parents hold their children, the
  leaves are the chunk boxes, padding nodes are empty, and every node on
  the path to the leaf of a ray's brute winner passes the widened slab
  test at the winner's t; a pure-torch emulation of the kernel's per-ray
  walk (nearer child first, a stack, the sphere rejection, the least
  (t, index) rule) gives the plain version's winners, on the bunny and on
  a soup of built equal-t ties met in reverse index order. The
  precomputed spheres (``sphere_split_ref``) hold every vertex of the
  Cornell and bunny tables.
- The walk's plain version (``traverse_select_ref``, brute f32 over the
  permuted table) against JAX ``traverse_select`` in interpret mode,
  with dead lanes: winners agree on at least 99.9% of live lanes and
  every mismatch is a near-tie (``testing.near_ties``).
- The segment from known winners (B6, and B6l with per-lane flags):
  plain ``rows_segment`` against JAX ``rows_segment_fwd`` in interpret
  mode, at the same winners; both divide exactly, so every output is
  held to rtol = atol = 1e-5 (``testing.compare_segment``).
- Whole traverse renders (32x24, depth 2, ray sort on and off) against
  the JAX package's with the frame gate (``testing.compare_images``),
  and the ray sort bit-identical to the unsorted trace.
- Traverse gradients against ``jax.value_and_grad`` on the traverse path
  (interpret mode): per parameter within 5e-5 of |ref| + max |ref|; the
  JAX backward scatters row cotangents with a 2-term bf16 split (as in
  ``tests/test_torch_grad_render.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu.diff import grad as JG
from montecarlopathtracer_tpu.models import bunny as jbunny
from montecarlopathtracer_tpu.models import cornell as jcornell
from montecarlopathtracer_tpu.ops import intersect_pallas as JP
from montecarlopathtracer_tpu.ops import segment_fused as JF
from montecarlopathtracer_tpu.ops import traverse_pallas as JT
from montecarlopathtracer_tpu.ops.intersect import triangle_transforms
from montecarlopathtracer_tpu.render.integrator import (
    TraceConfig as JTraceConfig,
    render_sample_batch as jax_render_sample_batch,
)
from montecarlopathtracer_tpu_torch import cli, convert
from montecarlopathtracer_tpu_torch.diff import grad as G
from montecarlopathtracer_tpu_torch.models import bunny, cornell
from montecarlopathtracer_tpu_torch.ops import morton as M
from montecarlopathtracer_tpu_torch.ops import segment_fused as F
from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW
from montecarlopathtracer_tpu_torch.ops.rng import make_key
from montecarlopathtracer_tpu_torch.render.integrator import (
    TraceConfig,
    render_sample_batch,
    scene_tables,
)
from montecarlopathtracer_tpu_torch.scene.scene import FIELDS
from montecarlopathtracer_tpu_torch.testing import (
    cap_torch_threads,
    compare_images,
    compare_param_grads,
    compare_segment,
    compare_winners,
    tie_soup,
)
from montecarlopathtracer_tpu_torch.utils.image import load_png
from montecarlopathtracer_tpu_torch.utils import profiling

cap_torch_threads()

TRAVERSE = TraceConfig(intersector="traverse")


@pytest.fixture(scope="module")
def bunnies():
    js, _ = jbunny.bunny_scene(subdiv=3, width=32, height=24)
    ts, _ = bunny.bunny_scene(subdiv=3, width=32, height=24)
    return js, ts


def _rays(seed, R, lo=(-5.5, 0.5, -5.5), hi=(5.5, 9.5, 5.5)):
    """Origins inside the room, half towards the blob and half in random
    directions; ~15% of lanes dead."""
    rs = np.random.RandomState(seed)
    pos = rs.uniform(lo, hi, (R, 3)).T.astype(np.float32)
    dirs = rs.normal(size=(3, R))
    h = R // 2
    dirs[:, :h] = rs.uniform([-2, 1, -3], [2, 5, 1], (h, 3)).T - pos[:, :h]
    dirs = (dirs / np.linalg.norm(dirs, axis=0, keepdims=True)).astype(np.float32)
    return pos, dirs, rs.uniform(size=R) > 0.15


@pytest.mark.parametrize("subdiv", [1, 3])
def test_bunny_scene_matches_jax(subdiv):
    """The carried-over procedural bunny: every field of the JAX package's
    pack (its first T triangles; the JAX pack pads the triangle axis to
    128) and its camera, exactly."""
    js, jcam = jbunny.bunny_scene(subdiv=subdiv, width=40, height=30)
    ts, tcam = bunny.bunny_scene(subdiv=subdiv, width=40, height=30)
    T = ts.num_triangles
    assert T == 12 + 20 * 4**subdiv
    assert bool(np.asarray(js.tri_valid)[:T].all()) and not np.asarray(js.tri_valid)[T:].any()
    for f in FIELDS:
        want = np.asarray(getattr(js, f))
        got = getattr(ts, f).numpy()
        np.testing.assert_array_equal(got, want[:T] if f.startswith("tri_") else want, f)
    for f in ("eye", "forward", "up", "right", "tan_half_x", "tan_half_y"):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(), np.asarray(getattr(jcam, f)), f)


def test_morton_helpers_match_jax(bunnies):
    js, ts = bunnies
    T = ts.num_triangles
    a, b, c = js.triangle_vertices()
    jperm = np.asarray(JP.morton_order(a, b, c, js.tri_valid))
    ta, tb, tc = ts.triangle_vertices()
    perm = M.morton_order(ta, tb, tc, ts.tri_valid)
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), jperm[:T])
    jlo, jhi = JP.chunk_aabbs_padded(a, b, c, js.tri_valid, jnp.asarray(jperm), TW.CHUNK)
    clo, chi = M.chunk_aabbs_padded(ta, tb, tc, ts.tri_valid, perm, TW.CHUNK)
    assert clo.shape == (-(-T // TW.CHUNK), 3)
    np.testing.assert_array_equal(clo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(chi.numpy(), np.asarray(jhi))

    pos, dirs, _ = _rays(1, 4096, lo=(-7, -1, -7), hi=(7, 11, 7))  # some outside the box
    jl, jh = js.aabb()
    tl, th = ts.aabb()
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    want = np.asarray(JP.ray_sort_keys(jnp.asarray(pos), jnp.asarray(dirs), jl, jh))
    got = M.ray_sort_keys(torch.from_numpy(pos), torch.from_numpy(dirs), tl, th)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _tables(ts):
    t = scene_tables(ts, TRAVERSE)
    return t.rows, t.clo, t.chi


def test_tile_chunk_order_matches_jax(bunnies):
    _, ts = bunnies
    rows, clo, chi = _tables(ts)
    pos, dirs, live = _rays(2, 4 * TW.RAY_TILE)
    live[TW.RAY_TILE:2 * TW.RAY_TILE] = False  # an all-dead tile
    want = JT.tile_chunk_order(jnp.asarray(pos), jnp.asarray(dirs),
                               jnp.asarray(live, jnp.float32)[None, :],
                               jnp.asarray(clo.numpy()), jnp.asarray(chi.numpy()),
                               TW.RAY_TILE)
    order, tmin, n_reach = TW.tile_chunk_order(
        torch.from_numpy(pos), torch.from_numpy(dirs), torch.from_numpy(live), clo, chi)
    nt = 4
    np.testing.assert_array_equal(order.numpy(), np.asarray(want[0])[:nt])
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(want[1])[:nt])
    np.testing.assert_array_equal(n_reach.numpy(), np.asarray(want[3])[:nt, 0])
    assert n_reach[1] == 0 and (n_reach[[0, 2, 3]] > 0).all()


def test_tile_chunk_order_is_conservative(bunnies):
    """Every chunk that holds a live ray's nearest hit is in the ray's
    tile list, with tmin <= the hit distance (+1e-4): otherwise the walk
    could skip or stop before a real hit."""
    _, ts = bunnies
    rows, clo, chi = _tables(ts)
    pos, dirs, live = _rays(3, 8 * TW.RAY_TILE)
    p, d, lv = map(torch.from_numpy, (pos, dirs, live))
    order, tmin, n_reach = TW.tile_chunk_order(p, d, lv, clo, chi)
    t, tri, _, _ = F._select_ref(rows, p, d)
    hits = 0
    for i in range(order.shape[0]):
        lanes = slice(i * TW.RAY_TILE, (i + 1) * TW.RAY_TILE)
        pos_of = {int(c): k for k, c in enumerate(order[i, :n_reach[i]])}
        for tid, th, ok in zip(tri[lanes], t[lanes], lv[lanes]):
            if not ok or th >= 3e38:
                continue
            c = int(tid) // TW.CHUNK
            assert c in pos_of, (i, c)
            assert float(tmin[i, pos_of[c]]) <= float(th) + 1e-4
            hits += 1
    assert hits > 500


def _tree_nodes_empty(tree, nc):
    """bool[2P]: the nodes that cover only padding leaves (and node 0)."""
    P = tree.shape[0] // 2
    first = torch.zeros(2 * P, dtype=torch.int64)
    for n in range(1, 2 * P):
        level = n.bit_length() - 1
        first[n] = (n - (1 << level)) << (P.bit_length() - 1 - level)
    first[0] = P
    return first >= nc


@pytest.mark.parametrize("nc", [1, 2, 5, 641, "bunny", "bunny_chunks"])
def test_walk_tree_structure(bunnies, nc):
    """The implicit tree over the leaf boxes: leaves P + j are box j (on
    the bunny, of its runs of TW.LEAF triangles as the render path builds
    it, or its 128-triangle chunks) with its ext and grow, padding leaves, the unused node 0 and
    every node over padding only are empty (lo > hi, ext = grow = 0),
    every other node is the min/max of its children's boxes with their
    largest ext and grow, and holds them."""
    if nc in ("bunny", "bunny_chunks"):  # the render path's leaves, and 128-triangle ones
        ts = bunnies[1]
        t = scene_tables(ts, TRAVERSE)
        if nc == "bunny":
            clo, chi, big = TW.walk_boxes(*ts.triangle_vertices(), ts.tri_valid, t.perm)
            tree = t.walk.tree
            assert torch.equal(big, t.walk.big) and 0 < big.shape[0] <= 12
        else:
            clo, chi, tree = t.clo, t.chi, TW.walk_tables(t.rows.detach(), t.clo, t.chi).tree
        P = TW.tree_leaves(clo.shape[0])
        assert tree.shape[0] == 2 * P == (128 if nc == "bunny" else 32)
        ext, grow = tree[P:P + clo.shape[0], 3], tree[P:P + clo.shape[0], 7]
        assert (ext > 0).all() and torch.isfinite(ext).all() and (grow > 0).all()
    else:
        rs = np.random.RandomState(nc)
        clo = torch.from_numpy(rs.uniform(-5, 5, (nc, 3)).astype(np.float32))
        chi = clo + torch.from_numpy(rs.uniform(0, 2, (nc, 3)).astype(np.float32))
        ext, grow = (torch.from_numpy(rs.uniform(0, 1, nc).astype(np.float32)) for _ in "eg")
        tree = TW.tree_ref(clo, chi, ext, grow)
    nc = clo.shape[0]
    P = tree.shape[0] // 2
    assert P >= nc > P // 2 and tree.dtype == torch.float32
    lo, hi = tree[:, 0:3], tree[:, 4:7]
    assert torch.equal(lo[P:P + nc], clo) and torch.equal(hi[P:P + nc], chi)
    assert torch.equal(tree[P:P + nc, 3], ext) and torch.equal(tree[P:P + nc, 7], grow)
    empty = _tree_nodes_empty(tree, nc)
    assert (lo[empty] > hi[empty]).all() and (lo[~empty] <= hi[~empty]).all()
    assert (tree[empty][:, [3, 7]] == 0).all()
    for n in range(1, P):
        kids = [2 * n, 2 * n + 1]
        assert torch.equal(lo[n], lo[kids].amin(0)) and torch.equal(hi[n], hi[kids].amax(0))
        assert torch.equal(tree[n, [3, 7]], tree[kids][:, [3, 7]].amax(0))
        for k in kids:
            if not empty[k]:
                assert (lo[n] <= lo[k]).all() and (hi[n] >= hi[k]).all()


def test_walk_boxes_leave_out_the_large_triangles(bunnies):
    """``walk_boxes`` on the subdiv-3 bunny: the large triangles are the
    room's ten wall triangles (12 wide, against a median of 0.30; the 3-wide
    lamp stays in), listed by Morton position in ascending order, and the
    leaf boxes are those of the other triangles; past BIG_MAX large
    triangles, the widest are listed."""
    _, ts = bunnies
    t = scene_tables(ts, TRAVERSE)
    a, b, c = ts.triangle_vertices()
    lo, hi, big = TW.walk_boxes(a, b, c, ts.tri_valid, t.perm)
    assert big.dtype == torch.int32 and torch.equal(big, big.sort().values)
    assert sorted(t.perm[big.long()].tolist()) == list(range(10))
    keep = torch.ones_like(ts.tri_valid)
    keep[:10] = False
    want = M.chunk_aabbs_padded(a, b, c, keep, t.perm, TW.LEAF)
    assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])
    rs = np.random.RandomState(9)
    v = [torch.from_numpy(rs.uniform(0, 1, (600, 3)).astype(np.float32)) for _ in "abc"]
    for x in v[1:]:
        x[:] = v[0] + (x - v[0]) * 0.01  # small triangles
    v[1][:40] += torch.arange(40.0)[:, None] + 5.0  # 40 large ones, widths 5.0 .. 44.0
    valid = torch.ones(600, dtype=torch.bool)
    perm = torch.arange(600)
    assert TW.walk_boxes(*v, valid, perm)[2].shape[0] == 40
    old = TW.BIG_MAX
    try:
        TW.BIG_MAX = 8
        assert TW.walk_boxes(*v, valid, perm)[2].tolist() == list(range(32, 40))
    finally:
        TW.BIG_MAX = old


_F32 = np.float32
_BIG = _F32(3.0e38)


def _slab_box(o, d, lo, hi, ext, tmax):
    """nearest_common.cuh's ``slab_box`` in numpy f32: (reach, tn)."""
    tn, tf = -_BIG, _BIG
    for k in range(3):
        m = _F32(1e-5) * (_F32(1.0) + max(abs(lo[k]), abs(hi[k]))) + ext
        lk, hk = lo[k] - m, hi[k] + m
        if abs(d[k]) < _F32(1e-12):
            if o[k] < lk or o[k] > hk:
                tn, tf = _BIG, -_BIG
        else:
            inv = _F32(1.0) / d[k]
            t0, t1 = (lk - o[k]) * inv, (hk - o[k]) * inv
            tn, tf = max(tn, min(t0, t1)), min(tf, max(t0, t1))
    return bool(tn <= tf and tf >= 0 and tn <= tmax), tn


def _node_reach(tree, n, o, d, on, tmax):
    """The kernel's ``node_reach``: node n's box widened by ext + grow·|o|."""
    lo, hi = tree[n, 0:3], tree[n, 4:7]
    if lo[0] > hi[0]:
        return False, _BIG
    return _slab_box(o, d, lo, hi, tree[n, 3] + tree[n, 7] * on, tmax)


def _emulated_walk(rows, walk, pos, dirs, live):
    """csrc/traverse_select.cu's per-ray walk in torch and numpy: the
    same tree, order, prune and tie rule; the large triangles first; each
    reached leaf's triangles behind the sphere rejection (radius K0 + the
    leaf's grow · |o|, in float64 on the f32 table), then the
    plain f32 pair test (``F._select_ref`` on the leaf's rows). Returns
    (idx i64[R], leaf order per ray)."""
    tree = walk.tree.numpy()
    sph = walk.tri[:, :4].double()
    assert torch.equal(walk.tri[:, 4:], rows[:, :12])
    P, T, leaf = walk.leaves, rows.shape[0], walk.leaf
    out, orders = [], []

    def test(tri, r, o64, d64, on, grow, best):
        v = sph[tri, :3] - o64
        b = v @ d64
        K = sph[tri, 3] + float(grow) * on
        near = (v * v).sum(1) * (d64 @ d64) - b * b <= K * K * (d64 @ d64)
        if near.any():
            t, i, _, _ = F._select_ref(rows[tri[near]], pos[:, r:r + 1], dirs[:, r:r + 1])
            t, i = _F32(t[0]), int(tri[near][i[0]])
            if t < best[0] or (t == best[0] and i < best[1]):
                return t, i
        return best

    for r in range(pos.shape[1]):
        order = []
        orders.append(order)
        if not live[r]:
            out.append(-1)
            continue
        o, d = pos[:, r].numpy(), dirs[:, r].numpy()
        o64, d64 = torch.from_numpy(o).double(), torch.from_numpy(d).double()
        on = _F32(o64.norm())
        best_t, best_i = test(walk.big.long(), r, o64, d64, on, tree[1, 7], (_BIG, -1))
        stack = []
        go, _ = _node_reach(tree, 1, o, d, on, _BIG)
        node = 1
        while go:
            if node >= P:
                base = (node - P) * leaf
                order.append(node - P)
                best_t, best_i = test(torch.arange(base, min(base + leaf, T)), r, o64, d64,
                                      on, tree[node, 7], (best_t, best_i))
            else:
                (h0, t0), (h1, t1) = (_node_reach(tree, c, o, d, on, best_t)
                                      for c in (2 * node, 2 * node + 1))
                if h0 and h1:
                    near_first = t0 <= t1
                    stack.append((2 * node + near_first, t1 if near_first else t0))
                    node = 2 * node + (not near_first)
                    continue
                if h0 or h1:
                    node = 2 * node + (not h0)
                    continue
            go = False
            while stack:
                node, tn = stack.pop()
                if tn <= best_t:
                    go = True
                    break
        out.append(best_i if best_t < _BIG else -1)
    return torch.tensor(out), orders


@pytest.mark.parametrize("widen", [True, False], ids=["widened", "chunk_boxes"])
def test_walk_tree_is_conservative(bunnies, widen):
    """For every live ray whose brute winner is not one of the large
    triangles (which every ray tests before the walk), each node on the
    path from the root to the leaf that holds the winner passes the slab
    test against the winner's t: the walk cannot prune it. On the bunny's
    well-shaped triangles this holds with the walk's widening and also
    with the bare leaf boxes (ext = grow = 0, only the box margin)."""
    _, ts = bunnies
    t_ = scene_tables(ts, TRAVERSE)
    rows, tree, P, leaf = t_.rows, t_.walk.tree.numpy().copy(), t_.walk.leaves, t_.walk.leaf
    if not widen:
        tree[:, [3, 7]] = 0.0
    pos, dirs, live = _rays(7, 1024)
    t, tri, _, _ = F._select_ref(rows, torch.from_numpy(pos), torch.from_numpy(dirs))
    checked, big = 0, set(t_.walk.big.tolist())
    for r in np.flatnonzero(live):
        if t[r] >= 3e38 or int(tri[r]) in big:
            continue
        n = P + int(tri[r]) // leaf
        on = _F32(np.linalg.norm(pos[:, r].astype(np.float64)))
        while n >= 1:
            assert _node_reach(tree, n, pos[:, r], dirs[:, r], on, _F32(t[r]))[0], (r, n)
            n //= 2
        checked += 1
    assert checked > 300


@pytest.mark.parametrize("case", ["bunny", "ties"])
def test_emulated_walk_matches_plain(bunnies, case):
    """The emulated per-ray walk gives ``traverse_select_ref``'s winners
    exactly: on 64 seeded rays over the bunny, and on ``tie_soup``, where
    the walk meets each winner's exact copy (a larger index in a chunk it
    enters first) before the winner and must keep the smaller index."""
    if case == "bunny":
        t_ = scene_tables(bunnies[1], TRAVERSE)
        rows, clo, chi, walk = t_.rows, t_.clo, t_.chi, t_.walk
        pos, dirs, live = (torch.from_numpy(x) for x in _rays(8, 64))
    else:
        _, rows, clo, chi, pos, dirs = tie_soup(R=64)
        live = torch.ones(64, dtype=torch.bool)
        walk = TW.walk_tables(rows, clo, chi)
    got, orders = _emulated_walk(rows, walk, pos, dirs, live)
    want = TW.traverse_select_ref(rows, clo, chi, pos, dirs, live, tables=walk)
    assert torch.equal(got, want.long())
    if case == "ties":
        ties = [o.index(2) < o.index(0) for o, i in zip(orders, want) if 0 <= i < 64]
        assert len(ties) > 48 and all(ties)
    else:
        assert (want[live] >= 0).sum() > 20


@pytest.mark.parametrize("scene", ["cornell", "bunny"])
def test_precomputed_spheres_hold_every_vertex(scene):
    """``sphere_split_ref`` (the walk's spheres, as ``triangle_sphere_split``
    computes them): every vertex of every triangle with a finite radius
    lies inside its sphere at |o| = 0, computed in float64 from the
    table's f32 vertices; the radius grows with |o| (sph_e >= 0), is at
    most twice the farthest vertex's distance plus 1e-3, and its slack
    (the widening of the walk's boxes) is positive and below it."""
    if scene == "cornell":
        ts, _ = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                    width=32, height=24)
        rows = F.pack_rows_full(ts)
        a, b, c = ts.triangle_vertices()
    else:
        ts, _ = bunny.bunny_scene(subdiv=3, width=32, height=24)
        t_ = scene_tables(ts, TRAVERSE)
        rows = t_.rows
        a, b, c = (v[t_.perm] for v in ts.triangle_vertices())
    sph, sph_e, slack = TW.sphere_split_ref(rows)
    finite = torch.isfinite(sph[:, 3])
    assert finite.float().mean() > 0.99 and (sph_e >= 0).all()
    assert (sph_e[~finite] == 0).all() and torch.equal(torch.isfinite(slack), finite)
    assert (slack[finite] > 0).all() and (slack[finite] < sph[finite, 3]).all()
    ctr, K0 = sph[finite, :3].double(), sph[finite, 3].double()
    far = torch.stack([(v[finite].double() - ctr).norm(dim=1) for v in (a, b, c)]).amax(0)
    assert (far <= K0).all(), float((far - K0).max())
    assert (K0 <= 2.0 * far + 1e-3).all()


def test_traverse_select_plain_matches_jax(bunnies):
    js, ts = bunnies
    T = ts.num_triangles
    rows, clo, chi = _tables(ts)
    a, b, c = js.triangle_vertices()
    m, m_a = triangle_transforms(a, b, c)
    jperm = JP.morton_order(a, b, c, js.tri_valid)
    ws = JP.pack_transforms_stream(m[jperm], m_a[jperm], js.tri_valid[jperm], TW.CHUNK)
    jclo, jchi = JP.chunk_aabbs_padded(a, b, c, js.tri_valid, jperm, TW.CHUNK)
    R = 2048
    pos, dirs, live = _rays(4, R)
    want = np.asarray(JT.traverse_select(ws, jclo, jchi, jnp.asarray(pos), jnp.asarray(dirs),
                                         jnp.asarray(live), ray_tile=512,
                                         t_chunk=TW.CHUNK, interpret=True))
    before = profiling.launches()
    got = TW.traverse_select(rows, clo, chi, torch.from_numpy(pos),
                             torch.from_numpy(dirs), torch.from_numpy(live)).numpy()
    assert profiling.launches() - before == {}  # CPU tensors: the plain version
    assert got.dtype == np.int32
    assert (got[live] < T).all() and 0.5 < (got[live] >= 0).mean() < 1.0
    rep = compare_winners(got, want, live=live, rows=rows, pos=pos, dir_=dirs)
    assert rep["ok"], rep


FLAG_CASES = {
    "fixed": dict(mode="fixed"),
    "rr": dict(mode="rr", illum=1.0, refract_kd=False),
}


@pytest.mark.parametrize("lane", [False, True], ids=["scalar_flags", "lane_flags"])
@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_rows_segment_plain_matches_jax(bunnies, case, lane):
    _, ts = bunnies
    rows, clo, chi = _tables(ts)
    R = 3000
    pos, dirs, live = _rays(5 + lane, R)
    rs = np.random.RandomState(len(case) + lane)
    p, d, lv = map(torch.from_numpy, (pos, dirs, live))
    idx = TW.traverse_select(rows, clo, chi, p, d, lv)
    x = dict(tput=rs.uniform(0.05, 1.0, (3, R)), res=rs.uniform(0.0, 0.5, (3, R)),
             u1=rs.uniform(size=R), u2=rs.uniform(size=R), urr=rs.uniform(size=R))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    if lane:  # final gather, roulette and hard kill mixed across lanes
        flags = (rs.uniform(size=(3, R)) < [[0.3], [0.5], [0.2]]).astype(np.float32)
    else:
        flags = np.asarray([[0.0], [1.0], [0.0]], np.float32)
    kw = {**dict(illum=10.0, eps_offset=0.01, refract_kd=True, phong_model="blinn"),
          **FLAG_CASES[case]}
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    before = profiling.launches()
    got = F.rows_segment(rows, idx, p, d, t["tput"], t["res"], lv, t["u1"], t["u2"],
                         t["urr"], torch.from_numpy(flags), **kw)
    assert profiling.launches() - before == {}
    idx_np = idx.numpy()
    full = rows.numpy()[np.maximum(idx_np, 0)].T
    want = JF.rows_segment_fwd(pos, dirs, x["tput"], x["res"], jnp.asarray(live),
                               jnp.asarray(idx_np >= 0), full, x["u1"], x["u2"], x["urr"],
                               flags, interpret=True, lane_flags=lane, **kw)
    rep = compare_segment((idx_np, *want), (idx_np, *got), live=live, rows=rows,
                          pos=pos, dir_=dirs)
    assert rep["ok"], rep
    assert 0.2 < got[4].numpy().mean() < 0.9  # both ended and surviving lanes


@pytest.mark.parametrize("ray_sort", [False, True], ids=["unsorted", "sorted"])
def test_traverse_render_matches_jax(ray_sort):
    W, H = 32, 24
    js, jcam = jbunny.bunny_scene(subdiv=2, width=W, height=H)
    ts, tcam = bunny.bunny_scene(subdiv=2, width=W, height=H)
    want = jax_render_sample_batch(
        js, jcam, jax.random.key(6), W, H,
        JTraceConfig(intersector="traverse", pallas_interpret=True, max_depth=2,
                     ray_chunk=0, ray_sort=ray_sort))
    cfg = TraceConfig(intersector="traverse", max_depth=2, ray_sort=ray_sort)
    got = render_sample_batch(ts, tcam, make_key(6), W, H, cfg)
    rep = compare_images(got.numpy(), np.asarray(want))
    assert rep["ok"], rep
    assert np.asarray(want).mean() > 0.0
    # The sort moves rays, never what they compute.
    other = render_sample_batch(ts, tcam, make_key(6), W, H,
                                TraceConfig(intersector="traverse", max_depth=2,
                                            ray_sort=not ray_sort))
    np.testing.assert_array_equal(got.numpy(), other.numpy())
    brute = render_sample_batch(ts, tcam, make_key(6), W, H, TraceConfig(max_depth=2))
    assert compare_images(got.numpy(), brute.numpy())["ok"]


def test_traverse_gradients_match_jax():
    W, H = 16, 12
    fields = ("mat_kd", "mat_ka", "vertices")
    js, jcam = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                    width=W, height=H)
    ts, tcam = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                   width=W, height=H)
    target = np.random.RandomState(1).uniform(0, 1, (H, W, 3)).astype(np.float32)
    jloss_fn = JG.make_loss_fn(
        js, jcam, jnp.asarray(target), width=W, height=H, spp=2,
        config=JTraceConfig(max_depth=2, ray_chunk=0, intersector="traverse",
                            pallas_interpret=True, ray_sort=True))
    jloss, jgrads = jax.value_and_grad(jloss_fn)(JG.split_params(js, fields),
                                                 jax.random.key(5))
    params = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in JG.split_params(js, fields).items()})
    loss_fn = G.make_loss_fn(ts, tcam, torch.from_numpy(target), width=W, height=H, spp=2,
                             config=TraceConfig(max_depth=2, intersector="traverse",
                                                ray_sort=True))
    loss, grads = G.value_and_grad(loss_fn, params, make_key(5))
    got = convert.params_to_numpy(grads)
    want = {k: np.asarray(v) for k, v in jgrads.items()}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    rep = compare_param_grads(want, got, 5e-5)
    assert rep["ok"], rep
    assert np.abs(got["mat_kd"]).max() > 0 and np.abs(got["mat_ka"]).max() > 0
    assert np.abs(got["vertices"]).max() == 0.0 == np.abs(want["vertices"]).max()
    # The same gradients as the brute path's (the Morton order only moves rows).
    mloss, mgrads = G.value_and_grad(
        G.make_loss_fn(ts, tcam, torch.from_numpy(target), width=W, height=H, spp=2,
                       config=TraceConfig(max_depth=2)), params, make_key(5))
    assert float(mloss) == pytest.approx(float(loss), rel=1e-6)
    assert compare_param_grads(convert.params_to_numpy(mgrads), got, 1e-6)["ok"]


def test_cli_bunny_traverse_writes_png(tmp_path):
    out = str(tmp_path / "bunny.png")
    rc = cli.main(["--device", "cpu", "--scene", "bunny", "--subdiv", "2",
                   "--intersector", "traverse", "--width", "24", "--height", "18",
                   "--spp-per-pass", "1", "--passes", "1", "--max-depth", "2",
                   "--out", out, "--quiet"])
    assert rc == 0 and os.path.exists(out)
    img = load_png(out)
    assert img.shape == (18, 24, 3) and img.max() > 0
