"""The culled loop's visiting rule, on the CPU (B1c, B4c and the entries
B10c and B11 over B4c).

The culling kernels make the warp the unit of culling: each warp (64
consecutive rays) votes over its rays' own slab tests, visits the chunks
that its rays reach nearest first (per window of 32 chunks, by the least
entry distance of its rays), and a hit out of index order wins on the
least (t, index) pair; inside a chunk, each lane tests only the leaves
of 16 triangles whose boxes its segment reaches. ``ops.cull.cull_visits``
emulates those visits in plain torch on top of each leaf's own winners,
beside six other rules (a vote per block, per group, per warp in index
order, each lane alone in index order and nearest first, and the floor).
Here: the kernels' rule, leaf boxes included, keeps every brute-force
winner on ``testing.hard_soup``'s seeded soups in Morton order (T = 700
and 1500) and on ``testing.tie_soup``, whose equal-t copies lie in a
chunk that the warps enter first; each winner's leaf box is reached at
the winner's t; the mean visit counts are ordered as the rules nest, on
the glossy stage's camera wavefront and its Morton-sorted first bounce;
the culled loop's triangle records (``ops.cull.cull_records``) hold
``traverse_walk.sphere_split_ref``'s spheres and the geometry rows, and
each chunk's grow bounds its triangles' growth; and on
``testing.hard_soup("corners")`` the leaf boxes need their slack (ROADMAP
C17): rule (d) keeps every winner with them and loses some with boxes of
the exact spheres.
"""

import pytest
import torch

from montecarlopathtracer_tpu_torch.models import glossy
from montecarlopathtracer_tpu_torch.ops import cull as CU
from montecarlopathtracer_tpu_torch.ops import segment_fused as F
from montecarlopathtracer_tpu_torch.ops.morton import (
    DEAD_KEY,
    chunk_aabbs_padded,
    morton_order,
    ray_sort_keys,
)
from montecarlopathtracer_tpu_torch.ops.rng import make_key, stream_uniform
from montecarlopathtracer_tpu_torch.ops.traverse_walk import sphere_split_ref
from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig, scene_tables
from montecarlopathtracer_tpu_torch.testing import (
    HARD_SOUPS,
    cap_torch_threads,
    hard_soup,
    tie_soup,
)

cap_torch_threads()

R = 8192
BIG = 3.0e38


def _same(a, b):
    """Equal, NaN where NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _brute(rows, pos, dir_):
    t, i, _, _ = F._select_ref(rows, pos, dir_)
    return t, torch.where(t < BIG, i, -1)


def _morton_soup(case, T):
    verts, rows, pos, dir_ = hard_soup(case, T, R, seed=T)
    valid = torch.ones(T, dtype=torch.bool)
    perm = morton_order(*verts, valid)
    clo, chi = chunk_aabbs_padded(*verts, valid, perm, 128)
    rows = rows[perm].contiguous()
    return rows, clo, chi, pos, dir_


@pytest.mark.parametrize("case", HARD_SOUPS)
def test_warp_order_keeps_every_winner_on_hard_soups(case):
    for T in (700, 1500):
        rows, clo, chi, pos, dir_ = _morton_soup(case, T)
        live = torch.ones(R, dtype=torch.bool)
        live[::7] = False
        out = CU.cull_visits(rows, clo, chi, CU.chunk_slack(rows), pos, dir_, live)
        t, i = _brute(rows, pos, dir_)
        assert torch.equal(out["idx"], torch.where(live, i, -1)), (case, T)
        assert torch.equal(out["t"], torch.where(live, t, BIG)), (case, T)
        nc = clo.shape[0]
        assert out["tested"].shape == (R // 128,) and (out["tested"] <= nc).all()
        m = out["mean"]
        assert m["g"] <= m["f"] <= m["e"] <= m["c"] <= m["b"] <= m["a"] <= nc, (case, T, m)
        assert m["f"] <= m["d"] <= m["c"], (case, T, m)
        assert 0 < out["leaves"] <= CU.CHUNK // CU.LEAF * m["d"], (case, T, out["leaves"])


@pytest.mark.parametrize("case", HARD_SOUPS)
def test_each_winner_reaches_its_leaf_box(case):
    """The widened leaf box of each brute-force winner's leaf is reached by
    the ray's segment [0, t of the winner]: no leaf test can drop it,
    whatever the order of the visits."""
    for T in (700, 1500):
        rows, _, _, pos, dir_ = _morton_soup(case, T)
        t, i = _brute(rows, pos, dir_)
        tn, ok = CU.leaf_entry(rows, CU.chunk_slack(rows), pos.T, dir_.T)
        hit = i >= 0
        assert hit.any(), (case, T)
        leaf = i[hit] // CU.LEAF
        lanes = hit.nonzero()[:, 0]
        assert (ok[lanes, leaf] & (tn[lanes, leaf] <= t[hit])).all(), (case, T)


def _exact_sphere_leaf_entry(rows, cslack, o, d):
    """``ops.cull.leaf_entry`` with the leaf boxes of the exact spheres:
    c ± ρ (ρ = K0 − slack), no grow·|o|, the margin alone."""
    T = rows.shape[0]
    sph, _, slack = sphere_split_ref(rows)
    rho = torch.where(torch.isfinite(slack), sph[:, 3] - slack, float("inf"))[:, None]
    pad = -T % CU.LEAF
    lo, hi = (torch.nn.functional.pad(x, (0, 0, 0, pad), value=fill).reshape(-1, CU.LEAF, 3)
              for x, fill in ((sph[:, :3] - rho, BIG), (sph[:, :3] + rho, -BIG)))
    lo, hi = lo.amin(1), hi.amax(1)
    tn, ok = CU.chunk_entry(lo, hi, o, d)
    return tn, ok & (lo[:, 0] <= hi[:, 0])[None]


def test_leaf_boxes_need_their_slack(monkeypatch):
    """ROADMAP C17: on ``hard_soup("corners")`` f32 rounding accepts hits
    just beyond a vertex that lies on its leaf's box, and a backstop
    behind each, met first, gives the ray a best t short of that box.
    Rule (d) with the kernels' leaf boxes (widened by the spheres' slack
    and grow·|o|) keeps every brute-force winner; with the boxes of the
    exact spheres it loses some, each a winner on a corner."""
    T = 704
    verts, rows, pos, dir_ = hard_soup("corners", T, R, seed=3)
    clo, chi = chunk_aabbs_padded(*verts, torch.ones(T, dtype=torch.bool), torch.arange(T), 128)
    slack = CU.chunk_slack(rows)
    live = torch.ones(R, dtype=torch.bool)
    t, i = _brute(rows, pos, dir_)
    out = CU.cull_visits(rows, clo, chi, slack, pos, dir_, live)
    assert torch.equal(out["idx"], i) and torch.equal(out["t"], t)
    monkeypatch.setattr(CU, "leaf_entry", _exact_sphere_leaf_entry)
    bare = CU.cull_visits(rows, clo, chi, slack, pos, dir_, live)
    lost = bare["idx"] != i
    assert lost.any()
    assert ((i[lost] // CU.LEAF) % 2 == 1).all()  # the corner leaves
    assert (bare["t"][lost] > t[lost]).all()


def test_warp_order_breaks_equal_t_ties_by_index():
    """On the tie soup most rays win on the square (indices < 64), whose
    exact copy lies in chunk 2 (indices 256..319), a box that the rays
    enter before chunk 0's: the warps visit chunk 2 first, find the copy,
    and the original still wins on its smaller index at the same t."""
    verts, rows, clo, chi, pos, dir_ = tie_soup(R=1024, seed=3)
    slack = CU.chunk_slack(rows)
    tn, ok = CU.chunk_entry(clo, chi, pos.T, dir_.T, slack)
    assert ok[:, [0, 2]].all() and (tn[:, 2] < tn[:, 0]).all()
    live = torch.ones(pos.shape[1], dtype=torch.bool)
    out = CU.cull_visits(rows, clo, chi, slack, pos, dir_, live)
    t, i = _brute(rows, pos, dir_)
    tied = (i >= 0) & (i < 64)
    assert tied.float().mean() > 0.9
    assert torch.equal(out["idx"], i) and torch.equal(out["t"], t)
    # The copy's t equals the original's: the index alone decides.
    t_copy, _ = _brute(rows[256:320].contiguous(), pos, dir_)
    assert torch.equal(t_copy[tied], t[tied])


def _glossy_waves():
    scene, camera = glossy.glossy_steps(width=64, height=48)
    config = TraceConfig(chunk_cull=True, ray_sort=True)
    tables = scene_tables(scene, config)
    Rc = 64 * 48
    pix = torch.arange(Rc)
    key = make_key(5)
    jx, jy = (stream_uniform(key, (1 << 30) + k, Rc, "cpu") * 2 - 1 for k in (0, 1))
    pos, dir_ = camera.generate_rays_soa(pix % 64, pix // 64, jx, jy, 64, 48)
    pos, dir_ = pos.contiguous(), dir_.contiguous()
    ones, live = torch.ones(3, Rc), torch.ones(Rc, dtype=torch.bool)
    u = [stream_uniform(key, s, Rc, "cpu") for s in (0, 1, 3)]
    out = F.mega_segment_ref(tables.rows, pos, dir_, ones, torch.zeros(3, Rc), live, *u,
                             torch.zeros(3, 1))
    alive = out[5] > 0
    keys = torch.where(alive, ray_sort_keys(out[1], out[2], tables.lo, tables.hi), DEAD_KEY)
    order = torch.argsort(keys, stable=True)
    bounce = (out[1][:, order].contiguous(), out[2][:, order].contiguous(), alive[order])
    return tables, [(pos, dir_, live), bounce]


def test_visit_counts_are_ordered_on_the_glossy_stage():
    tables, waves = _glossy_waves()
    nc = tables.clo.shape[0]
    for pos, dir_, live in waves:
        out = CU.cull_visits(tables.rows, tables.clo, tables.chi, tables.cslack, pos, dir_, live)
        t, i = _brute(tables.rows, pos, dir_)
        assert torch.equal(out["idx"], torch.where(live, i, -1))
        assert torch.equal(out["t"], torch.where(live, t, BIG))
        m = out["mean"]
        assert m["g"] <= m["f"] <= m["e"] <= m["c"] <= m["b"] <= m["a"] <= nc, m
        assert m["f"] <= m["d"] <= m["c"], m
        assert m["g"] < m["b"]  # the glossy stage is open: culling leaves chunks out
        assert 0 < out["leaves"] < CU.CHUNK // CU.LEAF * m["d"]  # and leaves inside them
        groups = -(-pos.shape[1] // 128)
        assert out["tested"].shape == (groups,) and (out["tested"] <= nc).all()


def test_records_hold_the_spheres_geometry_and_leaf_boxes():
    _, rows, _, _ = hard_soup("degenerate", 700, 8, seed=2)
    rows = torch.cat([rows, torch.zeros(68, 48)]).contiguous()  # padding to 768
    rows[32:64, :12] = 0.0  # whole leaves of all-zero rows only
    rec = CU.cull_records(rows)
    T = rows.shape[0]
    sph, grow, _ = sphere_split_ref(rows)
    zero = (rows[:, :12] == 0).all(dim=1)
    assert rec.shape == CU.records_shape(T) == (T + T // CU.LEAF, 16)
    assert rec.dtype == torch.float32
    tri, leaves = rec[:T], rec[T:]
    assert _same(tri[:, 4:], rows[:, :12])
    assert _same(tri[~zero, :4], sph[~zero])
    assert tri[zero, 0].isnan().all() and _same(tri[zero, 1:4], sph[zero, 1:4])
    slack = CU.chunk_slack(rows)
    per_chunk = torch.where(zero, 0.0, grow).reshape(-1, 128)
    assert (slack[:, 1:2] >= per_chunk).all() and torch.equal(slack[:, 1], per_chunk.amax(1))
    # Each leaf's box holds the spheres (at |o| = 0) of its rows that are not all zero.
    lo, hi = leaves[:, :3], leaves[:, 4:7]
    assert (leaves[:, [3, 7]] == 0).all() and (leaves[:, 8:] == 0).all()
    empty = slice(32 // CU.LEAF, 64 // CU.LEAF)
    assert (lo[empty] > hi[empty]).all()  # nothing but all-zero rows: an empty box
    assert torch.isinf(lo).any() and torch.isinf(hi).any()  # unbounded spheres: unbounded boxes
    c, K0 = sph[:, :3], sph[:, 3:]
    leaf = torch.arange(T) // CU.LEAF
    keep = ~zero
    assert ((c - K0)[keep] >= lo[leaf[keep]]).all() and ((c + K0)[keep] <= hi[leaf[keep]]).all()


def test_scene_tables_carry_the_records():
    scene, _ = glossy.glossy_steps(width=16, height=12)
    tables = scene_tables(scene, TraceConfig(chunk_cull=True))
    boxes = tables.cull_boxes
    assert set(boxes) == {"clo", "chi", "cslack", "crec"}
    assert torch.equal(boxes["crec"], CU.cull_records_ref(tables.rows.detach()))
    assert scene_tables(scene, TraceConfig()).crec is None
