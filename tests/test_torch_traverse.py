"""The port's large-scene path against the JAX package's, on the CPU.

- The procedural bunny (``models/bunny.py``): every field and the camera
  equal to the JAX package's (its first T triangles).
- Morton helpers (``ops/morton.py``): bit-equal to the JAX package's on
  a subdiv-3 bunny (the port's pack is not padded to 128 triangles, so
  the first T entries are compared).
- ``tile_chunk_order``: equal to JAX's (no lane groups), and
  conservative: every chunk that holds a live ray's nearest hit is in its
  tile's list, with tmin at most the hit distance + 1e-4.
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
    compare_images,
    compare_param_grads,
    compare_segment,
    compare_winners,
)
from montecarlopathtracer_tpu_torch.utils.image import load_png

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
    before = TW.traverse_select.launches
    got = TW.traverse_select(rows, clo, chi, torch.from_numpy(pos),
                             torch.from_numpy(dirs), torch.from_numpy(live)).numpy()
    assert TW.traverse_select.launches == before  # CPU tensors: the plain version
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
    before = F.rows_segment.launches
    got = F.rows_segment(rows, idx, p, d, t["tput"], t["res"], lv, t["u1"], t["u2"],
                         t["urr"], torch.from_numpy(flags), **kw)
    assert F.rows_segment.launches == before
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
