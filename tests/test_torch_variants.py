"""The superseded selection entries (B8-B11) of the port against the JAX
package's, on the CPU.

- Packers: ``pack_transforms``, ``pack_transforms_fused``,
  ``pack_transforms_stream`` and ``pack_shading_table`` bit-equal to
  JAX's through numpy.
- Entries: the port's ``nearest_shade``, ``nearest_shade2``,
  ``nearest_shade_streamed`` (with and without cull) and
  ``nearest_shade_culled`` (their plain versions on CPU tensors) against
  JAX's in interpret mode, on the Cornell box with both spheres (768
  triangles with the JAX padding) and on a random soup of 384 triangles,
  1,000 rays with ~10% dead lanes. Winners: ``testing.compare_shade``
  (equal on ≥ 99.9% of live lanes, every mismatch a near-tie, a miss on
  both sides or neither) with t, β, γ to rtol = atol = 1e-5 on agreeing
  lanes (JAX recomputes them in exact f32 too) and equal shading rows.
  JAX's v1 and v2 kernels choose by an approximate reciprocal (3.9e-3
  relative in interpret mode): there, up to 1% of lanes may instead hold
  another hit whose float64 distance is within 4e-3 of JAX's winner's.
  The culling entries' indices, mapped through the Morton permutation,
  equal the unculled entry's.
- ``refine_winner_soa`` against JAX ``_refine_winner_soa`` at the same
  winners, to 1e-6.
- ``tile_boxes`` regrids chunk boxes of 128, 256 and 384 triangles to
  B4c's 128-triangle tiles: each tile's box is exactly the union of the
  boxes of its triangles.
- The ``kernel_bench`` twin runs on the CPU (plain versions), prints one
  JSON line per entry and hands a caller its outputs, which equal a fresh
  call's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu.models import cornell as jcornell
from montecarlopathtracer_tpu.ops import intersect_pallas as JP
from montecarlopathtracer_tpu.ops.intersect import triangle_transforms
from montecarlopathtracer_tpu_torch import convert
from montecarlopathtracer_tpu_torch.ops import nearest_variants as NV
from montecarlopathtracer_tpu_torch.tools import kernel_bench
from montecarlopathtracer_tpu_torch.testing import _hit64, compare_shade

R = 1000
# JAX's v1 and v2 selection kernels rank hits by t = tw · rcp(w², approx),
# a reciprocal good to 3.9e-3 relative in interpret mode: their winner may
# be any hit within that share of the nearest one's distance.
RCP_APPROX = 4e-3


def _rays(seed, lo, hi, eye):
    """Half camera rays from ``eye`` into the box [lo, hi], half rays
    from inside the box in random directions; ~10% of lanes dead."""
    rs = np.random.RandomState(seed)
    h = R // 2
    pos = np.empty((3, R), np.float32)
    dirs = np.empty((3, R), np.float32)
    pos[:, :h] = np.asarray(eye, np.float32)[:, None]
    dirs[:, :h] = rs.uniform(lo, hi, (h, 3)).T - pos[:, :h]
    pos[:, h:] = rs.uniform(lo + 0.1, hi - 0.1, (R - h, 3)).T
    dirs[:, h:] = rs.normal(size=(3, R - h))
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    return pos, dirs, rs.uniform(size=R) > 0.1


def _soup(seed=3, T=384):
    """A random triangle soup in [-4, 4]^3 (every triangle valid)."""
    rs = np.random.RandomState(seed)
    cen = rs.uniform(-4, 4, (T, 1, 3))
    tri = (cen + rs.normal(scale=0.8, size=(T, 3, 3))).astype(np.float32)
    return tri[:, 0], tri[:, 1], tri[:, 2]


@pytest.fixture(scope="module", params=["cornell", "soup"])
def case(request):
    """(name, JAX inputs, port tensors, rays) for one scene."""
    if request.param == "cornell":
        js, _ = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True)
        a, b, c = (np.asarray(x) for x in js.triangle_vertices())
        valid = np.asarray(js.tri_valid)
        table = np.asarray(JP.pack_shading_table(js))
        port_table = NV.pack_shading_table(convert.scene_from_numpy(
            {f: np.asarray(getattr(js, f)) for f in convert.FIELDS}))
        assert np.array_equal(port_table.numpy(), table)
        rays = _rays(1, np.array([-6.0, 0.0, -6.0]), np.array([6.0, 10.0, 6.0]), [0, 5, 17])
    else:
        a, b, c = _soup()
        valid = np.ones(a.shape[0], bool)
        table = np.random.RandomState(4).uniform(size=(a.shape[0], 32)).astype(np.float32)
        rays = _rays(2, np.full(3, -4.0), np.full(3, 4.0), [0, 0, 12])
    m, m_a = triangle_transforms(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    tm, tma = torch.tensor(np.asarray(m)), torch.tensor(np.asarray(m_a))
    perm = np.asarray(JP.morton_order(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                                      jnp.asarray(valid)))
    j = dict(a=jnp.asarray(a), b=jnp.asarray(b), c=jnp.asarray(c), valid=jnp.asarray(valid),
             m=m, m_a=m_a, table=jnp.asarray(table), perm=jnp.asarray(perm))
    t = dict(m=tm, m_a=tma, valid=torch.tensor(valid), table=torch.tensor(table),
             perm=torch.tensor(perm).long())
    return request.param, j, t, rays


def _port_rays(rays):
    pos, dirs, live = rays
    return torch.tensor(pos), torch.tensor(dirs), torch.tensor(live)


def _check(got, want, rows, rays, live=None, t_rtol=None):
    """``compare_shade`` on the live lanes. With ``t_rtol``, JAX's
    selection ranks hits by an approximate t: lanes whose two winners
    both hit at float64 distances within ``t_rtol`` of each other (at
    most 1% of them) are checked so and then left out."""
    pos, dirs, lv = rays
    live = lv if live is None else live
    want = tuple(map(np.asarray, want))
    g, w = got[0].numpy()[live], want[0][live]
    assert np.array_equal(g < 0, w < 0)  # miss status
    assert 0.3 < (g >= 0).mean() <= 1.0
    if t_rtol is not None:
        diff = live & (got[0].numpy() != want[0])
        ta, _ = _hit64(rows, pos[:, diff], dirs[:, diff], got[0].numpy()[diff])
        tb, _ = _hit64(rows, pos[:, diff], dirs[:, diff], want[0][diff])
        assert diff.sum() <= 0.01 * live.sum()
        assert (np.abs(ta - tb) <= t_rtol * np.abs(tb)).all(), (ta, tb)
        keep = torch.from_numpy(~diff)
        got = tuple(torch.where(keep, x, y) for x, y in
                    zip(got, (torch.from_numpy(y.copy()) for y in want)))
    rep = compare_shade(got, want, live=live, rows=rows, pos=pos, dir_=dirs)
    assert rep["ok"], rep
    return rep


@pytest.mark.parametrize("what", ["w", "wf", "ws", "ws_pad"])
def test_packers_bit_equal_to_jax(case, what):
    _, j, t, _ = case
    T = j["m"].shape[0]
    tc = 128
    if what == "w":
        want = JP.pack_transforms(j["m"], j["m_a"], j["valid"])
        got = NV.pack_transforms(t["m"], t["m_a"], t["valid"])
    elif what == "wf":
        tc = JP._divisor_chunk(T, JP._T_CHUNK)
        want = JP.pack_transforms_fused(j["m"], j["m_a"], j["valid"], tc)
        got = NV.pack_transforms_fused(t["m"], t["m_a"], t["valid"], tc)
        assert tc == NV.divisor_chunk(T, NV.T_CHUNK)
    else:
        pad_to = 512 if what == "ws_pad" else 0
        want = JP.pack_transforms_stream(j["m"], j["m_a"], j["valid"], 256, pad_to)
        got = NV.pack_transforms_stream(t["m"], t["m_a"], t["valid"], 256, pad_to)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), np.asarray(want))


def _rows_of(w, table):
    return NV._rows(NV._geometry(w), table).numpy()


def test_nearest_shade_v1_matches_jax(case):
    _, j, t, rays = case
    w = NV.pack_transforms(t["m"], t["m_a"], t["valid"])
    pos, dirs, _ = rays
    want = JP.nearest_shade(JP.pack_transforms(j["m"], j["m_a"], j["valid"]), j["table"],
                            jnp.asarray(pos), jnp.asarray(dirs), interpret=True)
    p, d, _ = _port_rays(rays)
    before = NV.nearest_shade.launches
    got = NV.nearest_shade(w, t["table"], p, d)
    assert NV.nearest_shade.launches == before  # CPU tensors: the plain version
    assert got[0].dtype == torch.int32 and got[1].shape == (4, R) and got[2].shape == (32, R)
    _check(got, want, _rows_of(w, t["table"]), rays, live=np.ones(R, bool), t_rtol=RCP_APPROX)


def test_nearest_shade2_matches_jax(case):
    _, j, t, rays = case
    T = j["m"].shape[0]
    tc = NV.divisor_chunk(T, NV.T_CHUNK)
    pos, dirs, _ = rays
    geom = JP.pack_geom_rows(j["m"], j["m_a"])
    want = JP.nearest_shade2(JP.pack_transforms_fused(j["m"], j["m_a"], j["valid"], tc), geom,
                             j["table"], jnp.asarray(pos), jnp.asarray(dirs), t_chunk=tc,
                             interpret=True)
    wf = NV.pack_transforms_fused(t["m"], t["m_a"], t["valid"], tc)
    p, d, _ = _port_rays(rays)
    got = NV.nearest_shade2(wf, torch.tensor(np.asarray(geom)), t["table"], p, d, t_chunk=tc)
    _check(got, want, _rows_of(NV._unfuse(wf, tc), t["table"]), rays, live=np.ones(R, bool),
           t_rtol=RCP_APPROX)


@pytest.mark.parametrize("t_chunk", [128, 256])
def test_nearest_shade_streamed_matches_jax(case, t_chunk):
    _, j, t, rays = case
    pos, dirs, live = rays
    geom = JP.pack_geom_rows(j["m"], j["m_a"])
    want = JP.nearest_shade_streamed(
        JP.pack_transforms_stream(j["m"], j["m_a"], j["valid"], t_chunk), geom, j["table"],
        jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(live), t_chunk=t_chunk,
        interpret=True)
    ws = NV.pack_transforms_stream(t["m"], t["m_a"], t["valid"], t_chunk)
    p, d, lv = _port_rays(rays)
    got = NV.nearest_shade_streamed(ws, torch.tensor(np.asarray(geom)), t["table"], p, d, lv,
                                    t_chunk=t_chunk)
    _check(got, want, _rows_of(NV._unstream(ws, t_chunk), t["table"]), rays)
    assert (got[0].numpy()[~live] == -1).all()  # B4's contract for lanes not live


def _culled_inputs(j, t):
    """The permutation and the shading tables in Morton order."""
    perm_j, perm_t = j["perm"], t["perm"]
    return perm_j, perm_t, (j["table"][perm_j], t["table"][perm_t].contiguous())


def test_nearest_shade_streamed_cull_matches_jax_and_unculled(case):
    _, j, t, rays = case
    pos, dirs, live = rays
    perm_j, perm_t, (tab_j, tab_t) = _culled_inputs(j, t)
    ws_j = JP.pack_transforms_stream(j["m"][perm_j], j["m_a"][perm_j], j["valid"][perm_j], 128)
    geom_j = JP.pack_geom_rows(j["m"][perm_j], j["m_a"][perm_j])
    clo_j, chi_j = JP.chunk_aabbs_padded(j["a"], j["b"], j["c"], j["valid"], perm_j, 128)
    want = JP.nearest_shade_streamed(ws_j, geom_j, tab_j, jnp.asarray(pos), jnp.asarray(dirs),
                                     jnp.asarray(live), clo_j, chi_j, t_chunk=128, cull=True,
                                     interpret=True)
    ws = NV.pack_transforms_stream(t["m"][perm_t], t["m_a"][perm_t], t["valid"][perm_t], 128)
    assert np.array_equal(ws.numpy(), np.asarray(ws_j))
    p, d, lv = _port_rays(rays)
    clo, chi = (torch.tensor(np.asarray(x)) for x in (clo_j, chi_j))
    got = NV.nearest_shade_streamed(ws, torch.tensor(np.asarray(geom_j)), tab_t, p, d, lv,
                                    clo, chi, t_chunk=128, cull=True)
    _check(got, want, _rows_of(NV._unstream(ws, 128), tab_t), rays)
    # Mapped through the permutation, the unculled entry's winners.
    flat = NV.nearest_shade_streamed(
        NV.pack_transforms_stream(t["m"], t["m_a"], t["valid"], 128),
        torch.zeros(t["table"].shape[0], 12), t["table"], p, d, lv, t_chunk=128)
    idx = got[0].long()
    mapped = torch.where(idx >= 0, t["perm"][idx.clamp_min(0)], -1)
    assert torch.equal(mapped[lv], flat[0].long()[lv])


def test_nearest_shade_culled_matches_jax_and_unculled(case):
    name, j, t, rays = case
    pos, dirs, live = rays
    chunk = 256 if name == "cornell" else 128  # JAX's default chunk, and the tpu_check one
    perm_j, perm_t, (tab_j, tab_t) = _culled_inputs(j, t)
    w_j = JP.pack_transforms(j["m"][perm_j], j["m_a"][perm_j], j["valid"][perm_j])
    clo_j, chi_j = JP.chunk_aabbs(j["a"], j["b"], j["c"], j["valid"], perm_j, chunk)
    want = JP.nearest_shade_culled(w_j, tab_j, clo_j, chi_j, jnp.asarray(pos),
                                   jnp.asarray(dirs), jnp.asarray(live), t_chunk=chunk,
                                   interpret=True)
    w = NV.pack_transforms(t["m"][perm_t], t["m_a"][perm_t], t["valid"][perm_t])
    p, d, lv = _port_rays(rays)
    clo, chi = (torch.tensor(np.asarray(x)) for x in (clo_j, chi_j))
    before = NV.nearest_shade_culled.launches
    got = NV.nearest_shade_culled(w, tab_t, clo, chi, p, d, lv)
    assert NV.nearest_shade_culled.launches == before
    _check(got, want, _rows_of(w, tab_t), rays)
    flat = NV.nearest_shade(NV.pack_transforms(t["m"], t["m_a"], t["valid"]), t["table"],
                            p, d)
    idx = got[0].long()
    mapped = torch.where(idx >= 0, t["perm"][idx.clamp_min(0)], -1)
    assert torch.equal(mapped[lv], flat[0].long()[lv])
    assert (got[0].numpy()[~live] == -1).all()


def test_refine_winner_soa_matches_jax(case):
    _, j, t, rays = case
    pos, dirs, _ = rays
    p, d, _ = _port_rays(rays)
    w = NV.pack_transforms(t["m"], t["m_a"], t["valid"])
    idx = NV.nearest_shade(w, t["table"], p, d)[0]
    geom = NV._geometry(w).contiguous()
    tbg, shade = NV.refine_winner_soa(geom, t["table"], idx, p, d)
    rays_soa = JP._soa_rays(jnp.asarray(pos), jnp.asarray(dirs), R)
    want_tbg, want_shade = JP._refine_winner_soa(jnp.asarray(geom.numpy()), j["table"],
                                                 jnp.asarray(idx.numpy()), rays_soa)
    np.testing.assert_allclose(tbg.numpy(), np.asarray(want_tbg), rtol=1e-6, atol=1e-6)
    assert np.array_equal(shade.numpy(), np.asarray(want_shade))
    # The entries' own values are the refinement's at their winners.
    got = NV.nearest_shade(w, t["table"], p, d)
    np.testing.assert_allclose(got[1].numpy(), tbg.numpy(), rtol=1e-5, atol=1e-5)


def test_entries_refuse_bad_layouts():
    m = torch.eye(3).expand(256, 3, 3).contiguous()
    m_a = torch.zeros(256, 3)
    valid = torch.ones(256, dtype=torch.bool)
    table = torch.zeros(256, 32)
    p, d = torch.zeros(3, 4), torch.ones(3, 4)
    ws = NV.pack_transforms_stream(m, m_a, valid, 128)
    with pytest.raises(ValueError, match="t_chunk"):
        NV.nearest_shade_streamed(ws, torch.zeros(256, 12), table, p, d, t_chunk=96)
    with pytest.raises(ValueError, match="chunk boxes"):
        NV.nearest_shade_streamed(ws, torch.zeros(256, 12), table, p, d, t_chunk=128,
                                  cull=True)
    with pytest.raises(ValueError, match="geom"):
        NV.nearest_shade2(NV.pack_transforms_fused(m, m_a, valid, 128), torch.zeros(255, 12),
                          table, p, d, t_chunk=128)
    with pytest.raises(ValueError, match="divide"):
        NV.nearest_shade_culled(NV.pack_transforms(m, m_a, valid), table, torch.zeros(3, 3),
                                torch.zeros(3, 3), p, d, torch.ones(4, dtype=torch.bool))


@pytest.mark.parametrize("box", [128, 256, 384])
def test_tile_boxes_is_the_union_of_overlapping_boxes(box):
    T = 768 + 64  # the last tile and the last box are partial
    rs = np.random.RandomState(box)
    nb = -(-T // box)
    lo = torch.tensor(rs.uniform(-5, 0, (nb + 2, 3)).astype(np.float32))  # spare boxes
    hi = lo + torch.tensor(rs.uniform(0, 5, (nb + 2, 3)).astype(np.float32))
    got_lo, got_hi = NV.tile_boxes(lo, hi, box, T)
    assert got_lo.shape == got_hi.shape == (-(-T // 128), 3)
    for k in range(got_lo.shape[0]):
        js = range(128 * k // box, (min(128 * k + 128, T) - 1) // box + 1)
        assert torch.equal(got_lo[k], lo[list(js)].amin(0))
        assert torch.equal(got_hi[k], hi[list(js)].amax(0))


def test_kernel_bench_tool_runs_on_cpu(capsys):
    assert kernel_bench.main(["--rays", "64", "--iters", "1", "--skip-large",
                              "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["kernel"] for r in rows] == ["v1", "v2", "v3", "v3_cull_tc128"]
    assert all(r["scene"] == "cornell" and r["T"] == 768 and r["ms"] > 0 for r in rows)
    assert kernel_bench.main(["--iters", "0", "--device", "cpu"]) == 2


def test_kernel_bench_keeps_its_outputs_on_cpu():
    keep = {}
    kernel_bench.run(rays=64, iters=2, skip_large=True, device="cpu", keep=keep)
    k = keep["cornell"]
    assert k["pos3"].shape == (3, 64) and k["scene"].num_triangles == 768
    flat = k["out"]["v1"][0].long()
    assert (flat >= 0).any()
    for kernel, call in k["calls"].items():
        again = call(k["pos3"], k["dir3"])
        assert all(torch.equal(a, b) for a, b in zip(k["out"][kernel], again)), kernel
    assert all(torch.equal(k["out"][v][0], k["out"]["v1"][0]) for v in ("v2", "v3"))
