"""The port's segment gradient against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy (those of
``tests/test_torch_segment.py``: R = 3000 rays in the Cornell box with
both spheres), go through the JAX functions (Pallas kernels in interpret
mode) and through the port's, which on CPU tensors are their plain
versions.

Tolerances (``montecarlopathtracer_tpu_torch.testing``):

- segment vjp (B2), plain vs JAX ``segment_backward``, on live lanes
  that hit: per output rtol = atol = 1e-5 of the output's max |ref|
  (``compare_grads``; measured: every lane within, max |err| 4e-3 on a
  d_full scale of 2e4);
- row scatter (B3), plain vs JAX ``scatter_rows(terms=3)``: rtol = atol
  = 1e-6 of the max (its 3-term bf16 split is exact to f32 rounding);
  vs ``.at[].add``: the same;
- the differentiable segment vs ``jax.grad`` through JAX's
  ``whole_segment_megakernel``: 1e-4 of the max for the row table (the
  JAX backward scatters with ``terms=2``, which drops the last 8
  mantissa bits of each cotangent), 1e-5 for the ray state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu.models import cornell as jcornell
from montecarlopathtracer_tpu.ops import intersect_pallas as JP
from montecarlopathtracer_tpu.ops import segment_fused as JF
from montecarlopathtracer_tpu.ops.intersect import triangle_transforms
from montecarlopathtracer_tpu_torch.ops import sampling
from montecarlopathtracer_tpu_torch.ops import scatter_rows as S
from montecarlopathtracer_tpu_torch.ops import segment_fused as F
from montecarlopathtracer_tpu_torch.testing import (
    SCATTER_ULPS,
    cap_torch_threads,
    compare_grads,
    compare_scatter,
)
from montecarlopathtracer_tpu_torch.utils import profiling
from test_torch_segment import CASES, T_CHUNK, _inputs, _kw

cap_torch_threads()

GRAD_CASES = dict(CASES, rr_tied_grey=CASES["rr_roulette"])


@pytest.fixture(scope="module")
def tables():
    js, _ = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True)
    m, m_a = triangle_transforms(*js.triangle_vertices())
    ws = JP.pack_transforms_stream(m, m_a, js.tri_valid, T_CHUNK)
    rows = np.asarray(JP.pack_rows_full(m, m_a, js, T_CHUNK))
    return ws, rows


def _case_inputs(case):
    x = _inputs(seed=len(case))
    if case == "rr_tied_grey":
        # Grey throughput, as after white-wall bounces: RR's p = max of
        # three equal channels, a tie on every lane.
        x["tput"] = np.full_like(x["tput"], 0.6)
    return x


def _torch(x):
    return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}


def _backward_inputs(rows, x, flags, kw, seed):
    """Winners from the port's forward, gathered rows, random cotangents."""
    t = _torch(x)
    idx = F.mega_segment(torch.from_numpy(rows.copy()), t["pos"], t["dir"], t["tput"],
                         t["res"], t["live"], t["u1"], t["u2"], t["urr"],
                         torch.from_numpy(flags), **kw)[0].numpy()
    full = np.ascontiguousarray(rows[np.maximum(idx, 0)].T)
    rs = np.random.RandomState(seed)
    cts = [rs.normal(size=(3, idx.shape[0])).astype(np.float32) for _ in range(4)]
    return idx, full, cts


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_segment_backward_matches_jax(tables, case):
    """B2's plain version against JAX ``segment_backward`` (interpret).

    ``rr_tied_grey`` fails on a port whose RR probability is
    ``tput.amax(dim=0)``: amax splits a tie's adjoint in thirds, JAX's
    nested ``jnp.maximum`` 0.25 / 0.25 / 0.5, so d_tput differs on every
    surviving lane."""
    _, rows = tables
    x = _case_inputs(case)
    kw = _kw(case if case != "rr_tied_grey" else "rr_roulette")
    flags = np.asarray(GRAD_CASES[case]["flags"], np.float32).reshape(3, 1)
    idx, full, cts = _backward_inputs(rows, x, flags, kw, seed=7)
    hit = idx >= 0
    want = JF.segment_backward(
        x["pos"], x["dir"], x["tput"], x["res"], jnp.asarray(x["live"]),
        jnp.asarray(hit), full, x["u1"], x["u2"], x["urr"], flags, *cts,
        interpret=True, **kw,
    )
    t = _torch(x)
    before = profiling.launches()
    got = F.segment_backward(
        t["pos"], t["dir"], t["tput"], t["res"], t["live"], torch.from_numpy(hit),
        torch.from_numpy(full), t["u1"], t["u2"], t["urr"], torch.from_numpy(flags),
        *map(torch.from_numpy, cts), **kw,
    )
    assert profiling.launches() - before == {}  # CPU tensors: plain version
    lanes = x["live"] & hit
    rep = compare_grads([np.asarray(w) for w in want], got, lanes=lanes)
    assert rep["ok"], rep
    assert all(s == 1.0 for s in rep["share_within"].values()), rep
    assert lanes.sum() > 0.5 * lanes.shape[0]
    if case in ("fixed", "rr_roulette", "rr_tied_grey", "phong_reflect"):
        # The geometry takes a gradient through the surviving lanes.
        assert np.abs(got[4][:12].numpy()).max() > 0.0


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_segment_backward_rows_plain_path_is_the_gathered_one(tables, case):
    """B2 through the index, on CPU tensors: exactly
    ``segment_backward_ref`` on the gathered rows (a lane in seven made a
    miss on top of the wavefront's own), and no launch counted."""
    _, rows = tables
    x = _case_inputs(case)
    kw = _kw(case if case != "rr_tied_grey" else "rr_roulette")
    flags = np.asarray(GRAD_CASES[case]["flags"], np.float32).reshape(3, 1)
    idx, _, cts = _backward_inputs(rows, x, flags, kw, seed=7)
    idx[::7] = -1
    t = _torch(x)
    state = (t["pos"], t["dir"], t["tput"], t["res"], t["live"])
    rest = (t["u1"], t["u2"], t["urr"], torch.from_numpy(flags), *map(torch.from_numpy, cts))
    before = profiling.launches()
    got = F.segment_backward_rows(*state, torch.from_numpy(rows), torch.from_numpy(idx), *rest,
                                  **kw)
    assert profiling.launches() - before == {}
    full = np.ascontiguousarray(rows[np.maximum(idx, 0)].T)
    want = F.segment_backward_ref(*state, torch.from_numpy(idx >= 0), torch.from_numpy(full),
                                  *rest, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case != "rr_hard_kill":  # a hard kill ends every lane: no row takes a cotangent
        assert np.abs(got[4].numpy()).max() > 0.0


def test_compare_scatter_holds_each_row_to_its_own_scale():
    """A row of huge cotangents (a shading frame near ±Y) does not widen
    the tolerance of the other rows: the same adds summed in another
    order pass, one lost add into a small row fails, though it is far
    inside 1e-5 of the table's largest entry."""
    rs = np.random.RandomState(7)
    T, R = 64, 20_000
    idx = torch.from_numpy(rs.randint(-1, T, size=R).astype(np.int32))
    dvals = torch.from_numpy(rs.normal(size=(48, R)).astype(np.float32))
    dvals[:, idx == 3] *= 1e6
    want = S.scatter_rows_ref(idx, dvals, T)
    bound = S.scatter_rows_ref(idx, dvals.abs(), T)
    rev = torch.flip(torch.arange(R), (0,))
    other_order = S.scatter_rows_ref(idx[rev], dvals[:, rev].contiguous(), T)
    rep = compare_scatter(want, other_order, bound)
    assert rep["ok"] and 0 < rep["worst_ulps"] <= SCATTER_ULPS, rep
    lost = idx.clone()
    lost[int(torch.nonzero(idx == 9)[0])] = -1
    dropped = S.scatter_rows_ref(lost, dvals, T)
    assert not compare_scatter(want, dropped, bound)["ok"]
    scale = float(want.abs().max())
    assert torch.allclose(dropped, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("T", [256, 300])
def test_scatter_rows_matches_jax(T):
    rs = np.random.RandomState(T)
    R = 3000
    idx = rs.randint(-1, T, size=R).astype(np.int32)
    idx[:700] = 5  # a hot row, as a wall triangle under many rays
    idx[700:900] = -1
    dvals = rs.normal(size=(48, R)).astype(np.float32)
    before = profiling.launches()
    got = S.scatter_rows(torch.from_numpy(idx), torch.from_numpy(dvals), T).numpy()
    assert profiling.launches() - before == {}
    assert got.shape == (T, 48)
    at_add = np.asarray(jnp.zeros((T, 48)).at[jnp.maximum(idx, 0)].add(
        jnp.where(jnp.asarray(idx >= 0)[:, None], dvals.T, 0.0)))
    scale = np.abs(at_add).max()
    np.testing.assert_allclose(got, at_add, rtol=1e-6, atol=1e-6 * scale)
    if T % 128 == 0:  # the Pallas kernel takes lane-padded tables only
        pallas = np.asarray(JP.scatter_rows(jnp.asarray(idx), jnp.asarray(dvals), T,
                                            interpret=True, terms=3))
        np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6 * scale)


def test_scatter_rows_path_follows_from_the_shape_alone():
    """Which of B3's paths a call takes follows from T alone, and the small
    path's grid and workspace from (R, T) alone: pure functions of two
    integers, so a CUDA graph's replay takes the path its capture took.
    At least the published Cornell box's 32 rows take the small path; the
    T = 652 scene and the bunny keep the sort."""
    Ts = (1, 3, 32, S.T_SMALL, S.T_SMALL + 1, 652, 81_932)
    assert [S.small_path(T) for T in Ts] == [True] * 4 + [False] * 3
    assert 32 <= S.T_SMALL <= 128  # the kernel's bins fit up to 128 rows
    grids = {0: 1, 1: 1, 32: 1, 33: 2, 37: 2, 4191: 131, 4192: 131, 4193: 132,
             8193: 132, 480_000: 132, 2**31 - 1: 132}
    assert {R: S.small_grid(R) for R in grids} == grids
    for R in grids:
        for T in (1, 3, 32, S.T_SMALL):
            size = S.small_workspace(R, T)
            assert size == S.small_workspace(R, T) == grids[R] * T * 48 * 8
    assert S.small_workspace(480_000, 32) == 1_622_016


def test_whole_segment_gradients_match_jax(tables):
    """One differentiable segment: ``torch.autograd`` through
    ``WholeSegment`` against ``jax.grad`` through JAX's
    ``whole_segment_megakernel`` (interpret), for a random linear loss of
    the four outputs, on lanes (and rows) whose winners agree."""
    ws, rows = tables
    x = _inputs(seed=11)
    kw = _kw("fixed")
    flags = np.zeros((3, 1), np.float32)
    R = x["pos"].shape[1]
    wts = [np.random.RandomState(20 + k).normal(size=(3, R)).astype(np.float32)
           for k in range(4)]

    def jloss(rows_, pos, dir_, tput, res):
        out = JF.whole_segment_megakernel(
            ws, rows_, pos, dir_, tput, res, jnp.asarray(x["live"]), x["u1"], x["u2"],
            x["urr"], flags, t_chunk=T_CHUNK, interpret=True, **kw)
        return sum(jnp.sum(w * o) for w, o in zip(wts, out[1:5])), out[0]

    (_, jidx), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        rows, x["pos"], x["dir"], x["tput"], x["res"])
    t = _torch(x)
    xs = [torch.from_numpy(a.copy()).requires_grad_(True)
          for a in (rows, x["pos"], x["dir"], x["tput"], x["res"])]
    out = F.whole_segment_megakernel(xs[0], *xs[1:], t["live"], t["u1"], t["u2"],
                                     t["urr"], torch.from_numpy(flags), **kw)
    sum((torch.from_numpy(w) * o).sum() for w, o in zip(wts, out[1:5])).backward()
    idx, jidx = out[0].numpy(), np.asarray(jidx)
    # JAX leaves a lane that is not live its winner; the segment passes
    # such a lane through on both sides.
    same = (idx == jidx) | ~x["live"]
    assert same.mean() > 0.999
    jg = [np.asarray(g) for g in jg]
    for k in range(1, 5):  # ray state, on agreeing lanes
        w, g = jg[k][:, same], xs[k].grad.numpy()[:, same]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    touched = np.unique(np.concatenate([idx[~same], jidx[~same]]))
    keep = np.setdiff1d(np.arange(rows.shape[0]), touched)
    w, g = jg[0][keep], xs[0].grad.numpy()[keep]
    assert np.abs(g[:, :12]).max() > 0.0  # geometry gradient reaches the table
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_lobe_adjoint_finite_where_cos_is_one():
    """u1 = 1 − 2⁻²⁴ with Ns = 1000 rounds cosθ to exactly 1; the guarded
    sqrt gives sinθ's adjoint 0 there, not ∞ (0·∞ = NaN)."""
    u1 = torch.tensor([1.0 - 2.0**-24, 0.5])
    ns = torch.tensor([1000.0, 1000.0], requires_grad=True)
    local = sampling._lobe(u1, torch.tensor([0.3, 0.3]), ns)
    assert local[1, 0].item() == 1.0 and local[0, 0].item() == 0.0
    local.sum().backward()
    assert torch.isfinite(ns.grad).all(), ns.grad


def test_segment_backward_no_nan_on_mirror_with_cos_one(tables):
    """Whole segment: every lane forced to u1 = 1 − 2⁻²⁴, cotangents on
    the throughput and result only (the geometry's are zero, as in a
    render whose radiance does not depend on positions): all gradients
    finite, the geometry's exactly zero."""
    _, rows = tables
    x = _inputs(seed=3)
    x["u1"] = np.full_like(x["u1"], 1.0 - 2.0**-24)
    kw = _kw("fixed")
    flags = np.zeros((3, 1), np.float32)
    idx, full, cts = _backward_inputs(rows, x, flags, kw, seed=9)
    assert (full[30][idx >= 0] == 1000.0).sum() > 10  # mirror hits (Ns = 1000)
    cts[0][:] = 0.0
    cts[1][:] = 0.0
    t = _torch(x)
    got = F.segment_backward(
        t["pos"], t["dir"], t["tput"], t["res"], t["live"], torch.from_numpy(idx >= 0),
        torch.from_numpy(full), t["u1"], t["u2"], t["urr"], torch.from_numpy(flags),
        *map(torch.from_numpy, cts), **kw,
    )
    for g in got:
        assert torch.isfinite(g).all()
    assert got[4][:21].abs().max() == 0.0  # geometry and shading normals
    assert got[4][24:30].abs().max() > 0.0  # albedos take the throughput's


def test_wrappers_refuse_other_devices():
    x = torch.empty(3, 4, device="meta")
    m = torch.empty(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="device"):
        F.segment_backward(x, x, x, x, m, m, torch.empty(48, 4, device="meta"), x[0],
                           x[0], x[0], torch.empty(3, 1, device="meta"), x, x, x, x)
    with pytest.raises(ValueError, match="device"):
        F.segment_backward_rows(x, x, x, x, m, torch.empty(8, 48, device="meta"),
                                torch.empty(4, dtype=torch.int32, device="meta"), x[0], x[0],
                                x[0], torch.empty(3, 1, device="meta"), x, x, x, x)
    with pytest.raises(ValueError, match="device"):
        S.scatter_rows(torch.empty(4, dtype=torch.int32, device="meta"),
                       torch.empty(48, 4, device="meta"), 8)
    with pytest.raises(ValueError, match="mode"):
        F.whole_segment_megakernel(x, x, x, x, x, m, x[0], x[0], x[0], x, mode="bogus")
