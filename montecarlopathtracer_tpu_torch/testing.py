"""Agreement checks between two runs of one path segment or frame.

Used by the tests (the port against the JAX package) and by
``chip_smoke.py`` (the CUDA kernel against its plain-torch version).
Two correct implementations that round differently may pick different
winners for a ray that grazes a triangle edge or meets two triangles at
the same distance; :func:`compare_segment` allows those near-ties on a
small share of lanes and holds every other output to a tolerance, with
the same small share of ill-conditioned lanes held to a looser one.
:func:`compare_winners` holds the traversal walk's winners to brute
selection's with the same near-tie allowance, and :func:`compare_shade`
the split path's intersector outputs.
:func:`compare_images` holds whole frames to a pixel share.
:func:`compare_grads` holds the cotangents of one segment's vjp,
:func:`compare_scatter` the row scatter's table, and
:func:`compare_param_grads` the parameter gradients of a whole render,
and :func:`compare_micro` the selection microkernel B12's tensor-core
results by a rounding rule. :func:`plain_kernels` routes every kernel
wrapper to its plain version, so that a path can run plain on the card.
:func:`tie_soup` builds a table whose winners tie at equal t across
chunks, in the order that the traversal walk visits them, and
:func:`hard_soup` seeded soups whose rays aim at triangle edges (or, in
its "corners" case, just beyond vertices). :func:`cap_torch_threads`
shares the CPUs between the workers of a parallel test run.
:func:`nan_trap` raises at the first operation that makes a NaN, the
counterpart of ``jax_debug_nans``. :func:`program_spans` reads the
program's spans out of a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np

SEGMENT_OUTPUTS = ("idx", "npos", "ndir", "ntput", "nres", "still")
MIN_IDX_AGREEMENT = 0.999  # share of live lanes whose winners must agree
MAX_OUTLIER_SHARE = 1e-3  # share of compared lanes allowed beyond `tol`
OUTLIER_TOL = 1e-2  # rtol = atol bound that no compared lane may exceed
# Frames: a pixel moves only where its path takes another turn.
MIN_PIXEL_SHARE, PIXEL_ATOL, MEAN_RTOL = 0.99, 1e-4, 1e-3
# Gradients: per output, |got - want| <= GRAD_TOL * (|want| + max |want|)
# on all but MAX_OUTLIER_SHARE of the compared lanes, and within
# OUTLIER_TOL of the same scale on every lane.
GRAD_OUTPUTS = ("d_pos", "d_dir", "d_tput", "d_res", "d_full")
GRAD_TOL = 1e-5
# Row scatter: |got - want| <= SCATTER_ULPS * eps32 * (scatter of |dvals|)
# per entry (compare_scatter).
SCATTER_ULPS = 16
# Split intersector: t, β and γ beyond `tol` of the other side must lie
# within SHADE_ULPS * eps32 * (their rounding scale) of the float64 value
# (compare_shade).
SHADE_ULPS = 16
# Selection microkernel B12 (compare_micro): its tensor-core sums of 48
# products may each be off by MICRO_ADDEND_ULPS f32 ulps (2^-23) per
# addend of the largest sum of |products| of the ray.
MICRO_ADDEND_ULPS = 2
EPS32 = float(np.finfo(np.float32).eps)
# Near-tie bounds, in float64 on the f32 rows: accept margins this close
# to 0 flip under f32 rounding, and so do distances this close together.
_MARGIN_TIE = 1e-5
_T_TIE = 1e-4


def cap_torch_threads() -> None:
    """Under pytest-xdist (``PYTEST_XDIST_WORKER_COUNT`` set), give this
    worker's torch its share of the CPUs it may run on, at least one
    thread: n workers each at torch's default of one thread per CPU run
    the small ops of the CPU emulations two orders of magnitude slower
    than one worker alone. Elsewhere it does nothing. A test module calls
    it once, at import; the count then holds for the whole process."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return
    import torch

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(workers)))


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _winner64(rows, pos, dir_, idx):
    """(t, β, γ) of triangle ``idx`` per lane in float64, f64[3, R], and
    their rounding scales f64[3, R]: the sums of the magnitudes that f32
    arithmetic rounds on the way to each (a product or sum of terms of
    size s is off by about eps32 * s), so that |f32 − f64| is a few eps32
    times the scale."""
    g = rows[np.maximum(idx, 0), 0:12].astype(np.float64).reshape(-1, 3, 4)
    o = pos.T.astype(np.float64)
    d = dir_.T.astype(np.float64)
    go, gd = g[:, :, :3] * o[:, None, :], g[:, :, :3] * d[:, None, :]
    op, dp = go.sum(axis=2) + g[:, :, 3], gd.sum(axis=2)
    op_abs, dp_abs = np.abs(go).sum(axis=2) + np.abs(g[:, :, 3]), np.abs(gd).sum(axis=2)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -op[:, 2] / dp[:, 2]
        s_t = np.abs(t) + (op_abs[:, 2] + np.abs(t) * dp_abs[:, 2]) / np.abs(dp[:, 2])
        beta = op[:, 0] + t * dp[:, 0]
        gamma = op[:, 1] + t * dp[:, 1]
        s_b, s_g = (op_abs[:, k] + np.abs(t) * dp_abs[:, k] + np.abs(dp[:, k]) * s_t
                    for k in (0, 1))
    return np.stack([t, beta, gamma]), np.stack([s_t, s_b, s_g])


def _hit64(rows, pos, dir_, idx):
    """(t, accept margin min(β, γ, 1-β-γ)) of triangle ``idx`` per lane,
    in float64; NaN where idx < 0."""
    (t, beta, gamma), _ = _winner64(rows, pos, dir_, idx)
    margin = np.minimum(np.minimum(beta, gamma), 1.0 - beta - gamma)
    bad = idx < 0
    return np.where(bad, np.nan, t), np.where(bad, np.nan, margin)


def near_ties(rows, pos, dir_, idx_a, idx_b) -> np.ndarray:
    """bool per lane: the two winners are a near-tie (a shared distance,
    or a winner or runner-up accepted by a margin within rounding)."""
    ta, ma = _hit64(rows, pos, dir_, idx_a)
    tb, mb = _hit64(rows, pos, dir_, idx_b)
    with np.errstate(invalid="ignore"):
        same_t = np.abs(ta - tb) <= _T_TIE * np.maximum(1.0, np.abs(ta))
        edge = (np.abs(ma) <= _MARGIN_TIE) | (np.abs(mb) <= _MARGIN_TIE)
    return same_t | edge


def compare_segment(a, b, *, live, rows, pos, dir_, tol=None) -> dict:
    """Compare two segment results ``(idx, npos, ndir, ntput, nres,
    still)`` of the same inputs.

    - idx must agree on at least 99.9% of live lanes, and each live
      lane where it does not must be a near-tie;
    - on live lanes that agree, still must be equal;
    - npos, ndir and ntput are compared on agreeing lanes that both
      sides keep alive, nres on every agreeing lane (lanes that are not
      live pass it through). Per output, each lane must be within
      ``tol`` (``(rtol, atol)``, default ``(1e-5, 1e-5)``), except at
      most 0.1% of the compared lanes, which must still be within
      ``OUTLIER_TOL``. Those few lanes are ill-conditioned, and two
      correct f32 implementations that round differently (a fused
      multiply-add against two roundings) part there: a shading frame
      whose normal is within ~1e-3 of ±Y (the frame's 1/sqrt(1-ny²)),
      refraction near total internal reflection, a grazing hit.

    Returns a report with ``ok`` and the measured numbers.
    """
    tol = {**{n: (1e-5, 1e-5) for n in SEGMENT_OUTPUTS}, **(tol or {})}
    a = dict(zip(SEGMENT_OUTPUTS, map(_np, a)))
    b = dict(zip(SEGMENT_OUTPUTS, map(_np, b)))
    live = _np(live).astype(bool)
    rows, pos, dir_ = _np(rows), _np(pos), _np(dir_)
    n_live = int(live.sum())
    diff = live & (a["idx"] != b["idx"])
    ties = near_ties(rows, pos[:, diff], dir_[:, diff], a["idx"][diff], b["idx"][diff])
    agree = ~diff
    report = {
        "n_live": n_live,
        "idx_agree": 1.0 - diff.sum() / max(n_live, 1),
        "n_idx_mismatch": int(diff.sum()),
        "mismatches_all_near_ties": bool(ties.all()),
        "still_equal": bool(np.array_equal(a["still"][agree], b["still"][agree])),
    }
    still = agree & (a["still"] > 0) & (b["still"] > 0)
    ok = report["still_equal"]
    errs, outliers = {}, {}
    for name, mask in (("npos", still), ("ndir", still), ("ntput", still),
                       ("nres", agree)):
        x, y = a[name][:, mask], b[name][:, mask]
        errs[name] = float(np.abs(x - y).max()) if x.size else 0.0
        rtol, atol = tol[name]
        beyond = ~np.isclose(y, x, rtol=rtol, atol=atol).all(axis=0)
        outliers[name] = int(beyond.sum())
        ok &= outliers[name] <= MAX_OUTLIER_SHARE * max(int(mask.sum()), 1)
        ok &= bool(np.allclose(y, x, rtol=OUTLIER_TOL, atol=OUTLIER_TOL))
    report["max_abs_err"] = errs
    report["n_outliers"] = outliers
    report["ok"] = bool(
        ok and report["idx_agree"] >= MIN_IDX_AGREEMENT
        and report["mismatches_all_near_ties"]
    )
    return report


def compare_winners(got, want, *, live, rows, pos, dir_) -> dict:
    """Two selections of winner indices ``idx`` i32[R] for the same rays
    (the traversal walk against brute selection): equal on at least 99.9%
    of live lanes, and every live lane where they differ a near-tie.
    ``max_t_gap`` is the largest distance, in float64, between the two
    winners' hit distances on those lanes (0 where all agree)."""
    got, want = _np(got), _np(want)
    live = _np(live).astype(bool)
    rows, pos, dir_ = _np(rows), _np(pos), _np(dir_)
    n_live = int(live.sum())
    diff = live & (got != want)
    ties = near_ties(rows, pos[:, diff], dir_[:, diff], got[diff], want[diff])
    ta, _ = _hit64(rows, pos[:, diff], dir_[:, diff], got[diff])
    tb, _ = _hit64(rows, pos[:, diff], dir_[:, diff], want[diff])
    with np.errstate(invalid="ignore"):
        gaps = np.abs(ta - tb)
    agree = 1.0 - diff.sum() / max(n_live, 1)
    rep = {"n_live": n_live, "idx_agree": float(agree), "n_idx_mismatch": int(diff.sum()),
           "mismatches_all_near_ties": bool(ties.all()),
           "max_t_gap": float(np.nanmax(gaps, initial=0.0)),
           "dead_lanes_miss": bool((got[~live] == -1).all())}
    rep["ok"] = bool(agree >= MIN_IDX_AGREEMENT and ties.all() and rep["dead_lanes_miss"])
    return rep


def compare_shade(got, want, *, live, rows, pos, dir_, tol=(1e-5, 1e-5)) -> dict:
    """Two results ``(idx, tbg, shade)`` of the split path's intersector
    for the same rays: winners as :func:`compare_winners` holds them;
    on live lanes whose winners agree, ``shade`` (a copy of the winner's
    row) equal, and ``tbg`` within ``tol`` (``(rtol, atol)``). A lane
    beyond ``tol`` passes only where ``got``'s t, β and γ each lie within
    ``SHADE_ULPS`` × eps32 × their rounding scale of the float64 values
    (:func:`_winner64`): on a small or distant triangle β = o'_x + t·d'_x
    cancels terms of size ~100, and a fused multiply-add and two
    roundings part by ~1e-4 there, both as far from the exact value."""
    got, want = tuple(map(_np, got)), tuple(map(_np, want))
    live = _np(live).astype(bool)
    rows, pos, dir_ = _np(rows), _np(pos), _np(dir_)
    rep = compare_winners(got[0], want[0], live=live, rows=rows, pos=pos, dir_=dir_)
    agree = live & (got[0] == want[0])
    g, w = got[1][:, agree], want[1][:, agree]
    beyond = ~np.isclose(g, w, rtol=tol[0], atol=tol[1]).all(axis=0)
    lanes = np.flatnonzero(agree)[beyond]
    exact, scale = _winner64(rows, pos[:, lanes], dir_[:, lanes], got[0][lanes])
    with np.errstate(invalid="ignore"):
        ulps = np.abs(g[:3, beyond] - exact) / (EPS32 * scale)
    rep["tbg_max_abs_err"] = float(np.abs(g - w).max()) if g.size else 0.0
    rep["tbg_n_beyond_tol"] = int(beyond.sum())
    rep["tbg_worst_ulps"] = float(np.nanmax(ulps, initial=0.0))
    rep["shade_equal"] = bool(np.array_equal(got[2][:, agree], want[2][:, agree]))
    rep["ok"] = bool(rep["ok"] and rep["shade_equal"] and (got[0][lanes] >= 0).all()
                     and (ulps <= SHADE_ULPS).all())
    return rep


def _micro_products(ws, x):
    """(p, E) for the rays x bf16[48, r]: p = wsᵀ·x f64[6T, r] (each bf16
    product exact, summed in float64) and E f64[r], the rounding bound of
    B12's sums, 48 · MICRO_ADDEND_ULPS · 2^-23 times the ray's largest
    Σ|ws_k·x_k| over the 6T columns."""
    w, x = ws.double().T, x.double()
    return w @ x, 48 * MICRO_ADDEND_ULPS * 2.0 ** -23 * (w.abs() @ x.abs()).amax(0)


def compare_micro(ws, rays, t_chunk, variant, got, want, *, step=None) -> dict:
    """The selection microkernel B12's output ``got`` i32[R] for ``ws``
    bf16[48, 6T], ``rays`` bf16[48, R], chunk ``t_chunk`` and ``variant``,
    against the plain version's ``want`` (``ops.selection_micro``), by a
    rounding rule in place of bit equality: the kernel sums p on the
    tensor cores, in another order and rounding than the plain version's
    row-order f32 sums. p is recomputed in float64 from the same bf16
    operands (exact products), and E, per ray, is :func:`_micro_products`'.

    - ``matmul_only``: ``got`` must lie in {trunc(v) : v ∈ [min p − E,
      min p + E]} on every ray; ``matmul_bf16`` the same with E widened by
      one bf16 ulp (2^-8) of |min p| + E.
    - ``full``: winners equal on at least MIN_IDX_AGREEMENT of the rays.
      Where they differ, either both triangles are accepted in float64 and
      their t lie within their rounding slack of each other (a near-tie),
      or one of them lies within its rounding slack of the accept chain's
      boundary (β, γ, 1 − β − γ or t near 0, or |d'_z| within E of 0).
      Each p is within E of the float64 value, so the slack of t = q / w
      is E·(1 + |t|) / (|w| − E), that of β is E·(1 + |t|) + (|d'_x| +
      E)·(that of t), of γ likewise, of 1 − β − γ their sum; E also
      covers the f32 rounding of the accept chain itself.

    ``step``: rays per float64 product (default: 2^27 / 6T values)."""
    import torch

    R, T6 = rays.shape[1], ws.shape[1]
    tc = t_chunk
    got = got.to(rays.device).long()
    want = want.to(rays.device).long()
    rep = {"variant": variant, "n_rays": R, "n_differ_from_plain": int((got != want).sum())}
    if variant != "full":
        step = step or max(1, (1 << 27) // T6)
        bad, worst_e = 0, 0.0
        for s in range(0, R, step):
            p, e = _micro_products(ws, rays[:, s:s + step])
            low = p.amin(0)
            if variant == "matmul_bf16":
                e = e + 2.0 ** -8 * (low.abs() + e)
            g = got[s:s + step].double()
            bad += int(((g < torch.trunc(low - e)) | (g > torch.trunc(low + e))).sum())
            worst_e = max(worst_e, float(e.max()))
        rep.update(n_out_of_bound=bad, max_slack=worst_e)
        rep["ok"] = bad == 0
        return rep
    diff = torch.nonzero(got != want)[:, 0]
    x = rays[:, diff]
    e = _micro_products(ws, x)[1]
    accepted, t, dt, edge = [], [], [], []
    for j in (got[diff], want[diff]):
        jj = j.clamp_min(0)
        c = jj // tc
        col = (c * 6 * tc + jj % tc)[None, :] + (torch.arange(6, device=j.device) * tc)[:, None]
        w = ws.double()[:, col]  # [48, 6, n]
        opx, opy, q, dpx, dpy, dz = (w * x.double()[:, None, :]).sum(0)
        tj = q / dz
        beta, gamma = opx + tj * dpx, opy + tj * dpy
        rest = 1.0 - (beta + gamma)
        grow = e * (1.0 + tj.abs())
        dtj = torch.where(dz.abs() > e, grow / (dz.abs() - e), torch.inf)
        db, dg = grow + (dpx.abs() + e) * dtj, grow + (dpy.abs() + e) * dtj
        near = ((beta.abs() <= db) | (gamma.abs() <= dg) | (rest.abs() <= db + dg)
                | (tj.abs() <= dtj) | ~tj.isfinite())
        ok = (beta > 0) & (gamma > 0) & (rest > 0) & (tj > 0)
        accepted.append(ok & (j >= 0))
        t.append(tj)
        dt.append(dtj)
        edge.append(near & (j >= 0))
    tie = accepted[0] & accepted[1] & ((t[0] - t[1]).abs() <= dt[0] + dt[1])
    boundary = ~tie & (edge[0] | edge[1])
    n_bad = int((~tie & ~boundary).sum())
    agree = 1.0 - diff.shape[0] / max(R, 1)
    rep.update(idx_agree=agree, n_idx_mismatch=int(diff.shape[0]), n_near_tie=int(tie.sum()),
               n_boundary=int(boundary.sum()), n_bad=n_bad)
    rep["ok"] = bool(agree >= MIN_IDX_AGREEMENT and n_bad == 0)
    return rep


def compare_images(got, want) -> dict:
    """Two renders f32[H, W, 3] of the same key: at least 99% of pixels
    within 1e-4 (max over channels), frame means within 1e-3 relative,
    every value finite."""
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max(axis=-1)
    share = float((err <= PIXEL_ATOL).mean())
    mean_rel = abs(float(got.mean()) - float(want.mean())) / max(
        abs(float(want.mean())), 1e-30
    )
    ok = (got.shape == want.shape and bool(np.isfinite(got).all())
          and share >= MIN_PIXEL_SHARE and mean_rel <= MEAN_RTOL)
    return {"pixel_share": share, "max_abs_err": float(err.max()),
            "mean_rel": mean_rel, "ok": bool(ok)}


def _close(got, want, tol, scale):
    return np.abs(got - want) <= tol * (np.abs(want) + scale)


def compare_grads(want, got, *, lanes=None, tol=GRAD_TOL) -> dict:
    """Compare two segment vjps ``(d_pos, d_dir, d_tput, d_res, d_full)``
    of the same inputs on the lanes where ``lanes`` (bool[R]) is set.

    Per output, a lane agrees when each of its values is within ``tol``
    of ``|want| + max |want|`` (rtol = atol = tol, the atol relative to
    the output's largest value). At most 0.1% of the lanes may disagree,
    and those still within ``OUTLIER_TOL``: a shading frame whose normal
    is within ~1e-3 of ±Y carries a 1/sqrt(1 − ny²) factor, and two
    correct f32 reverse modes that round differently part there. Every
    value must be finite.
    """
    want = dict(zip(GRAD_OUTPUTS, map(_np, want)))
    got = dict(zip(GRAD_OUTPUTS, map(_np, got)))
    R = want["d_pos"].shape[1]
    lanes = np.ones(R, bool) if lanes is None else _np(lanes).astype(bool)
    n = max(int(lanes.sum()), 1)
    rep = {"n_lanes": int(lanes.sum()), "max_abs_err": {}, "share_within": {},
           "scale": {}}
    ok = True
    for name in GRAD_OUTPUTS:
        w, g = want[name][:, lanes], got[name][:, lanes]
        ok &= bool(np.isfinite(g).all() and np.isfinite(w).all())
        scale = float(np.abs(w).max()) if w.size else 0.0
        within = _close(g, w, tol, scale).all(axis=0)
        rep["scale"][name] = scale
        rep["max_abs_err"][name] = float(np.abs(g - w).max()) if w.size else 0.0
        rep["share_within"][name] = float(within.sum()) / n
        ok &= (~within).sum() <= MAX_OUTLIER_SHARE * n
        ok &= bool(_close(g, w, OUTLIER_TOL, scale).all())
    rep["ok"] = bool(ok)
    return rep


def compare_scatter(want, got, bound, ulps=SCATTER_ULPS) -> dict:
    """Two row scatters [T, 48] of the same rays, summed in different
    orders; ``want`` may be the exact sums (the plain scatter in f64).
    ``bound`` is the plain scatter of ``|dvals|``: each entry's
    sum of magnitudes, which bounds how far f32 rounding can move it.
    Every entry must be finite and within ``ulps · eps32 · bound``, so a
    row of small entries is held to its own scale, not the table's
    largest; a lost or doubled add of a ray into a row of n rays moves
    its entry by ~bound / n."""
    want, got, bound = _np(want), _np(got), _np(bound)
    err = np.abs(got - want)
    lim = ulps * np.finfo(np.float32).eps * bound
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(err > 0, err / (np.finfo(np.float32).eps * bound), 0.0)
    return {"max_abs_err": float(err.max()), "worst_ulps": float(ratio.max()),
            "ok": bool(np.isfinite(got).all() and (err <= lim).all())}


def compare_param_grads(want, got, tol) -> dict:
    """Parameter gradients ``{name: array}`` of two renders of the same
    key: every value finite and within ``tol`` of ``|want| + max |want|``
    per parameter."""
    rep, ok = {}, True
    for name in want:
        w, g = _np(want[name]), _np(got[name])
        scale = float(np.abs(w).max()) if w.size else 0.0
        good = bool(g.shape == w.shape and np.isfinite(g).all()
                    and _close(g, w, tol, scale).all())
        rep[name] = {"max_abs_err": float(np.abs(g - w).max()), "scale": scale,
                     "ok": good}
        ok &= good
    rep["ok"] = bool(ok)
    return rep


class NaNTrapped(FloatingPointError):
    """An operation under :func:`nan_trap` made a NaN."""


# Operations whose output is uninitialised memory: a NaN there is no
# result of arithmetic.
_UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                  "resize_", "set_")


@contextlib.contextmanager
def nan_trap():
    """Raise :class:`NaNTrapped` at the first operation whose floating
    output holds a NaN, for the duration of the block: the counterpart
    of ``jax_debug_nans``. Every ATen operation is checked as it runs,
    the backward pass's too, so a NaN that a later ``where`` masks away
    still trips it: the guards under test must keep a NaN from ever
    being made. The check reads each output back (a device sync on the
    card)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Trap(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ not in _UNINITIALISED:
                for t in tree_leaves(out):
                    if (isinstance(t, torch.Tensor) and t.is_floating_point()
                            and bool(torch.isnan(t).any())):
                        raise NaNTrapped(f"{func} made a NaN (output {tuple(t.shape)})")
            return out

    with Trap():
        yield


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper of the port (segment forward with or
    without culling, the regen pass, segment from known winners,
    traversal walk and its tables, segment backward, row scatter, the
    split path's nearest hit, which the superseded selection entries call
    too, the fused intersector's index, the selection microkernels, the
    uniform draws) to its plain-torch version, on any device, for the
    duration of the block."""
    from .ops import nearest_shade as NS
    from .ops import regen_pass as RP
    from .ops import rng as RNG
    from .ops import scatter_rows as S
    from .ops import segment_fused as F
    from .ops import selection_micro as SM
    from .ops import traverse_walk as TW

    routes = [(SM, "selection_micro", SM.selection_micro_ref),
              (SM, "epilogue_only", SM.epilogue_only_ref),
              (SM, "epilogue_shared", SM.epilogue_shared_ref),
              (F, "mega_segment", F.mega_segment_ref),
              (RP, "regen_pass", RP.regen_pass_ref),
              (F, "rows_segment", F.rows_segment_ref),
              (F, "segment_backward", F.segment_backward_ref),
              (F, "segment_backward_rows", F.segment_backward_rows_ref),
              (F, "scatter_rows", S.scatter_rows_ref),
              (TW, "traverse_select", TW.traverse_select_ref),
              (TW, "walk_tables", TW.walk_tables_ref),
              (NS, "nearest_shade_full", NS.nearest_shade_full_ref),
              (NS, "nearest_triangle", NS.nearest_triangle_ref),
              (NS, "scatter_rows", S.scatter_rows_ref),
              (RNG, "stream_uniforms", RNG.stream_uniforms_ref)]
    saved = [getattr(mod, name) for mod, name, _ in routes]
    for mod, name, plain in routes:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(routes, saved):
            setattr(mod, name, fn)


def tie_soup(device="cpu", R=512, seed=0):
    """A seeded soup of 384 triangles in three 128-triangle chunks (not in
    Morton order) and R rays, on which every ray's nearest hit ties at
    equal t: triangles 0..63 tile the unit square near z = 0 and
    triangles 256..319 are exact copies of them. The rest of chunk 0 and
    chunk 1 lie behind the square; the rest of chunk 2 lies off to the
    side towards the rays, so the walk enters chunk 2's box before chunk
    0's and meets the copy first. Rays start at z = 5 above the square
    and point down. Returns the vertices a, b, c f32[T, 3], the row table
    f32[T, 48] (geometry only), its chunk boxes clo, chi f32[3, 3] and
    pos, dir f32[3, R]; the winner of every ray is the original (index
    < 64), whose t equals its copy's."""
    import torch

    from .ops.intersect import triangle_transforms
    from .ops.morton import chunk_aabbs

    rng = np.random.default_rng(seed)
    a, b, c = (np.zeros((384, 3)) for _ in range(3))
    k = np.arange(64)
    cell = k // 2
    x0, y0 = (cell % 8) / 8.0, (cell // 8) / 4.0
    z = rng.uniform(0.0, 0.1, (32, 3))[cell]
    lower = k % 2 == 0  # two triangles per cell of 1/8 x 1/4
    a[:64] = np.stack([x0, y0, z[:, 0]], 1)
    b[:64] = np.stack([x0 + 0.125, np.where(lower, y0, y0 + 0.25), z[:, 1]], 1)
    c[:64] = np.stack([np.where(lower, x0 + 0.125, x0), y0 + 0.25, z[:, 2]], 1)
    for lo, hi, zlo, zhi in ((64, 256, -3.0, -1.0), (320, 384, 1.0, 1.2)):
        n = hi - lo
        base = np.stack([rng.uniform(0.0, 1.0, n), rng.uniform(0.0, 1.0, n),
                         rng.uniform(zlo, zhi, n)], 1)
        if lo == 320:  # off to the side, towards the rays
            base[:, :2] += 3.0
        a[lo:hi], b[lo:hi], c[lo:hi] = (base + rng.normal(size=(n, 3)) * 0.1 for _ in range(3))
    a[256:320], b[256:320], c[256:320] = a[:64], b[:64], c[:64]
    verts = [torch.tensor(v, dtype=torch.float32, device=device) for v in (a, b, c)]
    m, m_a = triangle_transforms(*verts)
    geom = torch.cat([m, -m_a[:, :, None]], dim=2).reshape(-1, 12)
    rows = torch.cat([geom, torch.zeros(384, 36, device=device)], dim=1).contiguous()
    valid = torch.ones(384, dtype=torch.bool, device=device)
    clo, chi = chunk_aabbs(*verts, valid, torch.arange(384, device=device), 128)
    o = np.stack([rng.uniform(0.02, 0.98, R), rng.uniform(0.02, 0.98, R), np.full(R, 5.0)])
    d = np.stack([rng.normal(0.0, 0.01, R), rng.normal(0.0, 0.01, R), -np.ones(R)])
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    pos, dir_ = (torch.tensor(x, dtype=torch.float32, device=device).contiguous()
                 for x in (o, d))
    return verts, rows, clo, chi, pos, dir_


HARD_SOUPS = ("random", "grazing", "slivers", "far", "large", "degenerate")


def hard_soup(case, T, R, seed, device="cpu"):
    """A seeded soup of T triangles and R rays aimed at points of them just
    inside or outside an edge (barycentrics within 1e-7..0.1 of it), where
    the segment kernel's sphere rejection has the least slack: "grazing"
    rays (|cos| to the plane 1e-7..1e-2), "slivers" (widths down to where
    kappa passes 2^16), "far" origins (1e3-3e4 away), "large" coordinates
    (the scene scaled by 1e3 and moved to 3e4), "degenerate" (zero-area
    triangles, and rows holding NaN, +-inf or zeros). Returns the vertices
    a, b, c f32[T, 3], the rows f32[T, 48] (geometry only) and pos, dir
    f32[3, R], rays sorted by the triangle they aim at.

    "corners", not in :data:`HARD_SOUPS`, is :func:`_corner_soup`: rays
    accepted just beyond a vertex that lies on its leaf's box, for the
    culled loop's leaf boxes (T a multiple of 32)."""
    import torch

    from .ops.intersect import triangle_transforms

    if case == "corners":
        verts = _corner_soup(T, R, seed)
        geom_src = verts[:3]
        pos, dir_ = verts[3:]
        verts = [torch.tensor(x, dtype=torch.float32, device=device) for x in geom_src]
        m, m_a = triangle_transforms(*verts)
        geom = torch.cat([m, -m_a[:, :, None]], dim=2).reshape(-1, 12)
        rows = torch.cat([geom, torch.zeros(T, 36, device=device)], dim=1).contiguous()
        pos, dir_ = (torch.tensor(x.T, dtype=torch.float32, device=device).contiguous()
                     for x in (pos, dir_))
        return verts, rows, pos, dir_
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (T, 3))
    e1, e2 = rng.normal(size=(T, 3)) * 0.3, rng.normal(size=(T, 3)) * 0.3
    if case == "slivers":
        perp = np.cross(e1, rng.normal(size=(T, 3)))
        perp *= np.linalg.norm(e1, axis=1, keepdims=True) / np.linalg.norm(perp, axis=1,
                                                                           keepdims=True)
        e2 = e1 * rng.uniform(0.1, 0.9, (T, 1)) + perp * 10.0 ** rng.uniform(-5.5, -2.0, (T, 1))
    scale = 1e3 if case == "large" else 1.0
    a = a * scale + (3e4 if case == "large" else 0.0)
    e1, e2 = e1 * scale, e2 * scale
    j = np.sort(rng.integers(0, T, R))
    near = 10.0 ** rng.uniform(-7.0, -1.0, R) * rng.choice([-1.0, 1.0], R)
    free = rng.uniform(0.0, 1.0, R) * (1.0 - np.abs(near))
    edge = rng.integers(0, 3, R)  # beta, gamma or 1 - beta - gamma near 0
    beta = np.where(edge == 0, near, free)
    gamma = np.where(edge == 1, near, np.where(edge == 0, free, 1.0 - near - free))
    p = a[j] + beta[:, None] * e1[j] + gamma[:, None] * e2[j]
    n = np.cross(e1, e2)[j]
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = rng.normal(size=(R, 3))
    if case == "grazing":
        u = np.cross(n, d)
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        d = u + n * (10.0 ** rng.uniform(-7.0, -2.0, (R, 1)) * rng.choice([-1.0, 1.0], (R, 1)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lo, hi = (3.0, 4.5) if case == "far" else (-1.0, 0.5)
    o = p - 10.0 ** rng.uniform(lo, hi, (R, 1)) * scale * d
    b, c = a + e1, a + e2
    if case == "degenerate":
        k = rng.permutation(T)[:T // 4]
        c[k[0::2]] = a[k[0::2]] + 0.5 * e1[k[0::2]]  # collinear
        b[k[1::2]] = c[k[1::2]] = a[k[1::2]]  # one point
    verts = [torch.tensor(x, dtype=torch.float32, device=device) for x in (a, b, c)]
    m, m_a = triangle_transforms(*verts)
    geom = torch.cat([m, -m_a[:, :, None]], dim=2).reshape(-1, 12)
    if case == "degenerate":
        bad = torch.tensor(rng.permutation(T)[:T // 8], device=device)
        geom[bad[0::4], 3] = float("nan")
        geom[bad[1::4], 8] = float("inf")
        geom[bad[2::4], 1] = -float("inf")
        geom[bad[3::4]] = 0.0
    rows = torch.cat([geom, torch.zeros(T, 36, device=device)], dim=1).contiguous()
    pos, dir_ = (torch.tensor(x.T, dtype=torch.float32, device=device).contiguous()
                 for x in (o, d))
    return verts, rows, pos, dir_


def _corner_soup(T, R, seed):
    """The "corners" case of :func:`hard_soup` (float64 numpy: a, b, c
    [T, 3], o, d [R, 3]): T / 32 pairs of leaves of 16 copies each, a
    backstop leaf, then a corner leaf. A corner is an equilateral
    triangle (radius 0.05..0.3, centers in [-1, 1]^3) whose vertex 0 lies
    on the +-axis from its center, so on a face of its bounding sphere's
    box; its backstop, an equal triangle perpendicular to that axis, lies
    1e-4 beyond that vertex. Each ray aims at a point 10^-3.7..10^-2.7
    beyond the vertex along the axis, from 10^3.5..10^4.5 away on the
    outer side (direction·axis <= -0.3): f32 rounding accepts some of
    them on the corner, and then the backstop behind the hit, visited
    first in index order, leaves the ray a best t at which a box that
    reaches only to the vertex (plus the margin) is never entered."""
    rng = np.random.default_rng(seed)
    G = T // 32
    c = rng.uniform(-1.0, 1.0, (G, 3))
    rho = rng.uniform(0.05, 0.3, G)
    e = np.eye(3)[rng.integers(0, 3, G)] * rng.choice([-1.0, 1.0], G)[:, None]
    w = rng.normal(size=(G, 3))
    w -= (w * e).sum(1, keepdims=True) * e
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    u = np.cross(e, w)
    th = np.array([0.0, 2.0, 4.0]) * np.pi / 3.0
    cos, sin = np.cos(th)[None, :, None], np.sin(th)[None, :, None]
    corner = c[:, None] + rho[:, None, None] * (cos * e[:, None] + sin * w[:, None])
    back = (c + (rho + 1e-4)[:, None] * e)[:, None] + rho[:, None, None] * (
        cos * w[:, None] + sin * u[:, None])
    tri = np.repeat(np.stack([back, corner], 1).reshape(2 * G, 3, 3), 16, axis=0)
    j = np.sort(rng.integers(0, G, R))
    p = c[j] + (rho[j] + 10.0 ** rng.uniform(-3.7, -2.7, R))[:, None] * e[j]
    d = rng.normal(size=(R, 3))
    d -= np.maximum((d * e[j]).sum(1, keepdims=True) + 0.3, 0.0) * e[j]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = p - 10.0 ** rng.uniform(3.5, 4.5, (R, 1)) * d
    return tri[:, 0], tri[:, 1], tri[:, 2], o, d


# ------------------------------------------------------------ sharded paths
# The sharded paths of parallel/sharded.py with every rank of a (n_rays,
# n_spp) mesh in one process: the same keys, bands and order of sums, and
# no collective. An all-reduce of two ranks gives the same bits in either
# order, so against two ranks these emulations are bit-equal; against more,
# the all-reduce may sum in another order.


def _rank_total(scene, camera, key, ri, si, shape, *, width, height, spp, config, tables):
    """Rank (ri, si)'s sum of its samples f32[H/n_rays, W, 3], from zero."""
    import torch

    from .ops.rng import fold_in
    from .parallel.sharded import RANK_KEY_STRIDE
    from .render.integrator import render_rows

    rows, spp_local = height // shape[0], spp // shape[1]
    dev_key = fold_in(key, ri * RANK_KEY_STRIDE + si)
    total = torch.zeros(rows, width, 3, device=camera.device)
    for s in range(spp_local):
        total = total + render_rows(scene, camera, fold_in(dev_key, s), width, height,
                                    ri * rows, rows, config, tables)
    return total


def emulate_sample_pass(scene, camera, key, shape, *, width, height, spp, config):
    """``sharded_sample_pass`` of every rank of a ``shape = (n_rays,
    n_spp)`` mesh, assembled into the frame f32[H, W, 3]: each band the
    sum from zero of its spp ranks' totals, in rank order, over ``spp``.
    Differentiable in the scene's fields under autograd."""
    import torch

    from .render.integrator import scene_tables

    tables = scene_tables(scene, config)
    kw = dict(width=width, height=height, spp=spp, config=config, tables=tables)
    bands = []
    for ri in range(shape[0]):
        band = torch.zeros(height // shape[0], width, 3, device=camera.device)
        for si in range(shape[1]):
            band = band + _rank_total(scene, camera, key, ri, si, shape, **kw)
        bands.append(band / spp)
    return torch.cat(bands)


def emulate_regen_pass(scene, camera, key, shape, *, width, height, spp, config):
    """``sharded_regen_pass`` of every rank, assembled: f32[H, W, 3]."""
    import torch

    from .ops.rng import fold_in
    from .parallel.sharded import RANK_KEY_STRIDE
    from .render.integrator import scene_tables
    from .render.regen import render_regen_planar

    rows, spp_local = height // shape[0], spp // shape[1]
    tables = scene_tables(scene, config)
    bands = []
    with torch.no_grad():
        for ri in range(shape[0]):
            band = torch.zeros(3, rows, width, device=camera.device)
            for si in range(shape[1]):
                img = render_regen_planar(scene, camera, fold_in(key, ri * RANK_KEY_STRIDE + si),
                                          width, height, spp_local, config, tables,
                                          y0=ri * rows, n_rows=rows)
                band = band + img * spp_local
            bands.append(band / spp)
    return torch.cat(bands, dim=1).permute(1, 2, 0)


def emulate_train_step(scene, camera, params, target, key, shape, *, width, height, spp,
                       config, lr):
    """``make_train_step``'s ``(new_params, loss)`` with every rank in one
    process: each rank's gradient is the backward of its own band's term
    through its own samples (the other spp ranks' totals enter its band
    as constants), and the gradients are summed from zero in rank order."""
    import torch

    from .diff.grad import merge_params
    from .render.integrator import scene_tables

    rows = height // shape[0]
    n = height * width * 3
    kw = dict(width=width, height=height, spp=spp, config=config)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    loss = torch.zeros((), device=camera.device)
    for ri in range(shape[0]):
        leaves, totals = [], []
        for si in range(shape[1]):
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            s = merge_params(scene, p)
            leaves.append(p)
            totals.append(_rank_total(s, camera, key, ri, si, shape,
                                      tables=scene_tables(s, config), **kw))
        for si, p in enumerate(leaves):
            band = torch.zeros(rows, width, 3, device=camera.device)
            for sj, t in enumerate(totals):
                band = band + (t if sj == si else t.detach())
            sq = ((band / spp - target[ri * rows:(ri + 1) * rows]) ** 2).sum()
            (sq / n).backward()
            for k, v in p.items():
                if v.grad is not None:
                    grads[k] = grads[k] + v.grad
        loss = loss + sq.detach()
    with torch.no_grad():
        new = {k: torch.clamp_min(params[k] - lr * grads[k], 0.0) for k in params}
    return new, loss / n


def reference_train_step(scene, camera, params, target, key, shape, *, width, height, spp,
                         config, lr):
    """``make_train_step``'s ``(new_params, loss)`` by plain autograd of
    the frame's loss ``mean((img − target)²)`` over
    :func:`emulate_sample_pass`, in one process: a reference for the
    sharded gradient's scaling that shares none of its bookkeeping."""
    import torch

    from .diff.grad import merge_params, value_and_grad

    def loss_fn(p, k):
        img = emulate_sample_pass(merge_params(scene, p), camera, k, shape, width=width,
                                  height=height, spp=spp, config=config)
        return torch.mean((img - target) ** 2)

    loss, grads = value_and_grad(loss_fn, params, key)
    with torch.no_grad():
        new = {k: torch.clamp_min(params[k] - lr * grads[k], 0.0) for k in params}
    return new, loss


def emulate_geom_step(scene, camera, tri_mask, theta, target, key, shape, *, width, height,
                      spp, config, n_edge_samples, lr):
    """``make_geom_train_step``'s ``(theta', loss)`` with every rank in one
    process: the bands' squared residuals summed in rank order, and every
    rank's probe estimate under its own key, summed from zero over the
    number of ranks."""
    import torch

    import dataclasses

    from .diff.boundary import boundary_grad_translation, translation_support
    from .ops.rng import fold_in
    from .parallel.sharded import PROBE_KEY_BASE, RANK_KEY_STRIDE

    n_rays, n_spp = shape
    rows, n = height // n_rays, height * width * 3
    vmask, edges = translation_support(scene, tri_mask, camera.device)
    theta = torch.as_tensor(theta, dtype=torch.float32, device=camera.device)
    with torch.no_grad():
        s = dataclasses.replace(scene, vertices=scene.vertices + vmask * theta[None, :])
        img = emulate_sample_pass(s, camera, key, shape, width=width, height=height,
                                  spp=spp, config=config)
        loss = torch.zeros((), device=camera.device)
        for ri in range(n_rays):
            band = slice(ri * rows, (ri + 1) * rows)
            loss = loss + ((img[band] - target[band]) ** 2).sum()
        image_grad = 2.0 * (img - target) / n
        g = torch.zeros(3, device=camera.device)
        for r in range(n_rays * n_spp):
            probe_key = fold_in(key, PROBE_KEY_BASE + (r // n_spp) * RANK_KEY_STRIDE
                                + r % n_spp)
            g = g + boundary_grad_translation(
                s, camera, edges, image_grad, probe_key, width=width, height=height,
                config=config, n_samples=n_edge_samples // (n_rays * n_spp))
        return theta - lr * (g / (n_rays * n_spp)), loss / n


def sharded_cases(cases, device):
    """Run on every rank of a :func:`..parallel.launch.run_ranks` world:
    each case builds its mesh (``case["mesh"] = (n_rays, n_spp)``) and a
    Cornell box (``case["scene"]``: ``cornell_box``'s keyword arguments)
    at ``case["width"] x case["height"]`` on this rank's device, runs one
    sharded path (``case["kind"]``) under ``make_key(case["seed"])`` with
    ``TraceConfig(**case["config"])`` and returns its outputs, frames
    gathered whole:

    - ``"sample"``, ``"regen"``: the frame of one pass of ``spp`` samples;
    - ``"progressive"``: ``{"color", "weight"}`` of the gathered film
      after one step per seed of ``case["seeds"]``;
    - ``"train"``: ``{"loss", "params"}`` after one step from the scene's
      ``case["fields"]`` (``mat_kd`` scaled by ``case["kd_scale"]``)
      towards ``case["target"]`` at ``case["lr"]``;
    - ``"geom"``: ``{"loss", "theta"}`` after one geometry step on the
      lamp (:func:`..diff.boundary.lamp_mask`) from ``case["theta"]``;
    - ``"recover"``: ``{"theta", "losses"}`` after ``case["steps"]``
      geometry steps under keys ``seed + i``, of which only θ's x
      component is kept, as ``tests/test_parallel.py`` does.

    Tensors come back as numpy arrays."""
    import torch

    from .diff.boundary import lamp_mask
    from .diff.grad import split_params
    from .models import cornell
    from .ops.rng import make_key
    from .parallel import sharded as SH
    from .parallel.launch import to_host
    from .parallel.mesh import make_mesh
    from .render.film import Film
    from .render.integrator import TraceConfig

    results = []
    for c in cases:
        mesh = make_mesh(*c["mesh"], device=device)
        w, h, spp = c["width"], c["height"], c["spp"]
        scene, camera = cornell.cornell_box(width=w, height=h, device=mesh.device,
                                            **c.get("scene", {}))
        config = TraceConfig(**c["config"])
        kw = dict(width=w, height=h, spp=spp, config=config)
        key = make_key(c["seed"])
        kind = c["kind"]
        if kind == "sample":
            out = SH.gather_film(mesh, SH.sharded_sample_pass(mesh, **kw)(scene, camera, key))
        elif kind == "regen":
            out = SH.gather_film(mesh, SH.sharded_regen_pass(mesh, **kw)(scene, camera, key))
        elif kind == "progressive":
            step = SH.make_progressive_step(mesh, **kw)
            film = Film.zeros(SH.film_band(mesh, h)[1], w, mesh.device)
            for seed in c["seeds"]:
                film = step(scene, camera, film, make_key(seed))
            out = {"color": SH.gather_film(mesh, film.color), "weight": film.weight}
        elif kind == "train":
            params = split_params(scene, tuple(c["fields"]))
            params["mat_kd"] = params["mat_kd"] * c["kd_scale"]
            step = SH.make_train_step(mesh, scene, camera, lr=c["lr"], **kw)
            target = torch.as_tensor(c["target"], device=mesh.device)
            new, loss = step(params, target, key)
            out = {"loss": loss, "params": new}
        elif kind in ("geom", "recover"):
            step = SH.make_geom_train_step(mesh, scene, camera, lamp_mask(scene),
                                           n_edge_samples=c["n_edge"], lr=c["lr"], **kw)
            target = torch.as_tensor(c["target"], device=mesh.device)
            theta = torch.tensor(c["theta"], dtype=torch.float32, device=mesh.device)
            if kind == "geom":
                theta, loss = step(theta, target, key)
                out = {"loss": loss, "theta": theta}
            else:
                losses = []
                for i in range(c["steps"]):
                    new, loss = step(theta, target, make_key(c["seed"] + i))
                    theta[0] = new[0]
                    losses.append(float(loss))
                out = {"theta": theta, "losses": losses}
        else:
            raise ValueError(f"unknown case kind {kind!r}")
        results.append(to_host(out))
    return results


def program_spans(path) -> list:
    """The program's spans (``utils/profiling.py::span``) in the Chrome
    trace at ``path``, in start order: [(name without ``mcpt.``, {arg:
    int}, start us, end us)]."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = []
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation" \
                and ev["name"].startswith("mcpt."):
            name, *args = ev["name"][len("mcpt."):].split(" ")
            ts = float(ev["ts"])
            out.append((name, {k: int(v) for k, v in (a.split("=") for a in args)}, ts,
                        ts + float(ev.get("dur", 0.0))))
    return sorted(out, key=lambda s: s[2])
