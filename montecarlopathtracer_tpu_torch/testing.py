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
:func:`compare_param_grads` the parameter gradients of a whole render.
:func:`plain_kernels` routes every kernel wrapper to its plain version,
so that a path can run plain on the card.
"""

from __future__ import annotations

import contextlib

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
EPS32 = float(np.finfo(np.float32).eps)
# Near-tie bounds, in float64 on the f32 rows: accept margins this close
# to 0 flip under f32 rounding, and so do distances this close together.
_MARGIN_TIE = 1e-5
_T_TIE = 1e-4


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


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper of the port (segment forward with or
    without culling, segment from known winners, traversal walk, segment
    backward, row scatter, the split path's nearest hit, which the
    superseded selection entries call too, the fused intersector's index,
    the selection microkernels) to its plain-torch version, on any
    device, for the duration of the block."""
    from .ops import nearest_shade as NS
    from .ops import scatter_rows as S
    from .ops import segment_fused as F
    from .ops import selection_micro as SM
    from .ops import traverse_walk as TW

    routes = [(SM, "selection_micro", SM.selection_micro_ref),
              (SM, "epilogue_only", SM.epilogue_only_ref),
              (SM, "epilogue_shared", SM.epilogue_shared_ref),
              (F, "mega_segment", F.mega_segment_ref),
              (F, "rows_segment", F.rows_segment_ref),
              (F, "segment_backward", F.segment_backward_ref),
              (F, "scatter_rows", S.scatter_rows_ref),
              (TW, "traverse_select", TW.traverse_select_ref),
              (NS, "nearest_shade_full", NS.nearest_shade_full_ref),
              (NS, "nearest_triangle", NS.nearest_triangle_ref),
              (NS, "scatter_rows", S.scatter_rows_ref)]
    saved = [getattr(mod, name) for mod, name, _ in routes]
    for mod, name, plain in routes:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(routes, saved):
            setattr(mod, name, fn)
