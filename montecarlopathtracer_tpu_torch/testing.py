"""Agreement checks between two runs of one path segment or frame.

Used by the tests (the port against the JAX package) and by
``chip_smoke.py`` (the CUDA kernel against its plain-torch version).
Two correct implementations that round differently may pick different
winners for a ray that grazes a triangle edge or meets two triangles at
the same distance; :func:`compare_segment` allows those near-ties on a
small share of lanes and holds every other output to a tolerance, with
the same small share of ill-conditioned lanes held to a looser one.
:func:`compare_images` holds whole frames to a pixel share.
"""

from __future__ import annotations

import numpy as np

SEGMENT_OUTPUTS = ("idx", "npos", "ndir", "ntput", "nres", "still")
MIN_IDX_AGREEMENT = 0.999  # share of live lanes whose winners must agree
MAX_OUTLIER_SHARE = 1e-3  # share of compared lanes allowed beyond `tol`
OUTLIER_TOL = 1e-2  # rtol = atol bound that no compared lane may exceed
# Frames: a pixel moves only where its path takes another turn.
MIN_PIXEL_SHARE, PIXEL_ATOL, MEAN_RTOL = 0.99, 1e-4, 1e-3
# Near-tie bounds, in float64 on the f32 rows: accept margins this close
# to 0 flip under f32 rounding, and so do distances this close together.
_MARGIN_TIE = 1e-5
_T_TIE = 1e-4


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _hit64(rows, pos, dir_, idx):
    """(t, accept margin min(β, γ, 1-β-γ)) of triangle ``idx`` per lane,
    in float64; NaN where idx < 0."""
    g = rows[np.maximum(idx, 0), 0:12].astype(np.float64).reshape(-1, 3, 4)
    o = pos.T.astype(np.float64)
    d = dir_.T.astype(np.float64)
    op = np.einsum("rkj,rj->rk", g[:, :, :3], o) + g[:, :, 3]
    dp = np.einsum("rkj,rj->rk", g[:, :, :3], d)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -op[:, 2] / dp[:, 2]
    beta = op[:, 0] + t * dp[:, 0]
    gamma = op[:, 1] + t * dp[:, 1]
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
