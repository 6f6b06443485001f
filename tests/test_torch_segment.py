"""The port's whole-segment function against the JAX package's.

The same inputs, made from a seed with numpy, go through
``mega_segment_fwd(..., interpret=True)`` (the Pallas kernel, run as the
JAX package's own tests run it on the CPU) and through the port's
``mega_segment``, which on CPU tensors is its plain version
``mega_segment_ref``. Both read the JAX package's own
``pack_transforms_stream`` / ``pack_rows_full`` tables.

Tolerances, on lanes whose winners agree
(``montecarlopathtracer_tpu_torch.testing.compare_segment``):

- ``ntput``, ``nres`` and ``still``: rtol = atol = 1e-5 (they do not
  depend on the hit distance; measured equal);
- ``npos`` and ``ndir`` against the Pallas kernel: atol = 1e-3. The
  kernel forms t = q·r from an approximate reciprocal r refined by one
  Newton step, which in interpret mode on the CPU leaves ~1.5e-5
  relative error in t (the approximate reciprocal alone is 3.9e-3; both
  measured), i.e. up to ~4e-4 in a hit point 25 units away; measured
  max 3.3e-4 in npos and 2.1e-4 in ndir (whose smooth normal depends on
  β, γ). The port divides exactly (IEEE).
- ``npos`` and ``ndir`` against the JAX package's plain-f32 segment
  (``_recompute_rows`` + ``_epilogue_core``, exact division) at the same
  winners: rtol = atol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu.models import cornell as jcornell
from montecarlopathtracer_tpu.ops import segment_fused as JF
from montecarlopathtracer_tpu.ops.intersect import triangle_transforms
from montecarlopathtracer_tpu.ops.intersect_pallas import (
    pack_rows_full as jax_pack_rows_full,
    pack_transforms_stream,
)
from montecarlopathtracer_tpu_torch import convert
from montecarlopathtracer_tpu_torch.ops import segment_fused as F
from montecarlopathtracer_tpu_torch.scene.scene import FIELDS
from montecarlopathtracer_tpu_torch.testing import cap_torch_threads, compare_segment
from montecarlopathtracer_tpu_torch.utils import profiling

cap_torch_threads()

T_CHUNK = 256
R = 3000  # not a multiple of the JAX kernel's 512-ray tile

CASES = {
    "fixed": dict(mode="fixed", flags=[0, 0, 0]),
    "fixed_final_gather": dict(mode="fixed", flags=[1, 0, 0]),
    "rr_roulette": dict(mode="rr", flags=[0, 1, 0], illum=1.0, refract_kd=False),
    "rr_hard_kill": dict(mode="rr", flags=[0, 0, 1], illum=1.0),
    "phong_reflect": dict(mode="fixed", flags=[0, 0, 0], phong_model="phong"),
}


@pytest.fixture(scope="module")
def tables():
    js, _ = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True)
    m, m_a = triangle_transforms(*js.triangle_vertices())
    ws = pack_transforms_stream(m, m_a, js.tri_valid, T_CHUNK)
    rows = np.asarray(jax_pack_rows_full(m, m_a, js, T_CHUNK))
    return js, ws, rows


def _inputs(seed):
    """Half camera rays from the scene-1 eye, half rays from inside the
    box in random directions; random state and uniforms; ~10% dead."""
    rs = np.random.RandomState(seed)
    h = R // 2
    pos = np.empty((3, R), np.float32)
    dirs = np.empty((3, R), np.float32)
    pos[:, :h] = np.array([[0.0], [5.0], [17.0]])
    dirs[:, :h] = rs.uniform([-6, 0, -6], [6, 10, 6], (h, 3)).T - pos[:, :h]
    pos[:, h:] = rs.uniform([-5.9, 0.1, -5.9], [5.9, 9.9, 5.9], (R - h, 3)).T
    dirs[:, h:] = rs.normal(size=(3, R - h))
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    return dict(
        pos=pos, dir=dirs,
        tput=rs.uniform(0.05, 1.0, (3, R)).astype(np.float32),
        res=rs.uniform(0.0, 0.5, (3, R)).astype(np.float32),
        live=rs.uniform(size=R) > 0.1,
        u1=rs.uniform(size=R).astype(np.float32),
        u2=rs.uniform(size=R).astype(np.float32),
        urr=rs.uniform(size=R).astype(np.float32),
    )


def _kw(case):
    kw = dict(mode="fixed", illum=10.0, eps_offset=0.01, refract_kd=True,
              phong_model="blinn")
    kw.update({k: v for k, v in CASES[case].items() if k != "flags"})
    return kw


def _port(rows, x, flags, kw):
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    return F.mega_segment(
        torch.from_numpy(rows.copy()), t["pos"], t["dir"], t["tput"], t["res"],
        t["live"], t["u1"], t["u2"], t["urr"], torch.from_numpy(flags), **kw,
    )


@pytest.mark.parametrize("case", list(CASES))
def test_segment_matches_jax_kernel(tables, case):
    _, ws, rows = tables
    x = _inputs(seed=len(case))
    kw = _kw(case)
    flags = np.asarray(CASES[case]["flags"], np.float32).reshape(3, 1)
    before = profiling.launches()
    got = _port(rows, x, flags, kw)
    assert profiling.launches() - before == {}  # CPU tensors: plain version
    want = JF.mega_segment_fwd(
        ws, rows, x["pos"], x["dir"], x["tput"], x["res"], jnp.asarray(x["live"]),
        x["u1"], x["u2"], x["urr"], flags, t_chunk=T_CHUNK, interpret=True, **kw,
    )
    rep = compare_segment(
        want, got, live=x["live"], rows=rows, pos=x["pos"], dir_=x["dir"],
        tol={"npos": (1e-5, 1e-3), "ndir": (1e-5, 1e-3)},
    )
    assert rep["ok"], rep
    assert rep["n_live"] > 0.85 * R
    # The inputs exercise hits, misses and surviving paths.
    idx = got[0].numpy()
    assert 0.5 < (idx >= 0).mean() < 1.0
    if case in ("fixed", "rr_roulette", "phong_reflect"):
        assert got[5].numpy().mean() > 0.3


@pytest.mark.parametrize("case", list(CASES))
def test_segment_matches_jax_plain_rows(tables, case):
    """At the same winners, the port's epilogue equals the JAX package's
    plain-f32 segment semantics (``_recompute_rows`` + ``_epilogue_core``)
    to 1e-5."""
    _, _, rows = tables
    x = _inputs(seed=100 + len(case))
    kw = _kw(case)
    flags = np.asarray(CASES[case]["flags"], np.float32).reshape(3, 1)
    got = _port(rows, x, flags, kw)
    idx = got[0].numpy()
    hit = jnp.asarray(idx >= 0)
    full = rows[np.maximum(idx, 0)].T
    rows3 = lambda a: (jnp.asarray(a[0]), jnp.asarray(a[1]), jnp.asarray(a[2]))  # noqa: E731
    pos, dir_ = rows3(x["pos"]), rows3(x["dir"])
    t, beta, gamma, shade = JF._recompute_rows(
        tuple(jnp.asarray(r) for r in full), hit, pos, dir_
    )
    npos, ndir, ntput, nres, still = JF._epilogue_core(
        pos, dir_, rows3(x["tput"]), rows3(x["res"]), t, beta, gamma, shade,
        hit=hit, act=jnp.asarray(x["live"]),
        u1=jnp.asarray(x["u1"]), u2=jnp.asarray(x["u2"]), urr=jnp.asarray(x["urr"]),
        fg=flags[0, 0] > 0, do_rr=flags[1, 0] > 0, hard_kill=flags[2, 0] > 0,
        **kw,
    )
    want = (idx, np.stack(npos), np.stack(ndir), np.stack(ntput), np.stack(nres),
            np.asarray(still, np.float32))
    rep = compare_segment(want, got, live=x["live"], rows=rows, pos=x["pos"],
                          dir_=x["dir"])
    assert rep["ok"], rep


def test_pack_rows_full_matches_jax(tables):
    js, _, rows_j = tables
    ts = convert.scene_from_numpy({f: np.asarray(getattr(js, f)) for f in FIELDS})
    rows_t = F.pack_rows_full(ts).numpy()
    valid = np.asarray(js.tri_valid)
    T = valid.shape[0]
    assert rows_t.shape == (T, 48)
    np.testing.assert_allclose(rows_t[valid], rows_j[:T][valid], rtol=1e-6, atol=1e-6)
    assert not rows_t[~valid, 0:12].any()  # invalid geometry is zeroed


def test_mega_segment_refuses_bad_device_and_options(tables):
    x = torch.empty(3, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        F.mega_segment(torch.empty(2, 48, device="meta"), x, x, x, x,
                       torch.empty(4, dtype=torch.bool, device="meta"),
                       x[0], x[0], x[0], torch.empty(3, 1, device="meta"))
    _, _, rows = tables
    t = {k: torch.from_numpy(np.array(v)) for k, v in _inputs(0).items()}
    args = (torch.from_numpy(rows.copy()), t["pos"], t["dir"], t["tput"], t["res"],
            t["live"], t["u1"], t["u2"], t["urr"], torch.zeros(3, 1))
    with pytest.raises(ValueError, match="mode"):
        F.mega_segment(*args, mode="bogus")
    with pytest.raises(ValueError, match="phong_model"):
        F.mega_segment(*args, phong_model="bogus")
