"""The port's regenerating wavefront against the JAX package's, on the CPU.

- The segment with per-lane flags (B1l): the plain ``mega_segment`` on
  f32[3, R] flags against JAX ``mega_segment_fwd(lane_flags=True)`` in
  interpret mode, with the tolerances of ``tests/test_torch_segment.py``
  (npos and ndir to atol 1e-3 against the kernel's approximate
  reciprocal, everything to 1e-5 against the JAX package's plain-f32
  ``_recompute_rows`` + ``_epilogue_core``); and lane flags that are all
  equal give exactly the scalar-flag segment.
- ``render_regen_planar`` at spp = 1 is bit-identical to the port's scan
  (fixed and RR on the megakernel path, fixed on the traversal path), as
  ``tests/test_regen.py`` holds the JAX package's.
- The port's regen against the JAX package's, same key, at 24x18 with
  spp = 1 and 3, and a regen Renderer pass against the JAX Renderer's:
  the frame gate (``testing.compare_images``: 99% of pixels within
  1e-4, means within 1e-3).
- Statistics at spp = 8 against 8 scan samples (as ``tests/test_regen.py``).
- ``ray_chunk`` with regen is refused, by the function and by the CLI
  (exit 2), not dropped.
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
from montecarlopathtracer_tpu.render.integrator import TraceConfig as JTraceConfig
from montecarlopathtracer_tpu.render.regen import render_regen_planar as jax_regen
from montecarlopathtracer_tpu.render.renderer import (
    Renderer as JRenderer,
    RenderSettings as JRenderSettings,
)
from montecarlopathtracer_tpu_torch import cli
from montecarlopathtracer_tpu_torch.models import cornell
from montecarlopathtracer_tpu_torch.ops import segment_fused as F
from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key
from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig, render_rows_planar
from montecarlopathtracer_tpu_torch.render.regen import render_regen_planar
from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
from montecarlopathtracer_tpu_torch.testing import (
    cap_torch_threads,
    compare_images,
    compare_segment,
)

cap_torch_threads()

T_CHUNK = 256
R = 3000


@pytest.fixture(scope="module")
def tables():
    js, _ = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True)
    m, m_a = triangle_transforms(*js.triangle_vertices())
    ws = pack_transforms_stream(m, m_a, js.tri_valid, T_CHUNK)
    rows = np.asarray(jax_pack_rows_full(m, m_a, js, T_CHUNK))
    return ws, rows


def _inputs(seed):
    """Camera rays and rays from inside the box, random state, ~10% dead,
    and per-lane flags mixing final gather, roulette and hard kill."""
    rs = np.random.RandomState(seed)
    h = R // 2
    pos = np.empty((3, R), np.float32)
    pos[:, :h] = np.array([[0.0], [5.0], [17.0]])
    pos[:, h:] = rs.uniform([-5.9, 0.1, -5.9], [5.9, 9.9, 5.9], (R - h, 3)).T
    dirs = np.empty((3, R), np.float32)
    dirs[:, :h] = rs.uniform([-6, 0, -6], [6, 10, 6], (h, 3)).T - pos[:, :h]
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
        flags=(rs.uniform(size=(3, R)) < [[0.3], [0.5], [0.2]]).astype(np.float32),
    )


MODES = {"fixed": dict(mode="fixed"), "rr": dict(mode="rr", illum=1.0, refract_kd=False)}


def _kw(mode):
    return {**dict(illum=10.0, eps_offset=0.01, refract_kd=True, phong_model="blinn"),
            **MODES[mode]}


def _port(rows, x, flags, kw):
    t = {k: torch.from_numpy(np.array(x[k])) for k in
         ("pos", "dir", "tput", "res", "live", "u1", "u2", "urr")}
    return F.mega_segment(torch.from_numpy(rows.copy()), t["pos"], t["dir"], t["tput"],
                          t["res"], t["live"], t["u1"], t["u2"], t["urr"],
                          torch.from_numpy(np.ascontiguousarray(flags)), **kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_lane_flag_segment_matches_jax_kernel(tables, mode):
    ws, rows = tables
    x = _inputs(seed=len(mode))
    kw = _kw(mode)
    got = _port(rows, x, x["flags"], kw)
    want = JF.mega_segment_fwd(
        ws, rows, x["pos"], x["dir"], x["tput"], x["res"], jnp.asarray(x["live"]),
        x["u1"], x["u2"], x["urr"], x["flags"], t_chunk=T_CHUNK, interpret=True,
        lane_flags=True, **kw,
    )
    rep = compare_segment(want, got, live=x["live"], rows=rows, pos=x["pos"],
                          dir_=x["dir"], tol={"npos": (1e-5, 1e-3), "ndir": (1e-5, 1e-3)})
    assert rep["ok"], rep
    assert 0.2 < got[5].numpy().mean() < 0.9


@pytest.mark.parametrize("mode", list(MODES))
def test_lane_flag_segment_matches_jax_plain_rows(tables, mode):
    """At the same winners, per-lane predicates give the JAX package's
    plain-f32 segment (``_recompute_rows`` + ``_epilogue_core``) to 1e-5."""
    _, rows = tables
    x = _inputs(seed=10 + len(mode))
    kw = _kw(mode)
    got = _port(rows, x, x["flags"], kw)
    idx = got[0].numpy()
    hit = jnp.asarray(idx >= 0)
    full = rows[np.maximum(idx, 0)].T

    def rows3(a):
        return tuple(jnp.asarray(a[k]) for k in range(3))

    pos, dir_ = rows3(x["pos"]), rows3(x["dir"])
    t, beta, gamma, shade = JF._recompute_rows(tuple(jnp.asarray(r) for r in full), hit,
                                               pos, dir_)
    fl = jnp.asarray(x["flags"]) > 0
    npos, ndir, ntput, nres, still = JF._epilogue_core(
        pos, dir_, rows3(x["tput"]), rows3(x["res"]), t, beta, gamma, shade,
        hit=hit, act=jnp.asarray(x["live"]), u1=jnp.asarray(x["u1"]),
        u2=jnp.asarray(x["u2"]), urr=jnp.asarray(x["urr"]),
        fg=fl[0], do_rr=fl[1], hard_kill=fl[2], **kw,
    )
    want = (idx, np.stack(npos), np.stack(ndir), np.stack(ntput), np.stack(nres),
            np.asarray(still, np.float32))
    rep = compare_segment(want, got, live=x["live"], rows=rows, pos=x["pos"], dir_=x["dir"])
    assert rep["ok"], rep


def test_equal_lane_flags_give_the_scalar_segment(tables):
    _, rows = tables
    x = _inputs(seed=20)
    for flags in ([1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]):
        scalar = np.asarray(flags, np.float32).reshape(3, 1)
        a = _port(rows, x, scalar, _kw("rr"))
        b = _port(rows, x, np.repeat(scalar, R, axis=1), _kw("rr"))
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u.numpy(), v.numpy())


@pytest.mark.parametrize(
    "kw",
    [
        dict(mode="fixed", max_depth=3),
        dict(mode="rr", rr_depth=2, illum=1.0),
        dict(mode="fixed", max_depth=2, intersector="traverse"),
    ],
    ids=["fixed", "rr", "fixed_traverse"],
)
def test_regen_spp1_bit_identical_to_scan(kw):
    W, H = 32, 24
    scene, camera = cornell.cornell_box(width=W, height=H)
    cfg = TraceConfig(**kw)
    key = make_key(7)
    a = render_rows_planar(scene, camera, key, W, H, 0, H, cfg)
    b = render_regen_planar(scene, camera, key, W, H, 1, cfg)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert a.numpy().mean() > 0.0


@pytest.mark.parametrize("spp", [1, 3])
def test_regen_matches_jax(spp):
    W, H = 24, 18
    js, jcam = jcornell.cornell_box(width=W, height=H)
    ts, tcam = cornell.cornell_box(width=W, height=H)
    kw = dict(mode="rr", rr_depth=2, illum=1.0)
    want = jax_regen(js, jcam, jax.random.key(4), W, H, spp,
                     JTraceConfig(intersector="megakernel", pallas_interpret=True,
                                  ray_chunk=0, **kw))
    got = render_regen_planar(ts, tcam, make_key(4), W, H, spp, TraceConfig(**kw))
    rep = compare_images(got.permute(1, 2, 0).numpy(), np.asarray(want).transpose(1, 2, 0))
    assert rep["ok"], rep
    assert np.asarray(want).mean() > 0.0


def test_regen_renderer_pass_matches_jax():
    W, H, spp = 16, 12, 4
    js, jcam = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                    width=W, height=H)
    ts, tcam = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                   width=W, height=H)
    kw = dict(mode="rr", rr_depth=2, illum=1.0)
    jr = JRenderer(js, jcam, JTraceConfig(intersector="megakernel", pallas_interpret=True,
                                          ray_chunk=0, **kw),
                   JRenderSettings(width=W, height=H, spp_per_pass=spp, seed=3, regen=True))
    jr.render(1)
    r = Renderer(ts, tcam, TraceConfig(**kw),
                 RenderSettings(width=W, height=H, spp_per_pass=spp, seed=3, regen=True),
                 device="cpu")
    r.render(1)
    assert float(r.film.weight) == float(jr.film.weight) == spp
    rep = compare_images(r.film.color.numpy(), np.asarray(jr.film.color))
    assert rep["ok"], rep


def test_regen_multi_spp_statistics():
    W, H = 24, 18
    scene, camera = cornell.cornell_box(width=W, height=H)
    cfg = TraceConfig(mode="rr", rr_depth=2, illum=1.0)
    key = make_key(11)
    n = 8
    a = sum(render_rows_planar(scene, camera, fold_in(key, i), W, H, 0, H, cfg)
            for i in range(n)).numpy() / n
    b = render_regen_planar(scene, camera, key, W, H, n, cfg).numpy()
    # Same estimator, other iid streams: global means agree within the
    # Monte Carlo noise of ~3.5k samples (catches lost or doubled samples).
    assert abs(a.mean() - b.mean()) < 0.35 * a.mean() + 1e-4, (a.mean(), b.mean())
    assert np.isfinite(b).all() and (b >= 0).all()


def test_regen_refuses_ray_chunk(tmp_path, capsys):
    scene, camera = cornell.cornell_box(width=8, height=6)
    with pytest.raises(ValueError, match="ray_chunk"):
        render_regen_planar(scene, camera, make_key(0), 8, 6, 2, TraceConfig(ray_chunk=16))
    out = str(tmp_path / "r.png")
    rc = cli.main(["--device", "cpu", "--width", "8", "--height", "6", "--passes", "1",
                   "--regen", "on", "--ray-chunk", "16", "--out", out])
    assert rc == 2
    assert "--ray-chunk 16" in capsys.readouterr().err
    assert not (tmp_path / "r.png").exists()
