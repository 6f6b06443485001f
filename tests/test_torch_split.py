"""The port's split path against the JAX package's, on the CPU.

- The split path's intersector (B4, and B4c on a Morton-ordered table):
  the port's plain version ``nearest_shade_full_ref`` against JAX
  ``nearest_shade_full`` in interpret mode (``testing.compare_shade``).
  Winners agree on every live lane and the shading rows are equal. t, β
  and γ are held to rtol 1e-5, atol 1e-3 against the Pallas kernel, whose
  approximate reciprocal and one Newton step leave ~1.5e-5 relative
  error in t in interpret mode (measured max 3.7e-4), and to 1e-5 against
  JAX's exact-division ``_recompute_winner`` at the same winners
  (measured equal).
- Split renders (``whole_segment=False``, and the ``brute`` and
  ``fused`` intersectors) against the JAX package's split path, fixed and
  RR, at 32x24, depth 2 (``testing.compare_images``; measured equal).
- Split-path gradients against ``jax.value_and_grad`` of the JAX
  package's split path, per parameter within ``tol`` of |ref| + max |ref|:
  1e-6 against the brute oracle and the fused intersector (exact f32 on
  both sides; measured ≤ 1e-7), 5e-5 against the megakernel and the
  traversal walk in interpret mode (their backward scatters row
  cotangents with a 2-term bf16 split).
  The RR case renders the Cornell box, whose white walls give tied grey
  throughput: JAX's split body takes RR's p with ``jnp.max``, whose
  adjoint splits a three-way tie in thirds; the whole segment's nested
  maximum (0.25 / 0.25 / 0.5) would miss the 1e-6 bound.
- RR on the split path at zero throughput (ROADMAP C7): finite gradients
  where JAX's are NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu.diff import grad as JG
from montecarlopathtracer_tpu.models import cornell as jcornell
from montecarlopathtracer_tpu.ops import intersect_pallas as JP
from montecarlopathtracer_tpu.ops.intersect import triangle_transforms
from montecarlopathtracer_tpu.render.integrator import (
    TraceConfig as JTraceConfig,
    render_sample_batch as jax_render_sample_batch,
)
from montecarlopathtracer_tpu_torch import convert
from montecarlopathtracer_tpu_torch.diff import grad as G
from montecarlopathtracer_tpu_torch.models import cornell
from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
from montecarlopathtracer_tpu_torch.ops.rng import make_key
from montecarlopathtracer_tpu_torch.render.integrator import (
    TraceConfig,
    make_intersect_shade,
    render_sample_batch,
    scene_tables,
)
from montecarlopathtracer_tpu_torch.testing import (
    cap_torch_threads,
    compare_images,
    compare_param_grads,
    compare_shade,
)
from montecarlopathtracer_tpu_torch.utils import profiling

cap_torch_threads()

R = 3000  # not a multiple of the JAX kernel's 512-ray tile


def _rays(seed):
    """Half camera rays from the scene-1 eye, half rays from inside the
    box in random directions; ~10% of lanes dead."""
    rs = np.random.RandomState(seed)
    h = R // 2
    pos = np.empty((3, R), np.float32)
    dirs = np.empty((3, R), np.float32)
    pos[:, :h] = np.array([[0.0], [5.0], [17.0]])
    dirs[:, :h] = rs.uniform([-6, 0, -6], [6, 10, 6], (h, 3)).T - pos[:, :h]
    pos[:, h:] = rs.uniform([-5.9, 0.1, -5.9], [5.9, 9.9, 5.9], (R - h, 3)).T
    dirs[:, h:] = rs.normal(size=(3, R - h))
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    return pos, dirs, rs.uniform(size=R) > 0.1


@pytest.fixture(scope="module")
def jax_box():
    js, _ = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True)
    a, b, c = js.triangle_vertices()
    m, m_a = triangle_transforms(a, b, c)
    return js, (a, b, c), m, m_a


@pytest.mark.parametrize("cull", [False, True], ids=["B4", "B4c"])
def test_nearest_shade_full_plain_matches_jax(jax_box, cull):
    js, (a, b, c), m, m_a = jax_box
    if cull:
        perm = JP.morton_order(a, b, c, js.tri_valid)
        ws = JP.pack_transforms_stream(m[perm], m_a[perm], js.tri_valid[perm], 128)
        rows = JP.pack_rows_full(m[perm], m_a[perm], js, 128, perm=perm)
        clo, chi = JP.chunk_aabbs_padded(a, b, c, js.tri_valid, perm, 128)
    else:
        ws = JP.pack_transforms_stream(m, m_a, js.tri_valid, 256)
        rows = JP.pack_rows_full(m, m_a, js, 256)
        clo = chi = None
    pos, dirs, live = _rays(seed=1 + cull)
    want = JP.nearest_shade_full(ws, rows, jnp.asarray(pos), jnp.asarray(dirs),
                                 jnp.asarray(live), clo, chi, ray_tile=512,
                                 t_chunk=128 if cull else 256, cull=cull, interpret=True)
    want = tuple(map(np.asarray, want))
    rows = np.asarray(rows)
    t = {k: torch.from_numpy(v.copy()) for k, v in
         dict(rows=rows, pos=pos, dirs=dirs, live=live).items()}
    boxes = dict(clo=torch.tensor(np.asarray(clo)),
                 chi=torch.tensor(np.asarray(chi))) if cull else {}
    before = profiling.launches()
    got = NS.nearest_shade_full(t["rows"], t["pos"], t["dirs"], t["live"], **boxes)
    assert profiling.launches() - before == {}  # CPU tensors: the plain version
    assert got[0].dtype == torch.int32 and got[1].shape == (4, R) and got[2].shape == (32, R)
    rep = compare_shade(got, want, live=live, rows=rows, pos=pos, dir_=dirs, tol=(1e-5, 1e-3))
    assert rep["ok"], rep
    assert rep["idx_agree"] == 1.0 and 0.5 < (got[0].numpy()[live] >= 0).mean() < 1.0
    # At the same winners, JAX's exact-division recompute gives t, β, γ to 1e-5.
    tbg, shade = JP._recompute_winner(jnp.asarray(rows), jnp.asarray(got[0].numpy()),
                                      jnp.asarray(pos), jnp.asarray(dirs))
    rep = compare_shade(got, (got[0].numpy(), np.asarray(tbg), np.asarray(shade)),
                        live=live, rows=rows, pos=pos, dir_=dirs)
    assert rep["ok"], rep
    # Dead lanes come back as misses.
    assert (got[0].numpy()[~live] == -1).all() and not got[2].numpy()[:, ~live].any()


def test_recompute_winner_matches_kernel_values(jax_box):
    """The differentiable recompute at the plain selection's winners
    equals its values (t, β, γ by the same exact division)."""
    js, _, m, m_a = jax_box
    rows = torch.from_numpy(np.asarray(JP.pack_rows_full(m, m_a, js, 256)))
    pos, dirs, live = map(torch.from_numpy, _rays(seed=3))
    idx, tbg, shade = NS.nearest_shade_full(rows, pos, dirs, live)
    tbg2, shade2 = NS.recompute_winner(rows, idx, pos, dirs)
    torch.testing.assert_close(tbg2, tbg, rtol=1e-6, atol=1e-6)
    assert torch.equal(shade2, shade)


FIXED = dict(max_depth=2)
RR = dict(mode="rr", rr_depth=1, illum=1.0, refract_kd=False)
SPLIT = {
    "megakernel": dict(intersector="megakernel", whole_segment=False),
    "megakernel_cull": dict(intersector="megakernel", whole_segment=False, chunk_cull=True),
    "traverse": dict(intersector="traverse", whole_segment=False),
    "brute": dict(intersector="brute"),
    "fused": dict(intersector="fused"),
}


def _boxes(W, H):
    return (*jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                  width=W, height=H),
            *cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                 width=W, height=H))


@pytest.mark.parametrize("mode", [FIXED, RR], ids=["fixed", "rr"])
@pytest.mark.parametrize("path", list(SPLIT))
def test_split_render_matches_jax(path, mode):
    W, H = 32, 24
    js, jcam, ts, tcam = _boxes(W, H)
    kw = {**SPLIT[path], **mode}
    want = jax_render_sample_batch(js, jcam, jax.random.key(3), W, H,
                                   JTraceConfig(pallas_interpret=True, ray_chunk=0, **kw))
    before = profiling.launches()
    got = render_sample_batch(ts, tcam, make_key(3), W, H, TraceConfig(**kw))
    assert profiling.launches() - before == {}
    rep = compare_images(got.numpy(), np.asarray(want))
    assert rep["ok"], rep
    assert np.asarray(want).mean() > 0.0
    # The split path computes what the whole segment computes.
    if path != "brute":
        assert compare_images(got.numpy(), render_sample_batch(
            ts, tcam, make_key(3), W, H, TraceConfig(**mode)).numpy())["ok"]


def test_intersect_shade_miss_contract():
    """Misses on the megakernel path carry +Y normals and Ni = 1, and
    their t (3e38) never reaches the hit point (JAX integrator.py:537-553);
    the brute path's misses have t = inf and point = origin."""
    ts, _ = cornell.cornell_box()
    pos = torch.tensor([[0.0, 0.0], [5.0, 5.0], [17.0, 17.0]])
    # Out of the open front; into the back wall at (1, 3, -6).
    dirs = torch.tensor([[0.0, 1.0], [0.0, -2.0], [1.0, -23.0]])
    dirs = dirs / dirs.norm(dim=0)
    for cfg in (TraceConfig(whole_segment=False), TraceConfig(intersector="brute")):
        s = make_intersect_shade(ts, cfg, scene_tables(ts, cfg))(pos, dirs)
        assert s["miss"].tolist() == [True, False]
        assert torch.equal(s["point"][:, 0], pos[:, 0])
        assert torch.isfinite(s["point"]).all() and float(s["t"][1]) == pytest.approx(534 ** 0.5)
        if cfg.intersector == "megakernel":
            assert s["t"][0] == torch.tensor(3e38) and float(s["ni"][0]) == 1.0
            assert s["n0"][:, 0].tolist() == [0.0, 1.0, 0.0]
        else:
            assert float(s["t"][0]) == float("inf")


FIELDS = ("mat_kd", "mat_ka", "vertices")
GRAD_CASES = {
    "brute": (dict(intersector="brute"), FIXED, 1e-6),
    "brute_rr_tied": (dict(intersector="brute"), dict(mode="rr", rr_depth=1, illum=1.0),
                      1e-6),
    "fused": (dict(intersector="fused"), FIXED, 1e-6),
    "megakernel": (dict(intersector="megakernel", whole_segment=False,
                        remat_segments=False), FIXED, 5e-5),
    "megakernel_cull_rr": (dict(intersector="megakernel", whole_segment=False,
                                chunk_cull=True, remat_segments=False),
                           dict(mode="rr", rr_depth=1, illum=1.0), 5e-5),
    "traverse": (dict(intersector="traverse", whole_segment=False), FIXED, 5e-5),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_split_gradients_match_jax(case):
    jkw, mode, tol = GRAD_CASES[case]
    W, H = 16, 12
    js, jcam, ts, tcam = _boxes(W, H)
    jparams = JG.split_params(js, FIELDS)
    if mode.get("mode") == "rr":
        # Pure red and blue walls make a zero throughput, where JAX's RR
        # gradient is NaN (ROADMAP C7, the next test).
        jparams["mat_kd"] = jnp.maximum(jparams["mat_kd"], 0.05)
    target = np.random.RandomState(1).uniform(0, 1, (H, W, 3)).astype(np.float32)
    jloss_fn = JG.make_loss_fn(js, jcam, jnp.asarray(target), width=W, height=H, spp=2,
                               config=JTraceConfig(ray_chunk=0, pallas_interpret=True,
                                                   **jkw, **mode))
    jloss, jgrads = jax.value_and_grad(jloss_fn)(jparams, jax.random.key(5))
    kw = {k: v for k, v in jkw.items() if k != "remat_segments"}
    loss_fn = G.make_loss_fn(ts, tcam, torch.from_numpy(target), width=W, height=H, spp=2,
                             config=TraceConfig(**kw, **mode))
    params = convert.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()})
    loss, grads = G.value_and_grad(loss_fn, params, make_key(5))
    got = convert.params_to_numpy(grads)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    rep = compare_param_grads({k: np.asarray(v) for k, v in jgrads.items()}, got, tol)
    assert rep["ok"], rep
    assert np.abs(got["mat_kd"]).max() > 0 and np.abs(got["mat_ka"]).max() > 0
    assert np.abs(got["vertices"]).max() == 0.0


@pytest.mark.parametrize("intersector", ["megakernel", "brute"])
def test_split_rr_gradients_finite_at_zero_throughput(intersector):
    """A path off the red wall onto the blue one carries throughput
    exactly 0, so RR's p is 0 on the split path too (JAX
    integrator.py:783-787 forms 0 / 0 there, ROADMAP C7). The port
    divides only where the compensation is selected. (Kd's gradient is
    zero here: under RR every path's throughput is renormalised by its
    maximum, and with amax's symmetric tie rule grey Kd cancels.)"""
    W, H = 16, 12
    scene, cam = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                     width=W, height=H)
    cfg = TraceConfig(intersector=intersector, whole_segment=False, mode="rr", rr_depth=1,
                      illum=1.0)
    loss_fn = G.make_loss_fn(scene, cam, torch.zeros(H, W, 3), width=W, height=H, spp=2,
                             config=cfg)
    loss, grads = G.value_and_grad(loss_fn, G.split_params(scene, FIELDS), make_key(5))
    whole = G.make_loss_fn(scene, cam, torch.zeros(H, W, 3), width=W, height=H, spp=2,
                           config=TraceConfig(mode="rr", rr_depth=1, illum=1.0))
    assert float(loss) == pytest.approx(float(whole(G.split_params(scene, FIELDS),
                                                    make_key(5))), rel=1e-6)
    assert torch.isfinite(loss)
    for k in FIELDS:
        assert torch.isfinite(grads[k]).all(), k
    assert grads["mat_ka"].abs().max() > 0.0
