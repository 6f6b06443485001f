"""Gradient renders of the port against the JAX package, on the CPU.

The port's ``diff.grad`` (plain path on CPU tensors: the segment
forward, its vjp and the row scatter in plain torch) against
``jax.value_and_grad`` of the JAX package's ``diff.grad`` with the same
seed, scene and loss; parameters and gradients cross through numpy
(``convert.params_from_numpy`` / ``params_to_numpy``).

Tolerances, per parameter, of ``|ref| + max |ref|``
(``compare_param_grads``):

- against the JAX brute intersector (exact f32 throughout): 1e-6
  (measured 6e-8 at 24x18, depth 3, 2 spp);
- against the JAX megakernel in interpret mode with
  ``remat_segments=False``: 5e-5 (measured 9e-6), because its backward
  scatters the row cotangents with ``terms=2``, a 2-term bf16 split
  that drops the last 8 mantissa bits of each.

The vertex gradient is exactly zero on both sides: path radiance is a
product of albedos and Ka, so it is piecewise constant in the geometry
(``tests/test_diff.py``, ``tests/test_nan_guard.py``).

Also ported from ``tests/test_diff.py``: the emitter and albedo
finite-difference checks and the SGD recovery.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu.diff import grad as JG
from montecarlopathtracer_tpu.models import cornell as jcornell
from montecarlopathtracer_tpu.render.integrator import TraceConfig as JTraceConfig
from montecarlopathtracer_tpu_torch import convert
from montecarlopathtracer_tpu_torch.diff import grad as G
from montecarlopathtracer_tpu_torch.models import cornell
from montecarlopathtracer_tpu_torch.ops.rng import make_key
from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
from montecarlopathtracer_tpu_torch.testing import cap_torch_threads, compare_param_grads

cap_torch_threads()

FIELDS = ("mat_kd", "mat_ka", "vertices")


@pytest.mark.parametrize(
    "jcfg,tol",
    [
        (dict(intersector="brute"), 1e-6),
        (dict(intersector="megakernel", pallas_interpret=True, remat_segments=False), 5e-5),
    ],
    ids=["brute", "megakernel"],
)
def test_render_gradients_match_jax(jcfg, tol):
    W, H = 24, 18
    js, jcam = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                    width=W, height=H)
    ts, tcam = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                   width=W, height=H)
    target = np.random.RandomState(0).uniform(0, 1, (H, W, 3)).astype(np.float32)
    jloss_fn = JG.make_loss_fn(js, jcam, jnp.asarray(target), width=W, height=H, spp=2,
                               config=JTraceConfig(max_depth=3, ray_chunk=0, **jcfg))
    jloss, jgrads = jax.value_and_grad(jloss_fn)(JG.split_params(js, FIELDS),
                                                 jax.random.key(3))
    want = {k: np.asarray(v) for k, v in jgrads.items()}
    # The JAX parameters cross to the port through numpy.
    params = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in JG.split_params(js, FIELDS).items()})
    loss_fn = G.make_loss_fn(ts, tcam, torch.from_numpy(target), width=W, height=H,
                             spp=2, config=TraceConfig(max_depth=3))
    loss, grads = G.value_and_grad(loss_fn, params, make_key(3))
    got = convert.params_to_numpy(grads)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    rep = compare_param_grads(want, got, tol)
    assert rep["ok"], rep
    assert np.abs(got["mat_kd"]).max() > 0 and np.abs(got["mat_ka"]).max() > 0
    assert np.abs(got["vertices"]).max() == 0.0 == np.abs(want["vertices"]).max()


W = H = 12
CFG = TraceConfig(max_depth=2)


def _scene():
    return cornell.cornell_box(width=W, height=H)


def _mean_brightness(field, key):
    scene, cam = _scene()

    def f(scale):
        params = {field: getattr(scene, field) * scale}
        return G.render_image(params, scene, cam, key, width=W, height=H, spp=2,
                              config=CFG).mean()

    return f


@pytest.mark.parametrize("field,seed,eps,rtol",
                         [("mat_ka", 0, 0.1, 1e-3), ("mat_kd", 1, 0.05, 2e-2)])
def test_gradient_matches_finite_difference(field, seed, eps, rtol):
    """Emission enters linearly and the sampling decisions do not depend
    on Ka or Kd, so AD and central FD agree (tests/test_diff.py)."""
    f = _mean_brightness(field, make_key(seed))
    s = torch.tensor(1.0, requires_grad=True)
    f(s).backward()
    with torch.no_grad():
        fd = (f(torch.tensor(1.0 + eps)) - f(torch.tensor(1.0 - eps))) / (2 * eps)
    np.testing.assert_allclose(float(s.grad), float(fd), rtol=rtol)
    assert float(s.grad) > 0.0


def test_sgd_recovers_albedo_direction():
    """Wall albedo started 40% low descends back toward the target's,
    with the target rendered under the step key (tests/test_diff.py)."""
    scene, cam = _scene()
    key = make_key(20)
    with torch.no_grad():
        target = G.render_image(G.split_params(scene, ("mat_kd",)), scene, cam, key,
                                width=W, height=H, spp=4, config=CFG)
    loss_fn = G.make_loss_fn(scene, cam, target, width=W, height=H, spp=4, config=CFG)
    step = G.make_sgd_step(loss_fn, lr=1.0)
    true_kd = scene.mat_kd.numpy()
    params = {"mat_kd": scene.mat_kd * 0.6}
    err0 = float(np.abs(params["mat_kd"].numpy() - true_kd).sum())
    losses = []
    for _ in range(5):
        params, loss = step(params, key)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    white0, white1 = 0.6 * true_kd[1], params["mat_kd"].numpy()[1]
    assert white1.mean() > white0.mean() + 1e-4, (white0, white1)
    assert (white1 >= white0 - 1e-6).all(), (white0, white1)
    assert float(np.abs(params["mat_kd"].numpy() - true_kd).sum()) < err0


RR = dict(mode="rr", rr_depth=1, illum=1.0)


def _rr_loss_fn(W, H):
    scene, cam = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                     width=W, height=H)
    return scene, G.make_loss_fn(scene, cam, torch.zeros(H, W, 3), width=W, height=H,
                                 spp=2, config=TraceConfig(**RR))


def test_rr_render_gradients_match_jax():
    """RR mode end to end against the JAX megakernel in interpret mode:
    roulette from the second bounce on tied grey throughput, the 1/p
    compensation and the hard kill, tolerance 5e-5 as above. (The JAX
    brute path takes RR's p with a ``jnp.max`` reduction, whose adjoint
    splits a tie otherwise; the port follows the megakernel's nested
    maximum, ROADMAP C5.) Kd is raised to at least 0.05 on both sides:
    with the box's pure red and blue walls a throughput reaches exactly
    0, where JAX's gradient is NaN (ROADMAP C7, next test)."""
    W, H = 16, 12
    js, jcam = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                    width=W, height=H)
    jparams = JG.split_params(js, FIELDS)
    jparams["mat_kd"] = jnp.maximum(jparams["mat_kd"], 0.05)
    jloss_fn = JG.make_loss_fn(js, jcam, jnp.zeros((H, W, 3)), width=W, height=H, spp=2,
                               config=JTraceConfig(intersector="megakernel", ray_chunk=0,
                                                   pallas_interpret=True,
                                                   remat_segments=False, **RR))
    jloss, jgrads = jax.value_and_grad(jloss_fn)(jparams, jax.random.key(5))
    _, loss_fn = _rr_loss_fn(W, H)
    params = convert.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()})
    loss, grads = G.value_and_grad(loss_fn, params, make_key(5))
    got = convert.params_to_numpy(grads)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    rep = compare_param_grads({k: np.asarray(v) for k, v in jgrads.items()}, got, 5e-5)
    assert rep["ok"], rep
    assert np.abs(got["mat_kd"]).max() > 0 and np.abs(got["vertices"]).max() == 0.0


def test_rr_gradients_finite_at_zero_throughput():
    """A path off the red wall onto the blue one carries throughput
    exactly (0, 0, 0), so RR's p is 0. The reference's compensation
    ``tput / max(p, 1e-20)`` under a ``where`` then forms 0 / (1e-20)²,
    which underflows to 0 / 0, and JAX's gradient of every wall's Kd is
    NaN (ROADMAP C7). The port's gradients stay finite."""
    scene, loss_fn = _rr_loss_fn(16, 12)
    loss, grads = G.value_and_grad(loss_fn, G.split_params(scene, FIELDS), make_key(5))
    assert torch.isfinite(loss)
    for k in FIELDS:
        assert torch.isfinite(grads[k]).all(), k
    assert grads["mat_kd"][1:3].abs().max() > 0.0


def test_forward_paths_build_no_graph():
    """The Renderer and a render under no_grad call the forward segment
    directly; a render with grad on goes through WholeSegment."""
    scene, cam = _scene()
    r = Renderer(scene, cam, CFG, RenderSettings(width=W, height=H, spp_per_pass=1, seed=0),
                 device="cpu")
    r.render(1)
    assert not r.film.color.requires_grad
    params = {"mat_kd": scene.mat_kd.clone().requires_grad_(True)}
    img = G.render_image(params, scene, cam, make_key(0), width=W, height=H, spp=1,
                         config=CFG)
    assert img.grad_fn is not None
    with torch.no_grad():
        img = G.render_image(params, scene, cam, make_key(0), width=W, height=H, spp=1,
                             config=CFG)
    assert img.grad_fn is None


def test_params_round_trip_and_options():
    scene, _ = _scene()
    p = convert.params_to_numpy(G.split_params(scene, FIELDS))
    back = convert.params_from_numpy(p)
    for k in FIELDS:
        assert torch.equal(back[k], getattr(scene, k))
    with pytest.raises(ValueError, match="differentiable"):
        G.split_params(scene, ("tri_v",))
