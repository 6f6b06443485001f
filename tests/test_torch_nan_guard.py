"""NaN guard of the port: the counterpart of ``tests/test_nan_guard.py``.

Under :func:`montecarlopathtracer_tpu_torch.testing.nan_trap` (the
counterpart of ``jax_debug_nans``) any operation that makes a NaN
raises, even one whose NaN a later ``where`` masks away, so the guards
under test must keep NaNs from ever being made. On the CPU every kernel
wrapper runs its plain version."""

import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu_torch.diff.grad import make_loss_fn, split_params, value_and_grad
from montecarlopathtracer_tpu_torch.models import cornell
from montecarlopathtracer_tpu_torch.ops.rng import make_key
from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig, render_sample_batch
from montecarlopathtracer_tpu_torch.testing import NaNTrapped, cap_torch_threads, nan_trap

cap_torch_threads()


def test_trap_fires_on_a_masked_nan_forward_and_backward():
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    with pytest.raises(NaNTrapped, match="div"):
        with nan_trap():
            torch.where(x > 0, x / x, torch.zeros(()))
    with pytest.raises(NaNTrapped):
        with nan_trap():
            (torch.sqrt(x) * 0.0).sum().backward()  # finite forward, 0 * inf backward
    with nan_trap():
        torch.empty(4).fill_(1.0)  # uninitialised memory is not a result


@pytest.mark.parametrize("intersector", ["megakernel", "brute"])
@pytest.mark.parametrize("mode", ["fixed", "rr"])
def test_render_produces_no_nans_under_the_trap(mode, intersector):
    scene, cam = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                     width=16, height=16)
    cfg = TraceConfig(mode=mode, max_depth=4, rr_depth=2, ray_chunk=0, intersector=intersector)
    with nan_trap():
        img = render_sample_batch(scene, cam, make_key(1), 16, 16, cfg)
    assert tuple(img.shape) == (16, 16, 3)
    assert bool(torch.isfinite(img).all())


@pytest.mark.parametrize("mode", ["fixed", "rr"])
def test_gradients_produce_no_nans_under_the_trap(mode):
    scene, cam = cornell.cornell_box(width=8, height=8)
    cfg = TraceConfig(mode=mode, max_depth=2, rr_depth=1, ray_chunk=0)
    loss_fn = make_loss_fn(scene, cam, torch.zeros(8, 8, 3), width=8, height=8, spp=1,
                           config=cfg)
    params = split_params(scene, ("mat_kd", "mat_ka", "vertices"))
    with nan_trap(), torch.autograd.detect_anomaly(check_nan=True):
        loss, grads = value_and_grad(loss_fn, params, make_key(2))
    assert np.isfinite(float(loss))
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k


def test_vertex_grads_finite_through_megakernel_fresnel():
    """The JAX package's r4 regression: at the TIR/grazing boundary
    sqrt(max(x, 0))'s adjoint made 0·∞ = NaN in the Fresnel sampler's
    backward. Interior vertex gradients are exactly zero (the material
    model cancels every geometric factor), never NaN."""
    scene, cam = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                     width=16, height=16)
    cfg = TraceConfig(mode="fixed", max_depth=3, ray_chunk=0, intersector="megakernel")
    loss_fn = make_loss_fn(scene, cam, torch.zeros(16, 16, 3), width=16, height=16, spp=1,
                           config=cfg)
    _, g = value_and_grad(loss_fn, split_params(scene, ("vertices",)), make_key(3))
    gv = g["vertices"]
    assert bool(torch.isfinite(gv).all())
    assert float(gv.abs().max()) == 0.0
