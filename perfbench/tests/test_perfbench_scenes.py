"""The configuration's scene is the published data, and the reference's
camera casts the program's rays."""

import numpy as np
import torch

import perfbench_testing as PT

from perfbench import harness
from perfbench.reference import tracer as R
from perfbench.scenes import polygons

CONF = harness.load_json(PT.ROOT / "perfbench/configs/cornell_box.json")


def _arrays():
    return polygons.build(**CONF["builder_args"])


def test_the_cornell_box_as_published():
    a = _arrays()
    assert a.num_triangles == CONF["triangles"] == 32
    A, B, C = (x.astype(np.float64) for x in a.corners())
    assert (np.linalg.norm(np.cross(B - A, C - A), axis=1) > 1.0).all()
    lo = np.minimum(np.minimum(A, B), C).min(axis=0)
    hi = np.maximum(np.maximum(A, B), C).max(axis=0)
    assert lo.tolist() == [0.0, 0.0, 0.0]
    assert np.allclose(hi, [556.0, 548.8, 559.2])
    # The light is the only emitter, a 130 x 105 quad 0.1 below the ceiling.
    emit = (a.mat_ka[a.tri_mat] > 0).any(axis=1)
    assert emit.sum() == 2
    light = np.concatenate([A[emit], B[emit], C[emit]])
    assert np.allclose(light[:, 1], 548.7)
    assert np.allclose(np.ptp(light, axis=0), [130.0, 0.0, 105.0])
    # Each face normal is a unit vector across its triangle's plane.
    n = a.normals[a.tri_n[:, 0]].astype(np.float64)
    assert np.allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)
    assert np.allclose(np.einsum("ij,ij->i", n, B - A), 0.0, atol=1e-3)


def test_the_films_height_sets_the_field_at_any_aspect():
    for W, H in ((800, 600), (640, 480), (600, 600)):
        ctx = harness.load_context("cornell_box.cvmc_launch", 1, 0.0, False, "cpu",
                                   {"width": W, "height": H})
        cam = R.make_camera(ctx.camera(), W, H, "cpu")
        assert abs(float(cam.tan_y) - 0.0125 / 0.035) < 1e-6


def test_camera_rays_equal_the_programs():
    from montecarlopathtracer_tpu_torch.scene.camera import Camera

    W, H = 40, 30
    ctx = harness.load_context("cornell_box.cvmc_launch", 1, 0.0, False, "cpu",
                               {"width": W, "height": H})
    c = ctx.camera()
    pc = Camera.look(c["eye"], c["forward"], c["up"], width=W, height=H,
                     fov_x_deg=c["fov_x_deg"], jitter=c["jitter"])
    rc = R.make_camera(c, W, H, "cpu")
    pix = torch.arange(W * H)
    u = torch.rand(2, W * H, generator=torch.Generator().manual_seed(1))
    o, d = R.camera_rays(rc, pix, u[0], u[1])
    po, pd = pc.generate_rays_soa(pix % W, pix // W, u[0] * 2 - 1, u[1] * 2 - 1, W, H)
    assert torch.equal(o, po)
    assert torch.allclose(d, pd, rtol=0, atol=2e-7)
