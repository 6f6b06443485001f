"""Scene, camera and transforms of the port against the JAX package,
and the port's independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu.models import cornell as jcornell
from montecarlopathtracer_tpu.ops import intersect as jintersect
from montecarlopathtracer_tpu.scene import objio as jobjio
from montecarlopathtracer_tpu.scene.scene import scene_pack_from_model as jpack
from montecarlopathtracer_tpu_torch import convert
from montecarlopathtracer_tpu_torch.models import cornell
from montecarlopathtracer_tpu_torch.ops import intersect
from montecarlopathtracer_tpu_torch.scene import camera as tcamera
from montecarlopathtracer_tpu_torch.scene import objio
from montecarlopathtracer_tpu_torch.scene.scene import FIELDS, load_obj_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_scene_numpy(scene):
    return {f: np.asarray(getattr(scene, f)) for f in FIELDS}


@pytest.mark.parametrize("spheres", [False, True])
def test_converted_jax_scene_matches_port_scene(spheres):
    js, _ = jcornell.cornell_box(
        with_mirror_sphere=spheres, with_glass_sphere=spheres
    )
    conv = convert.scene_from_numpy(_jax_scene_numpy(js))
    ts, _ = cornell.cornell_box(
        with_mirror_sphere=spheres, with_glass_sphere=spheres
    )
    T = ts.num_triangles
    # The JAX pack pads the triangle axis to 128 with invalid triangles
    # at the end; the port's pack does not pad.
    assert conv.num_triangles == -(-T // 128) * 128
    assert bool(conv.tri_valid[:T].all()) and not bool(conv.tri_valid[T:].any())
    for f in FIELDS:
        a, b = getattr(conv, f), getattr(ts, f)
        if f.startswith("tri_"):
            a = a[:T]
        assert a.dtype == b.dtype, f
        assert torch.equal(a, b), f


def test_aabb_matches_jax():
    js, _ = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True)
    for ts in (convert.scene_from_numpy(_jax_scene_numpy(js)),
               cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True)[0]):
        for got, want in zip(ts.aabb(), js.aabb()):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_triangle_transforms_match_jax():
    js, _ = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True)
    m_j, ma_j = jintersect.triangle_transforms(*js.triangle_vertices())
    ts = convert.scene_from_numpy(_jax_scene_numpy(js))
    m_t, ma_t = intersect.triangle_transforms(*ts.triangle_vertices())
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ma_t.numpy(), np.asarray(ma_j), rtol=1e-6, atol=1e-6)


def test_intersect_brute_matches_jax():
    js, _ = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True)
    ts = convert.scene_from_numpy(_jax_scene_numpy(js))
    rs = np.random.RandomState(1)
    o = rs.uniform([-5.5, 0.5, -5.5], [5.5, 9.5, 5.5], (500, 3)).astype(np.float32)
    d = rs.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    m_j, ma_j = jintersect.triangle_transforms(*js.triangle_vertices())
    hj = jintersect.intersect_brute(m_j, ma_j, js.tri_valid, o, d)
    m_t, ma_t = intersect.triangle_transforms(*ts.triangle_vertices())
    ht = intersect.intersect_brute(
        m_t, ma_t, ts.tri_valid, torch.from_numpy(o), torch.from_numpy(d),
        ray_chunk=128,
    )
    np.testing.assert_array_equal(ht.tri_id.numpy(), np.asarray(hj.tri_id))
    hit = ht.tri_id.numpy() >= 0
    for name in ("t", "beta", "gamma"):
        np.testing.assert_allclose(
            getattr(ht, name).numpy()[hit], np.asarray(getattr(hj, name))[hit],
            rtol=1e-5, atol=1e-5, err_msg=name,
        )


@pytest.mark.parametrize("which", ["scene1", "mcrt"])
def test_generate_rays_soa_matches_jax(which):
    from montecarlopathtracer_tpu.scene import camera as jcamera

    W, H = 40, 30
    if which == "scene1":
        jc = jcamera.camera_for_scene(1, W, H)
        tc = tcamera.camera_for_scene(1, W, H)
    else:
        jc = jcamera.camera_for_mcrt(W, H)
        tc = tcamera.camera_for_mcrt(W, H)
    conv = convert.camera_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in convert.CAMERA_FIELDS},
        jitter=jc.jitter,
    )
    for f in convert.CAMERA_FIELDS:
        np.testing.assert_allclose(getattr(tc, f).numpy(), getattr(conv, f).numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert tc.jitter == jc.jitter
    rs = np.random.RandomState(2)
    pix = np.arange(W * H)
    xs, ys = pix % W, pix // W
    jx, jy = (rs.uniform(-1, 1, W * H).astype(np.float32) for _ in range(2))
    oj, dj = jc.generate_rays_soa(xs, ys, jx, jy, W, H)
    ot, dt = tc.generate_rays_soa(*map(torch.from_numpy, (xs, ys, jx, jy)), W, H)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)


def test_obj_parser_and_pack_match_jax(tmp_path):
    (tmp_path / "s.mtl").write_text(
        "newmtl a\nKd 0.5 0.5 0.5\nKs 1 1 1\nnewmtl lamp\nKa 1 1 1\n"
        "newmtl glass\nTr 0.9\nNi 1.5\nKs 1 1 1\nNs 1000\n"
    )
    (tmp_path / "s.obj").write_text(
        "mtllib s.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\n"
        "g quad\nusemtl a\nf 1//1 2//1 3//1 4//1\n"
        "g lamp\nusemtl lamp\nf 1 2 \\\n3\n"
        "g other\nusemtl glass\nf 2 3 4\nusemtl missing\nf 1 3 4\n"
    )
    path = str(tmp_path / "s.obj")
    mj = jobjio.read_obj(path, backend="python")
    mt = objio.read_obj(path)
    for f in ("vertices", "normals", "groups"):
        assert getattr(mt, f) == getattr(mj, f), f
    assert [vars(t) for t in mt.triangles] == [vars(t) for t in mj.triangles]
    assert [vars(m) for m in mt.materials] == [vars(m) for m in mj.materials]
    for mode in ("group", "triangle"):
        conv = convert.scene_from_numpy(_jax_scene_numpy(jpack(mj, material_mode=mode)))
        ts = load_obj_scene(path, material_mode=mode)
        T = ts.num_triangles
        for f in FIELDS:
            a = getattr(conv, f)
            assert torch.equal(a[:T] if f.startswith("tri_") else a,
                               getattr(ts, f)), (mode, f)


def test_port_imports_no_jax():
    """Every module of the port imports without JAX."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import montecarlopathtracer_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 20, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('montecarlopathtracer_tpu.')"
        " or m == 'montecarlopathtracer_tpu']\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
