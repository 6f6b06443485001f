"""The port's KD tree (construction, native loader, walk, ``intersector="kdtree"``)
against the JAX package's, on the CPU.

- Construction: the port's flat arrays bit-equal to JAX's
  ``build_flat_kdtree(backend="python")`` (random soups of
  ``tests/test_kdtree.py``'s shapes, the Cornell box with both spheres and
  ``pad_leaf_to=8``), the port's native build (``native/mcpt_native.cpp``
  through the port's own loader) equal to its Python one, and the
  structural checks of ``validate_kdtree``.
- ``read_obj(backend="native")`` equals ``backend="python"`` on the quirky
  file of ``tests/test_native.py``.
- Walk: the port's ``intersect_kdtree`` against JAX's on the same tree
  (the native build's, carried over by ``convert.kdtree_from_numpy``):
  winners equal except near-ties (``testing.near_ties``), t within 1e-4
  relative where they agree (the products of the transform are summed in
  another order); and against the port's brute oracle on ≥ 99.5% of
  rays, as in ``tests/test_kdtree.py:65``.
- Render: a 24×18 ``intersector="kdtree"`` render against the JAX
  package's kdtree render of the same key (``testing.compare_images``);
  the kdtree gradient against ``jax.value_and_grad`` of the JAX package's
  brute path (the JAX kdtree walk is a while-loop and has no reverse
  mode), per parameter within 1e-6 of |ref| + max |ref|.
"""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu.accel import kdtree as JK
from montecarlopathtracer_tpu.diff import grad as JG
from montecarlopathtracer_tpu.models import cornell as jcornell
from montecarlopathtracer_tpu.ops import traverse as JT
from montecarlopathtracer_tpu.ops.intersect import triangle_transforms as jax_transforms
from montecarlopathtracer_tpu.render.integrator import (
    TraceConfig as JTraceConfig,
    render_sample_batch as jax_render_sample_batch,
)
from montecarlopathtracer_tpu_torch import cli, convert, native
from montecarlopathtracer_tpu_torch.accel import kdtree as K
from montecarlopathtracer_tpu_torch.diff import grad as G
from montecarlopathtracer_tpu_torch.models import cornell
from montecarlopathtracer_tpu_torch.ops.intersect import intersect_brute, triangle_transforms
from montecarlopathtracer_tpu_torch.ops.rng import make_key
from montecarlopathtracer_tpu_torch.ops.traverse import KDArrays, intersect_kdtree
from montecarlopathtracer_tpu_torch.render.integrator import (
    TraceConfig,
    render_sample_batch,
    scene_tables,
)
from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
from montecarlopathtracer_tpu_torch.scene.objio import read_obj
from montecarlopathtracer_tpu_torch.testing import (
    compare_images,
    compare_param_grads,
    near_ties,
)


def _random_soup(T, seed=0, spread=3.0):
    """The soup of ``tests/test_kdtree.py``."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-spread, spread, (T, 3)).astype(np.float32)
    b = a + rng.uniform(-1.0, 1.0, (T, 3)).astype(np.float32)
    c = a + rng.uniform(-1.0, 1.0, (T, 3)).astype(np.float32)
    return a, b, c


def _cornell_soup():
    js, _ = jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True)
    a, b, c = (np.asarray(x) for x in js.triangle_vertices())
    return a, b, c, np.asarray(js.tri_valid)


def _assert_flat_equal(got, want):
    for f in convert.KD_FIELDS:
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("T,seed", [(8, 0), (60, 1), (120, 2)])
def test_python_build_bit_equal_to_jax(T, seed):
    a, b, c = _random_soup(T, seed)
    got = K.build_flat_kdtree(a, b, c, backend="python")
    _assert_flat_equal(got, JK.build_flat_kdtree(a, b, c, backend="python"))
    tlo, thi = np.minimum(np.minimum(a, b), c), np.maximum(np.maximum(a, b), c)
    assert K.validate_kdtree(K.build_kdtree(a, b, c), tlo, thi, T).all()
    assert (got.node_skip > np.arange(got.num_nodes)).all()
    assert (got.node_skip <= got.num_nodes).all() and got.leaf_count.max() <= K.LEAF_MAX


def test_cornell_tree_native_equals_python_equals_jax():
    a, b, c, valid = _cornell_soup()
    assert native.available(), native.build_error()
    py = K.flatten_kdtree(K.build_kdtree(a, b, c, valid), pad_leaf_to=8)
    _assert_flat_equal(native.build_kdtree_native(a, b, c, valid, pad_leaf_to=8), py)
    _assert_flat_equal(py, JK.flatten_kdtree(JK.build_kdtree(a, b, c, valid), pad_leaf_to=8))
    assert len(py.leaf_tris) % 8 == 0


@pytest.mark.parametrize("T,seed", [(30, 0), (200, 1)])
def test_native_build_equals_python(T, seed, monkeypatch):
    a, b, c = _random_soup(T, seed)
    py = K.build_flat_kdtree(a, b, c, backend="python")
    _assert_flat_equal(K.build_flat_kdtree(a, b, c, backend="native"), py)
    monkeypatch.delenv("MCPT_NATIVE", raising=False)
    _assert_flat_equal(K.build_flat_kdtree(a, b, c), py)  # auto: native
    assert str(native.build()).startswith(str(native.BUILD_DIR))


def test_dump_obj(tmp_path):
    a, b, c = _random_soup(100, seed=5)
    path = str(tmp_path / "kdtree.obj")
    K.dump_obj(K.build_kdtree(a, b, c), path)
    text = open(path).read()
    assert text.startswith("g default") and "v " in text and "f " in text


QUIRKY_MTL = """\
newmtl plain
Kd 0.5 0.6 0.7
newmtl spec_ks_only
Ks 1.0 0.9 0.8
newmtl glassy
Tr 0.9
Ni 1.5
Ka 0.1 0.2 0.3
"""

QUIRKY_OBJ = textwrap.dedent("""\
    mtllib quirky.mtl
    v 0 0 0
    v 1 0 0
    v 1 1 0
    v 0 1 0
    v 0 0 1
    vn 0 0 1
    vn 0 1 0
    vt 0.5 0.5
    g quad
    usemtl plain
    f 1 2 3 4
    g mixed
    usemtl spec_ks_only
    f 1//1 2//1 3//2
    f 1/1/1 2/1/2 5/1/1
    usemtl unknown_material_name
    f 1 \\
    2 5
    g quad
    usemtl glassy
    f 5 4 3 2 1
    """)


def test_read_obj_native_equals_python(tmp_path, monkeypatch):
    (tmp_path / "quirky.mtl").write_text(QUIRKY_MTL)
    path = tmp_path / "quirky.obj"
    path.write_text(QUIRKY_OBJ)
    py = read_obj(str(path), backend="python")
    nat = read_obj(str(path), backend="native")
    assert py == nat
    assert len(py.groups["quad"]) == 5 and py.materials[2].Ns == 2.0
    monkeypatch.setenv("MCPT_NATIVE", "0")
    assert read_obj(str(path)) == py
    with pytest.raises(ValueError, match="backend"):
        read_obj(str(path), backend="fortran")


def _walk_case(T, seed):
    if T == "cornell":
        a, b, c, valid = _cornell_soup()
    else:
        a, b, c = _random_soup(T, seed)
        valid = np.ones(T, bool)
    rng = np.random.default_rng(seed + 100)
    R = 512
    lo, hi = a.min(axis=0) - 0.5, a.max(axis=0) + 0.5
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return a, b, c, valid, o, d


@pytest.mark.parametrize("T,seed", [(60, 1), (300, 2), ("cornell", 3)])
def test_walk_matches_jax_and_brute(T, seed):
    a, b, c, valid, o, d = _walk_case(T, seed)
    jflat = K.build_flat_kdtree(a, b, c, valid, backend="native")  # = the Python build's
    m, m_a = (np.array(x) for x in jax_transforms(*map(jnp.asarray, (a, b, c))))
    hj = jax.jit(JT.intersect_kdtree)(JT.KDArrays.from_flat(jflat), jnp.asarray(m),
                                      jnp.asarray(m_a), jnp.asarray(valid), jnp.asarray(o),
                                      jnp.asarray(d))
    kd = KDArrays.from_flat(convert.kdtree_from_numpy(
        {f: getattr(jflat, f) for f in convert.KD_FIELDS}), "cpu")
    assert kd.max_leaf == int(jflat.leaf_count.max())
    tm, tma = torch.from_numpy(m), torch.from_numpy(m_a)
    tv, to, td = torch.from_numpy(valid), torch.from_numpy(o), torch.from_numpy(d)
    hk = intersect_kdtree(kd, tm, tma, tv, to, td)
    got, want = hk.tri_id.numpy(), np.asarray(hj.tri_id)
    assert hk.tri_id.dtype == torch.int32
    rows = np.concatenate([np.concatenate([m, -m_a[:, :, None]], axis=2).reshape(-1, 12),
                           np.zeros((len(m), 36), np.float32)], axis=1)
    diff = got != want
    assert near_ties(rows, o.T[:, diff], d.T[:, diff], got[diff], want[diff]).all()
    assert (~diff).mean() >= 0.99 and (got >= 0).mean() > 0.05
    both = ~diff & (got >= 0)
    # The two sum the transform's three products in different orders, and
    # t = -o'_z / d'_z amplifies that where o'_z cancels (measured 1.3e-5).
    np.testing.assert_allclose(hk.t.numpy()[both], np.asarray(hj.t)[both], rtol=1e-4)
    miss = got < 0
    assert np.isinf(hk.t.numpy()[miss]).all() and (hk.beta.numpy()[miss] == 0).all()
    np.testing.assert_array_equal(hk.point.numpy()[miss], o[miss])
    hb = intersect_brute(tm, tma, tv, to, td)
    assert (hb.tri_id == hk.tri_id).float().mean() >= 0.995


def _boxes(W, H):
    return (*jcornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                  width=W, height=H),
            *cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                 width=W, height=H))


@pytest.mark.parametrize("mode", [dict(max_depth=2), dict(mode="rr", rr_depth=1, illum=1.0)],
                         ids=["fixed", "rr"])
def test_kdtree_render_matches_jax(mode):
    W, H = 24, 18
    js, jcam, ts, tcam = _boxes(W, H)
    a, b, c = (np.asarray(x) for x in js.triangle_vertices())
    jflat = K.build_flat_kdtree(a, b, c, np.asarray(js.tri_valid), backend="native")
    want = jax_render_sample_batch(js, jcam, jax.random.key(3), W, H,
                                   JTraceConfig(intersector="kdtree", ray_chunk=0, **mode),
                                   accel=JT.KDArrays.from_flat(jflat))
    # The port builds its own tree of the same triangles: the same arrays.
    tables = scene_tables(ts, TraceConfig(intersector="kdtree"))
    assert np.array_equal(tables.kd.node_skip.numpy(), jflat.node_skip)
    assert np.array_equal(tables.kd.leaf_tris.numpy(), jflat.leaf_tris)
    got = render_sample_batch(ts, tcam, make_key(3), W, H,
                              TraceConfig(intersector="kdtree", **mode), tables)
    rep = compare_images(got.numpy(), np.asarray(want))
    assert rep["ok"], rep
    assert np.asarray(want).mean() > 0.0
    brute = render_sample_batch(ts, tcam, make_key(3), W, H,
                                TraceConfig(intersector="brute", **mode))
    assert compare_images(got.numpy(), brute.numpy())["ok"]


def test_kdtree_gradient_matches_jax_brute():
    W, H = 16, 12
    js, jcam, ts, tcam = _boxes(W, H)
    fields = ("mat_kd", "mat_ka", "vertices")
    jparams = JG.split_params(js, fields)
    target = np.random.RandomState(1).uniform(0, 1, (H, W, 3)).astype(np.float32)
    jloss_fn = JG.make_loss_fn(js, jcam, jnp.asarray(target), width=W, height=H, spp=2,
                               config=JTraceConfig(intersector="brute", ray_chunk=0,
                                                   max_depth=2))
    jloss, jgrads = jax.value_and_grad(jloss_fn)(jparams, jax.random.key(5))
    loss_fn = G.make_loss_fn(ts, tcam, torch.from_numpy(target), width=W, height=H, spp=2,
                             config=TraceConfig(intersector="kdtree", max_depth=2))
    params = convert.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()})
    loss, grads = G.value_and_grad(loss_fn, params, make_key(5))
    got = convert.params_to_numpy(grads)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    rep = compare_param_grads({k: np.asarray(v) for k, v in jgrads.items()}, got, 1e-6)
    assert rep["ok"], rep
    assert np.abs(got["mat_kd"]).max() > 0 and np.abs(got["mat_ka"]).max() > 0


def test_kdtree_renderer_and_cli(tmp_path, capsys):
    W, H = 16, 12
    _, _, ts, tcam = _boxes(W, H)
    cfg = TraceConfig(intersector="kdtree", max_depth=2)
    accel = scene_tables(ts, cfg).kd
    r = Renderer(ts, tcam, cfg, RenderSettings(width=W, height=H, spp_per_pass=1), device="cpu",
                 accel=accel)
    assert r.tables.kd is accel and not cfg.use_whole
    film = r.render(1)
    assert torch.isfinite(film.color).all() and float(film.color.mean()) > 0
    out = str(tmp_path / "kd.png")
    assert cli.main(["--device", "cpu", "--intersector", "kdtree", "--width", "16", "--height",
                     "12", "--passes", "1", "--spp-per-pass", "1", "--max-depth", "2",
                     "--quiet", "--out", out]) == 0
    assert (tmp_path / "kd.png").exists()
    assert cli.main(["--device", "cpu", "--intersector", "kdtree", "--regen", "on",
                     "--out", out]) == 2
    assert "--regen on" in capsys.readouterr().err


def test_kd_arrays_on_the_rays_device():
    a, b, c = _random_soup(40, 7)
    kd = KDArrays.from_flat(K.build_flat_kdtree(a, b, c, backend="python"), "cpu")
    assert kd.node_lo.dtype == torch.float32 and kd.leaf_tris.dtype == torch.int64
    m, m_a = triangle_transforms(*map(torch.from_numpy, (a, b, c)))
    o = torch.zeros(4, 3)
    d = torch.nn.functional.normalize(torch.randn(4, 3, generator=torch.Generator().manual_seed(0)),
                                      dim=1)
    hit = intersect_kdtree(kd, m, m_a, torch.ones(40, dtype=torch.bool), o, d)
    assert hit.tri_id.shape == (4,) and hit.point.shape == (4, 3)
