"""The port's sharded paths (``parallel/``) on gloo ranks on the CPU.

Ranks are processes spawned by ``parallel.launch.run_ranks`` (one torch
thread each); each world is spawned once per module and runs every case
of its meshes (``testing.sharded_cases``, a module that imports no JAX,
as the children must not). Sizes as ``tests/test_parallel.py``: 16×16,
depth 2, 4 spp; 32×32 for the geometry step.

Held against the JAX package's ``parallel/sharded.py`` on
``make_mesh(2, 2)`` over four of conftest's eight virtual devices
(megakernel in interpret mode there, the plain versions here, as in
``tests/test_torch_render.py``): the gathered sample and regen passes
under ``compare_images``; the train step's loss at rtol 1e-6 and its new
parameters at ``tests/test_torch_grad_render.py``'s 5e-5 for the
interpret megakernel; the geometry step's loss at rtol 1e-5 (its
θ-gradient differs by the footprint weighting, ROADMAP C8).

Held against the port's own single-process emulation
(``testing.emulate_*``, the same keys, bands and order of sums) at
1e-6 on meshes (1,1) (no process group), (2,1), (1,2) and (2,2), the
geometry θ-gradient included; the train step's parameters also against
plain autograd of the frame's loss (``testing.reference_train_step``),
which a stray factor of ``n_spp`` or of the rank count would fail.
"""

import io
import json
import time
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu.models import cornell as jcornell
from montecarlopathtracer_tpu.parallel import sharded as JS
from montecarlopathtracer_tpu.parallel.mesh import make_mesh as jmake_mesh
from montecarlopathtracer_tpu.render import integrator as JI
from montecarlopathtracer_tpu.render.regen import render_regen_planar as jregen
from montecarlopathtracer_tpu_torch import graft_entry
from montecarlopathtracer_tpu_torch import testing as T
from montecarlopathtracer_tpu_torch.diff.boundary import lamp_mask
from montecarlopathtracer_tpu_torch.diff.grad import split_params
from montecarlopathtracer_tpu_torch.models import cornell
from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key
from montecarlopathtracer_tpu_torch.parallel import distributed, sharded as SH
from montecarlopathtracer_tpu_torch.parallel.launch import run_ranks
from montecarlopathtracer_tpu_torch.parallel.mesh import Mesh, make_mesh
from montecarlopathtracer_tpu_torch.render.film import Film, film_update
from montecarlopathtracer_tpu_torch.render.integrator import (
    TraceConfig,
    render_rows,
    render_sample_batch,
    trace_radiance,
)
from montecarlopathtracer_tpu_torch.render.regen import render_regen_planar
from montecarlopathtracer_tpu_torch.tools import scaling_bench

T.cap_torch_threads()

W = H = 16
GW = GH = 32
SPP = 4
SEED = 3
SPHERES = dict(with_mirror_sphere=True, with_glass_sphere=True)
FIELDS = ("mat_kd", "mat_ka", "vertices")
SAMPLE_CFG = dict(max_depth=2)
REGEN_CFG = dict(mode="rr", rr_depth=2, illum=1.0)
GEOM_CFG = dict(mode="fixed", max_depth=2, intersector="brute")
LR = 1.0
TARGET = np.random.RandomState(0).uniform(0, 1, (H, W, 3)).astype(np.float32)
THETA0 = [1.5, 0.0, 0.0]
N_EDGE = 2048
GEOM_LR = 2.0
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
KINDS = ("sample", "regen", "progressive", "train")


def _geom_target():
    """The lamp at rest, 4 spp under key 123 (``tests/test_parallel.py``)."""
    scene, camera = cornell.cornell_box(width=GW, height=GH)
    cfg = TraceConfig(**GEOM_CFG)
    with torch.no_grad():
        return (sum(render_sample_batch(scene, camera, fold_in(make_key(123), i), GW, GH, cfg)
                    for i in range(4)) / 4).numpy()


GEOM_TARGET = _geom_target()


def _cases(mesh):
    base = dict(mesh=mesh, width=W, height=H, spp=SPP, config=SAMPLE_CFG, seed=SEED,
                scene=SPHERES)
    return {
        "sample": dict(base, kind="sample"),
        "regen": dict(base, kind="regen", config=REGEN_CFG),
        "progressive": dict(base, kind="progressive", seeds=[1, 2]),
        "train": dict(base, kind="train", fields=FIELDS, kd_scale=0.5, target=TARGET, lr=LR),
        "geom": dict(mesh=mesh, kind="geom", width=GW, height=GH, spp=SPP, config=GEOM_CFG,
                     seed=5, theta=THETA0, target=GEOM_TARGET, n_edge=N_EDGE, lr=GEOM_LR),
    }


def _run_world(world, extra=()):
    """Every case of the world's meshes on ``world`` gloo ranks: {(mesh,
    kind): [result of each rank]}."""
    named = [((m, k), c) for m in MESHES[world] for k, c in _cases(m).items()]
    named += list(extra)
    per_rank = run_ranks(T.sharded_cases, world, ([c for _, c in named], "cpu"),
                         device="cpu", timeout=300)
    return {name: [r[i] for r in per_rank] for i, (name, _) in enumerate(named)}


@pytest.fixture(scope="module")
def ranks():
    """Results by (mesh, kind), every world spawned once; (1, 1) runs in
    this process with no process group."""
    recover = dict(_cases((2, 2))["geom"], kind="recover", steps=20, seed=1000)
    out = {name: rs for world in (2, 4)
           for name, rs in _run_world(world, [(((2, 2), "recover"), recover)] if world == 4
                                      else []).items()}
    single = _cases((1, 1))
    for kind, res in zip(single, T.sharded_cases(list(single.values()), "cpu")):
        out[((1, 1), kind)] = [res]
    return out


def _port_scene(width=W, height=H, scene=SPHERES):
    return cornell.cornell_box(width=width, height=height, **scene)


def _kw(case):
    return dict(width=case["width"], height=case["height"], spp=case["spp"],
                config=TraceConfig(**case["config"]))


def _train_inputs(scene):
    params = split_params(scene, FIELDS)
    params["mat_kd"] = params["mat_kd"] * 0.5
    return params, torch.as_tensor(TARGET)


def _replicated(results, kind):
    """Rank 0's result, after checking every rank holds the same."""
    first = results[0]
    for r in results[1:]:
        if kind in ("sample", "regen"):
            np.testing.assert_array_equal(r, first)
        else:
            for k in first:
                a, b = first[k], r[k]
                if isinstance(a, dict):
                    for f in a:
                        np.testing.assert_array_equal(b[f], a[f])
                else:
                    np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    return first


# ---------------------------------------------------- against the emulation


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", [(1, 1), (2, 1), (1, 2), (2, 2)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_path_equals_emulation(ranks, mesh, kind):
    """The gathered frame, film, loss and parameters equal the port's
    single-process emulation of the same ranks to 1e-6 (bit for bit
    on one and two ranks), on every rank alike."""
    case = _cases(mesh)[kind]
    got = _replicated(ranks[(mesh, kind)], kind)
    scene, camera = _port_scene()
    key, kw = make_key(SEED), _kw(case)
    exact = mesh[0] * mesh[1] <= 2
    if kind in ("sample", "regen"):
        fn = T.emulate_sample_pass if kind == "sample" else T.emulate_regen_pass
        with torch.no_grad():
            want = fn(scene, camera, key, mesh, **kw).numpy()
        assert got.shape == (H, W, 3) and np.isfinite(got).all() and got.max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=0 if exact else 1e-6)
    elif kind == "progressive":
        want = Film.zeros(H, W)
        with torch.no_grad():
            for s in case["seeds"]:
                want = film_update(
                    want, T.emulate_sample_pass(scene, camera, make_key(s), mesh, **kw), SPP)
        assert float(got["weight"]) == float(want.weight) == 2 * SPP
        np.testing.assert_allclose(got["color"], want.color.numpy(), rtol=0,
                                   atol=0 if exact else 1e-6)
    else:
        params, target = _train_inputs(scene)
        new, loss = T.emulate_train_step(scene, camera, params, target, key, mesh, lr=LR, **kw)
        np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=0 if exact else 1e-6)
        rep = T.compare_param_grads(
            {k: v.numpy() for k, v in new.items()}, got["params"], 0.0 if exact else 1e-6)
        assert rep["ok"], rep


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_train_step_gradients_carry_no_rank_factor(ranks, mesh):
    """The sharded step against plain autograd of the frame's loss over
    the same samples: the parameter change agrees to 1e-6 of the scale,
    and it is large enough (lr·|g| ≫ the tolerance) that a gradient off by
    n_spp, n_rays or the rank count would fail."""
    got = _replicated(ranks[(mesh, "train")], "train")
    scene, camera = _port_scene()
    params, target = _train_inputs(scene)
    new, loss = T.reference_train_step(scene, camera, params, target, make_key(SEED), mesh,
                                       lr=LR, **_kw(_cases(mesh)["train"]))
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-6)
    for k in ("mat_kd", "mat_ka"):
        p, want, g = params[k].numpy(), new[k].numpy(), got["params"][k]
        step = np.abs(p - want)
        assert step.max() > 1e-3 * (np.abs(want).max() + 1.0), (k, step.max())
        scale = np.abs(p - want).max()
        np.testing.assert_allclose(p - g, p - want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("mesh", [(1, 1), (2, 1), (1, 2), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_geometry_step_equals_emulation(ranks, mesh):
    """Loss and θ-gradient of the sharded geometry step against the
    emulation with the same probe keys (the port's footprint weighting on
    both sides, ROADMAP C8)."""
    case = _cases(mesh)["geom"]
    got = _replicated(ranks[(mesh, "geom")], "geom")
    scene, camera = cornell.cornell_box(width=GW, height=GH)
    theta, loss = T.emulate_geom_step(
        scene, camera, lamp_mask(scene), THETA0, torch.as_tensor(GEOM_TARGET),
        make_key(case["seed"]), mesh, n_edge_samples=N_EDGE, lr=GEOM_LR, **_kw(case))
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-6)
    g_want = (np.asarray(THETA0, np.float32) - theta.numpy()) / GEOM_LR
    g_got = (np.asarray(THETA0, np.float32) - got["theta"]) / GEOM_LR
    assert np.abs(g_want).max() > 0
    np.testing.assert_allclose(g_got, g_want, rtol=1e-5, atol=1e-6 * np.abs(g_want).max())


def test_geometry_step_recovers_translation(ranks):
    """``tests/test_parallel.py``'s recovery on four ranks: the lamp
    shifted by x = 1.5 returns to within 0.6 in 20 steps."""
    got = _replicated(ranks[((2, 2), "recover")], "recover")
    assert np.isfinite(got["losses"]).all()
    assert abs(float(got["theta"][0])) < 0.6, got["theta"]


# -------------------------------------------------------- against the JAX package


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's sample, regen, train and geometry steps on a 2×2 mesh."""
    mesh = jmake_mesh(2, 2, devices=jax.devices()[:4])
    js, jcam = jcornell.cornell_box(width=W, height=H, **SPHERES)
    interp = dict(ray_chunk=0, intersector="megakernel", pallas_interpret=True)
    key = jax.random.key(SEED)
    out = {}
    out["sample"] = np.asarray(JS.sharded_sample_pass(
        mesh, width=W, height=H, spp=SPP, config=JI.TraceConfig(**SAMPLE_CFG, **interp))(
        js, jcam, key))
    out["regen"] = np.asarray(JS.sharded_regen_pass(
        mesh, width=W, height=H, spp=SPP, config=JI.TraceConfig(**REGEN_CFG, **interp))(
        js, jcam, key))
    step = JS.make_train_step(mesh, js, jcam, width=W, height=H, spp=SPP, lr=LR,
                              config=JI.TraceConfig(**SAMPLE_CFG, remat_segments=False,
                                                    **interp))
    from montecarlopathtracer_tpu.diff.grad import split_params as jsplit

    p = jsplit(js, FIELDS)
    p["mat_kd"] = p["mat_kd"] * 0.5
    new, loss = step(p, jnp.asarray(TARGET), key)
    out["train"] = {"loss": float(loss), "params": {k: np.asarray(v) for k, v in new.items()}}
    gs, gcam = jcornell.cornell_box(width=GW, height=GH)
    ka = np.asarray(gs.mat_ka)
    lamp = np.isin(np.asarray(gs.tri_mat), np.where((ka > 0).any(axis=1))[0]) & np.asarray(
        gs.tri_valid)
    gstep = JS.make_geom_train_step(
        mesh, gs, gcam, lamp, width=GW, height=GH, spp=SPP, n_edge_samples=N_EDGE,
        lr=GEOM_LR, config=JI.TraceConfig(mode="fixed", max_depth=2, ray_chunk=0))
    _, gloss = gstep(jnp.asarray(THETA0), jnp.asarray(GEOM_TARGET), jax.random.key(5))
    out["geom"] = float(gloss)
    return out


@pytest.mark.parametrize("kind", ["sample", "regen"])
def test_sharded_frames_match_jax(ranks, jax_sharded, kind):
    got = _replicated(ranks[((2, 2), kind)], kind)
    rep = T.compare_images(got, jax_sharded[kind])
    assert rep["ok"], rep


def test_sharded_train_step_matches_jax(ranks, jax_sharded):
    got = _replicated(ranks[((2, 2), "train")], "train")
    want = jax_sharded["train"]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-6)
    rep = T.compare_param_grads(want["params"], got["params"], 5e-5)
    assert rep["ok"], rep


def test_sharded_geometry_loss_matches_jax(ranks, jax_sharded):
    got = _replicated(ranks[((2, 2), "geom")], "geom")
    np.testing.assert_allclose(float(got["loss"]), jax_sharded["geom"], rtol=1e-5)


def test_aos_wrappers_match_jax():
    """``render_rows`` (a band at y0 = 4) and ``trace_radiance`` (AoS
    rays) against JAX's, brute on both sides."""
    js, jcam = jcornell.cornell_box(width=W, height=H, **SPHERES)
    scene, camera = _port_scene()
    jcfg = JI.TraceConfig(max_depth=2, ray_chunk=0)
    cfg = TraceConfig(max_depth=2, intersector="brute")
    want = np.asarray(JI.render_rows(js, jcam, jax.random.key(7), W, H, 4, 8, jcfg))
    with torch.no_grad():
        got = render_rows(scene, camera, make_key(7), W, H, 4, 8, cfg).numpy()
    assert got.shape == (8, W, 3)
    rep = T.compare_images(got, want)
    assert rep["ok"], rep
    rng = np.random.RandomState(1)
    o = rng.uniform(-3, 3, (256, 3)).astype(np.float32) + np.float32([0, 5, 0])
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = np.asarray(JI.trace_radiance(js, jnp.asarray(o), jnp.asarray(d), jax.random.key(8),
                                        jcfg))
    with torch.no_grad():
        got = trace_radiance(scene, torch.as_tensor(o), torch.as_tensor(d), make_key(8),
                             cfg).numpy()
    assert got.shape == (256, 3)
    rep = T.compare_images(got[:, None], want[:, None])
    assert rep["ok"], rep


def test_regen_row_band_matches_jax():
    """A regen band (y0 = 4, 8 rows: 8·W lanes per stream) against JAX's
    ``render_regen_planar`` with the same band, interpret megakernel."""
    js, jcam = jcornell.cornell_box(width=W, height=H, **SPHERES)
    scene, camera = _port_scene()
    jcfg = JI.TraceConfig(**REGEN_CFG, ray_chunk=0, intersector="megakernel",
                          pallas_interpret=True)
    want = np.asarray(jregen(js, jcam, jax.random.key(9), W, H, 4, jcfg, y0=4, n_rows=8))
    got = render_regen_planar(scene, camera, make_key(9), W, H, 4, TraceConfig(**REGEN_CFG),
                              y0=4, n_rows=8).numpy()
    assert got.shape == (3, 8, W)
    rep = T.compare_images(got.transpose(1, 2, 0), want.transpose(1, 2, 0))
    assert rep["ok"], rep


# ------------------------------------------------------------------ the rest


def test_single_process_mesh_has_no_process_group():
    mesh = make_mesh(device="cpu")
    assert (mesh.n_rays, mesh.n_spp, mesh.rank, mesh.backend) == (1, 1, 0, None)
    x = torch.ones(3)
    assert mesh.psum(x, SH.ALL_AXES) is x
    assert distributed.process_info() == {"process_index": 0, "process_count": 1,
                                          "local_devices": 1, "global_devices": 1}


def test_refusals():
    with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
        make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="mesh 0x3 != 1 ranks"):
        make_mesh(n_spp_shards=3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_ranks(distributed.process_info, 1)
    mesh = Mesh(2, 2)  # a place in a 2×2 grid, no process group
    scene, camera = _port_scene()
    cfg = TraceConfig(**SAMPLE_CFG)
    for build in (SH.sharded_sample_pass, SH.sharded_regen_pass, SH.make_progressive_step):
        with pytest.raises(ValueError, match="height 15 not divisible by rays shards 2"):
            build(mesh, width=W, height=15, spp=4, config=cfg)
        with pytest.raises(ValueError, match="spp 3 not divisible by spp shards 2"):
            build(mesh, width=W, height=H, spp=3, config=cfg)
    with pytest.raises(ValueError, match="height 15 not divisible"):
        SH.make_train_step(mesh, scene, camera, width=W, height=15, spp=4, config=cfg)
    with pytest.raises(ValueError, match="spp 3 not divisible"):
        SH.make_train_step(mesh, scene, camera, width=W, height=H, spp=3, config=cfg)
    lamp = lamp_mask(scene)
    with pytest.raises(ValueError, match="n_edge_samples 2046 not divisible by 4"):
        SH.make_geom_train_step(mesh, scene, camera, lamp, width=W, height=H, spp=4,
                                config=cfg, n_edge_samples=2046)
    with pytest.raises(ValueError, match="height 15 not divisible"):
        SH.make_geom_train_step(mesh, scene, camera, lamp, width=W, height=15, spp=4,
                                config=cfg)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        mesh.psum(torch.ones(1), "pixels")


def test_run_ranks_reports_process_info_and_names_a_failed_rank():
    """Each rank's ``process_info``; a rank that raises, and one that
    outlives the timeout, end the run with their rank named."""
    infos = run_ranks(distributed.process_info, 2, device="cpu", timeout=120)
    assert infos == [{"process_index": r, "process_count": 2, "local_devices": 1,
                      "global_devices": 2} for r in range(2)]
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed:(.|\n)*unknown mode 'bogus'"):
        run_ranks(TraceConfig, 2, ("bogus",), device="cpu", timeout=120)
    with pytest.raises(TimeoutError, match=r"ranks \[0\] did not finish within 1"):
        run_ranks(time.sleep, 1, (60,), device="cpu", timeout=1)


def test_graft_entry_and_dryrun_on_four_ranks():
    """``entry()``'s step (rendered whole by the card test
    ``test_graft_entry_renders_on_card``) and the dry run on four ranks."""
    fn, (scene, camera, key) = graft_entry.entry(device="cpu")
    assert fn.func is render_sample_batch and key == make_key(0)
    assert fn.keywords == dict(width=128, height=128,
                               config=TraceConfig(mode="fixed", max_depth=7))
    assert scene.num_triangles == 652 and camera.device.type == "cpu"
    buf = io.StringIO()
    with redirect_stdout(buf):
        graft_entry.dryrun_multichip(4, device="cpu", timeout=300)
    lines = buf.getvalue().splitlines()
    assert [line.split(":")[0] for line in lines] == [
        f"dryrun config {k} ok" for k in (1, 2, 3)]


def test_scaling_twin_on_one_and_two_ranks(tmp_path, monkeypatch):
    """The twin's whole run at a tiny band (its fixed sizes patched in
    the parent, which hands them to the ranks)."""
    for name, value in (("ROWS_PER_RANK", 4), ("WIDTH", 16), ("SPP", 1), ("DEPTH", 1),
                        ("REPS", 1)):
        monkeypatch.setattr(scaling_bench, name, value)
    out = tmp_path / "scaling.json"
    assert scaling_bench.main(["--device", "cpu", "--max-ranks", "2", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["regime"] == "cpu-ranks-overhead" and "overhead only" in rep["note"]
    assert [r["ranks"] for r in rep["results"]] == [1, 2]
    assert all(r["seconds_per_pass"] > 0 for r in rep["results"])
    assert rep["spmd_overhead"]["unsharded_seconds"] > 0
