"""The port's CLI options, preview page, profiler trace and TraceConfig
defaults against the JAX package's (on the CPU)."""

import json
import os
import types

import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu import cli as jcli
from montecarlopathtracer_tpu.models import cornell as jcornell
from montecarlopathtracer_tpu.render import integrator as jintegrator
from montecarlopathtracer_tpu.render import renderer as jrenderer
from montecarlopathtracer_tpu.scene import camera as jcamera
from montecarlopathtracer_tpu.utils import compile_cache as jcompile_cache
from montecarlopathtracer_tpu_torch import cli, convert
from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
from montecarlopathtracer_tpu_torch.scene.camera import camera_for_scene
from montecarlopathtracer_tpu_torch.testing import cap_torch_threads, program_spans
from montecarlopathtracer_tpu_torch.utils import profiling

cap_torch_threads()

NEW_FLAGS = ("eye", "lookat", "up", "fov", "preview", "profile_dir", "scene")
TINY = ["--device", "cpu", "--scene", "cornell", "--intersector", "megakernel", "--width", "8",
        "--height", "6", "--passes", "1", "--spp-per-pass", "1", "--max-depth", "1", "--quiet"]


def _plain(v):
    return [float(x) for x in v] if isinstance(v, (list, tuple)) else v


@pytest.mark.parametrize("argv", [
    [],
    ["--eye", "1", "2.5", "-3"],
    ["--eye", "0", "5", "20", "--lookat", "0", "4", "0", "--up", "0", "0", "1",
     "--fov", "45.5"],
    ["--lookat", "1", "1", "1"],
    ["--preview", "--step-dir", "steps"],
    ["--profile-dir", "prof"],
    ["--scene", "3"],
    ["--scene", "mcrt"],
], ids=["defaults", "eye", "eye-lookat-up-fov", "lookat", "preview", "profile-dir",
        "scene-3", "scene-mcrt"])
def test_new_flags_parse_like_jax(argv):
    got = vars(cli.build_parser().parse_args(argv))
    want = vars(jcli.build_parser().parse_args(argv))
    for k in NEW_FLAGS:
        if k == "scene" and "--scene" not in argv:
            continue  # the two CLIs' default scenes differ
        assert _plain(got[k]) == _plain(want[k]), k


def _jax_cli_camera(args, jitter):
    """The camera of the JAX CLI's main() for --eye (with or without --lookat)."""
    lookat = (args.lookat if args.lookat is not None
              else tuple(np.asarray(args.eye) + np.asarray((0.0, 0.0, -1.0))))
    return jcamera.Camera.look(
        args.eye, tuple(np.asarray(lookat) - np.asarray(args.eye)), args.up,
        width=args.width, height=args.height, fov_x_deg=args.fov, jitter=jitter)


@pytest.mark.parametrize("argv", [
    ["--eye", "0.3", "5.1", "19.7", "--lookat", "0.5", "4", "-1", "--fov", "50"],
    ["--eye", "0.1", "4.2", "12.3", "--up", "0.1", "1", "0", "--fov", "72"],
], ids=["lookat", "down-z"])
def test_eye_camera_rays_match_jax(argv):
    w, h = 16, 12
    argv = [*argv, "--width", str(w), "--height", str(h)]
    base = camera_for_scene(1, w, h)
    got = cli.look_camera(cli.build_parser().parse_args(argv), base)
    jargs = jcli.build_parser().parse_args(argv)
    jcam = _jax_cli_camera(jargs, base.jitter)
    conv = convert.camera_from_numpy(
        {f: np.asarray(getattr(jcam, f)) for f in convert.CAMERA_FIELDS}, jitter=jcam.jitter)
    rng = np.random.default_rng(3)
    pix = np.arange(w * h)
    xs, ys = pix % w, pix // w
    jx, jy = (rng.uniform(-1.0, 1.0, w * h).astype(np.float32) for _ in range(2))
    want = jcam.generate_rays_soa(xs, ys, jx, jy, w, h)
    t = [torch.as_tensor(a) for a in (xs, ys, jx, jy)]
    for cam in (got, conv):
        rays = cam.generate_rays_soa(*t, w, h)
        for a, b in zip(rays, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert got.jitter == jcam.jitter


def test_lookat_without_eye_exits_like_jax(monkeypatch):
    monkeypatch.setattr(jcompile_cache, "enable_compile_cache", lambda *a, **k: None)
    argv = ["--scene", "cornell", "--width", "8", "--height", "6", "--lookat", "0", "0", "0"]
    with pytest.raises(SystemExit) as want:
        jcli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main([*argv, "--device", "cpu"])
    assert str(got.value.code) == str(want.value.code) == "--lookat requires --eye"


@pytest.mark.parametrize("name,file", [("3", "scene03.obj"), ("mcrt", "scene01.obj")])
def test_reference_scenes_route_and_raise_like_jax(name, file, tmp_path, monkeypatch):
    absent = tmp_path / "no_reference"
    monkeypatch.setattr(jcornell, "REFERENCE_SCENES", str(absent))
    monkeypatch.setattr(jcornell, "MCRT_SCENE", str(absent / "MCRT" / file))
    monkeypatch.setenv("MCPT_REFERENCE_ROOT", str(absent))
    with pytest.raises(Exception) as want:
        jcli.load_scene(name, 16, 12)
    with pytest.raises(Exception) as got:
        cli.load_scene(name, 16, 12)
    assert type(got.value) is type(want.value)
    assert str(absent) in str(got.value) and file in str(got.value)


def test_profile_dir_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    assert cli.main([*TINY, "--profile-dir", str(prof), "--out", str(tmp_path / "r.png")]) == 0
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert len(events) > 0
    assert [s[1] for s in program_spans(prof / "trace.json") if s[0] == "pass"] == [
        {"pass": 0, "request": 1}]
    with open(prof / "counters.json") as f:
        counters = json.load(f)
    assert counters["passes"] == 1 and counters["spans"]["pass"][0] == 1
    assert os.path.exists(tmp_path / "r.png")
    with profiling.trace(None):  # no-op without a directory
        pass


def test_preview_writes_the_jax_page(tmp_path):
    steps = tmp_path / "steps"
    argv = [*TINY, "--passes", "2", "--step-dir", str(steps), "--preview",
            "--out", str(tmp_path / "r.png")]
    assert cli.main(argv) == 0
    assert sorted(os.listdir(steps)) == ["index.html", "preview.png", "step000000.png",
                                         "step000001.png"]
    jsteps = tmp_path / "jax_steps"
    jsteps.mkdir()
    stand_in = types.SimpleNamespace(settings=types.SimpleNamespace(step_dir=str(jsteps)))
    jrenderer.Renderer._write_preview(stand_in, np.zeros((6, 8, 3), np.uint8))
    assert (steps / "index.html").read_bytes() == (jsteps / "index.html").read_bytes()


def test_trace_config_defaults_differ_from_jax_as_documented():
    port, jax_ = TraceConfig(), jintegrator.TraceConfig()
    assert (port.intersector, port.ray_chunk) == ("megakernel", 0)
    assert (jax_.intersector, jax_.ray_chunk) == ("brute", 8192)
    doc = " ".join(TraceConfig.__doc__.split())
    assert 'intersector="megakernel"' in doc and 'ray_chunk=8192' in doc


AUTO_FLAGS = ("intersector", "chunk_cull", "ray_sort", "regen", "ray_chunk")
# The documented table (cli.py's thresholds, from the suite twin's H100
# rows and chip_smoke.py phase 39): the walk from 7,000 triangles, without
# the sort; culling from 1,000; regen on the megakernel in RR mode and in
# fixed mode from 16 spp per pass (the JAX CLI's rule), never on the walk.
AUTO_TABLE = {
    652: {"intersector": "megakernel", "chunk_cull": False, "ray_sort": False},
    1_332: {"intersector": "megakernel", "chunk_cull": True, "ray_sort": False},
    81_932: {"intersector": "traverse", "chunk_cull": False, "ray_sort": False},
}


@pytest.fixture(scope="module")
def scene_triangles():
    from montecarlopathtracer_tpu_torch.models import glossy

    return {"cornell-full": cli.load_scene("cornell-full", 8, 6)[0].num_triangles,
            "glossy": glossy.glossy_steps(width=8, height=6)[0].num_triangles,
            "bunny": 12 + 20 * 4 ** 6}  # bunny_scene(subdiv=6), from the count alone


@pytest.mark.parametrize("spp", [4, 16, 32])
@pytest.mark.parametrize("mode", ["fixed", "rr"])
@pytest.mark.parametrize("scene", ["cornell-full", "glossy", "bunny"])
def test_auto_resolution_table(scene, mode, spp, scene_triangles):
    tris = scene_triangles[scene]
    got = cli.resolve_choices(tris, mode=mode, spp_per_pass=spp)
    regen = AUTO_TABLE[tris]["intersector"] == "megakernel" and (mode == "rr" or spp >= 16)
    assert got == {**AUTO_TABLE[tris], "regen": regen, "ray_chunk": 0}
    assert (cli.TRAVERSE_FROM, cli.CULL_FROM, cli.REGEN_FIXED_FROM) == (7_000, 1_000, 16)


@pytest.mark.parametrize("argv", [
    [],
    ["--intersector", "auto", "--chunk-cull", "auto", "--ray-sort", "auto", "--regen", "auto"],
    ["--intersector", "traverse", "--ray-sort", "off"],
    ["--chunk-cull", "on", "--regen", "off"],
    ["--regen", "on", "--ray-chunk", "4096"],
], ids=["defaults", "auto", "traverse-nosort", "cull-on", "regen-chunk"])
def test_auto_flags_parse_like_jax(argv):
    got = vars(cli.build_parser().parse_args(argv))
    want = vars(jcli.build_parser().parse_args(argv))
    for k in AUTO_FLAGS:
        assert got[k] == want[k], k


@pytest.mark.parametrize("mode", ["fixed", "rr"])
def test_auto_regen_follows_the_jax_rule(mode):
    """Auto regen: the megakernel (culled or not) in RR mode at any spp per
    pass and in fixed mode from 16; never the walk, the split-path
    intersectors or a ray chunk; an explicit flag wins."""
    r = cli.resolve_choices
    for spp in (1, 4, 15, 16, 32):
        want = mode == "rr" or spp >= 16
        for tris in (36, 652, 1_332):
            assert r(tris, mode=mode, spp_per_pass=spp)["regen"] is want
        assert r(81_932, mode=mode, spp_per_pass=spp, chunk_cull="on")["regen"] is want
        assert r(81_932, mode=mode, spp_per_pass=spp)["regen"] is False
        for inter in ("traverse", "brute", "fused", "kdtree"):
            assert r(652, mode=mode, spp_per_pass=spp, intersector=inter)["regen"] is False
        assert r(652, mode=mode, spp_per_pass=spp, ray_chunk=4096)["regen"] is False
        assert r(652, mode=mode, spp_per_pass=spp, regen="off")["regen"] is False
        assert r(81_932, mode=mode, spp_per_pass=spp, regen="on")["regen"] is True


def test_explicit_flags_win_over_auto():
    r = cli.resolve_choices
    assert r(81_932, mode="fixed", spp_per_pass=4, intersector="brute")["intersector"] == "brute"
    assert r(81_932, mode="fixed", spp_per_pass=4, chunk_cull="on") == {
        "intersector": "megakernel", "chunk_cull": True, "ray_sort": True,
        "regen": False, "ray_chunk": 0}
    assert r(1_332, mode="fixed", spp_per_pass=4, intersector="traverse")["chunk_cull"] is False
    assert r(36, mode="rr", spp_per_pass=32, regen="on")["regen"] is True
    assert r(36, mode="fixed", spp_per_pass=1, ray_sort="on")["ray_sort"] is True
    assert r(36, mode="fixed", spp_per_pass=1, ray_chunk=0)["ray_chunk"] == 0
    assert cli.resolve_ray_chunk(None) == 0
    assert cli.resolve_ray_chunk(30000) == 30000


@pytest.mark.parametrize("mode", ["fixed", "rr"])
def test_ray_chunk_never_gets_auto_regen(mode, tmp_path, capsys):
    """The JAX CLI's auto regen drops an explicit --ray-chunk (ROADMAP C2);
    here auto never resolves regen on with a ray chunk, even where it
    would without one."""
    for tris in (36, 652, 1332, 81_932):
        for spp in (1, 4, 16, 32):
            for inter in ("auto", "megakernel", "traverse"):
                c = cli.resolve_choices(tris, mode=mode, spp_per_pass=spp, intersector=inter,
                                        ray_chunk=64)
                assert c["regen"] is False and c["ray_chunk"] == 64
    argv = [*TINY, "--mode", mode, "--spp-per-pass", "32", "--ray-chunk", "16"]
    argv.remove("--quiet")
    assert cli.main([*argv, "--out", str(tmp_path / "r.png")]) == 0
    (line,) = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith('{"choices"')]
    printed = json.loads(line)
    assert printed["choices"] == cli.resolve_choices(
        printed["triangles"], mode=mode, spp_per_pass=32, intersector="megakernel",
        ray_chunk=16)
    assert printed["choices"]["regen"] is False


@pytest.mark.parametrize("argv,msg", [
    (["--regen", "on", "--ray-chunk", "16"], "--ray-chunk 16"),
    (["--chunk-cull", "on", "--intersector", "fused"], "--chunk-cull on"),
    (["--chunk-cull", "on", "--intersector", "traverse"], "--chunk-cull on"),
    (["--regen", "on", "--intersector", "brute"], "--regen on"),
    (["--regen", "on", "--intersector", "kdtree"], "--regen on"),
], ids=["regen-chunk", "cull-fused", "cull-traverse", "regen-brute", "regen-kdtree"])
def test_explicit_refusals_are_unchanged(argv, msg, tmp_path, capsys):
    out = tmp_path / "r.png"
    base = ["--device", "cpu", "--scene", "cornell", "--width", "8", "--height", "6",
            "--passes", "1", "--out", str(out)]
    assert cli.main([*base, *argv]) == 2
    assert msg in capsys.readouterr().err
    assert not out.exists()
