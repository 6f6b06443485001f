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
from montecarlopathtracer_tpu_torch.testing import cap_torch_threads
from montecarlopathtracer_tpu_torch.utils import profiling

cap_torch_threads()

NEW_FLAGS = ("eye", "lookat", "up", "fov", "preview", "profile_dir", "scene")
TINY = ["--device", "cpu", "--scene", "cornell", "--width", "8", "--height", "6",
        "--passes", "1", "--spp-per-pass", "1", "--max-depth", "1", "--quiet"]


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
    assert os.path.exists(tmp_path / "r.png")
    assert profiling.time_fn(lambda: torch.ones(4).sum(), iters=2, device="cpu") > 0.0
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
