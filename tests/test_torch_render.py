"""Whole renders of the port against the JAX package, from the same
seed, on the CPU (the port's plain path; the JAX package's whole-segment
Pallas kernel in interpret mode).

Bound: at least 99% of pixels within 1e-4 (max over channels) and frame
means within 1e-3 relative. A pixel's radiance is a product of material
constants along its path, so it moves only where a path takes another
turn: a winner flip at a triangle edge or a sampling decision at its
threshold. Measured at 48x36, depth 3: every pixel equal (max |err| 0)
in fixed and in RR mode; the same for the ray-tiled render and for the
2-pass x 2-spp Renderer film.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu.models import cornell as jcornell
from montecarlopathtracer_tpu.render import film as jfilm
from montecarlopathtracer_tpu.render.integrator import (
    TraceConfig as JTraceConfig,
    render_sample_batch as jax_render_sample_batch,
)
from montecarlopathtracer_tpu.render.renderer import (
    Renderer as JRenderer,
    RenderSettings as JRenderSettings,
)
from montecarlopathtracer_tpu_torch import cli
from montecarlopathtracer_tpu_torch.models import cornell
from montecarlopathtracer_tpu_torch.ops import rng
from montecarlopathtracer_tpu_torch.render import film
from montecarlopathtracer_tpu_torch.render.integrator import (
    TraceConfig,
    render_sample_batch,
)
from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
from montecarlopathtracer_tpu_torch.testing import cap_torch_threads, compare_images
from montecarlopathtracer_tpu_torch.utils.image import load_png, save_png

cap_torch_threads()


def _assert_images_agree(got, want):
    rep = compare_images(got, np.asarray(want))
    assert rep["ok"], rep
    assert np.asarray(want).mean() > 0.0


def _scenes(W, H):
    js, jcam = jcornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True, width=W, height=H
    )
    ts, tcam = cornell.cornell_box(
        with_mirror_sphere=True, with_glass_sphere=True, width=W, height=H
    )
    return js, jcam, ts, tcam


@pytest.mark.parametrize(
    "kw",
    [
        dict(W=48, H=36, max_depth=3, ray_chunk=0),
        dict(W=48, H=36, mode="rr", rr_depth=1, illum=1.0, refract_kd=False,
             ray_chunk=0),
        dict(W=32, H=24, max_depth=2, ray_chunk=300),  # 3 tiles, 132 padded rays
    ],
    ids=["fixed", "rr", "ray_tiles"],
)
def test_render_sample_batch_matches_jax(kw):
    kw = dict(kw)
    W, H = kw.pop("W"), kw.pop("H")
    js, jcam, ts, tcam = _scenes(W, H)
    want = jax_render_sample_batch(
        js, jcam, jax.random.key(3), W, H,
        JTraceConfig(intersector="megakernel", pallas_interpret=True, **kw),
    )
    got = render_sample_batch(ts, tcam, rng.make_key(3), W, H, TraceConfig(**kw))
    assert tuple(got.shape) == (H, W, 3)
    _assert_images_agree(got.numpy(), want)


W, H, SPP = 40, 30, 2


@pytest.fixture(scope="module")
def jax_renders(tmp_path_factory):
    """The JAX Renderer's film after 1 and 2 passes of 2 spp, with its
    checkpoint after pass 1."""
    d = tmp_path_factory.mktemp("jax_ck")
    js, jcam, _, _ = _scenes(W, H)
    path = str(d / "ck.npz")
    r = JRenderer(
        js, jcam,
        JTraceConfig(intersector="megakernel", pallas_interpret=True,
                     max_depth=3, ray_chunk=0),
        JRenderSettings(width=W, height=H, spp_per_pass=SPP, seed=5,
                        checkpoint_path=path),
    )
    r.render(1)
    ck1 = str(d / "ck_pass1.npz")
    shutil.copy(path, ck1)
    r.render(1)
    return dict(ck1=ck1, color=np.asarray(r.film.color),
                weight=float(r.film.weight), m2=float(r.film.m2))


def _port_renderer(checkpoint_path=None):
    _, _, ts, tcam = _scenes(W, H)
    return Renderer(
        ts, tcam, TraceConfig(max_depth=3),
        RenderSettings(width=W, height=H, spp_per_pass=SPP, seed=5,
                       checkpoint_path=checkpoint_path),
        device="cpu",
    )


def test_renderer_matches_jax(jax_renders):
    r = _port_renderer()
    r.render(2)
    assert float(r.film.weight) == jax_renders["weight"] == 2 * SPP
    _assert_images_agree(r.film.color.numpy(), jax_renders["color"])
    np.testing.assert_allclose(float(r.film.m2), jax_renders["m2"], rtol=1e-5)


def test_jax_checkpoint_resumes_in_port(jax_renders, tmp_path):
    ck = str(tmp_path / "ck.npz")
    shutil.copy(jax_renders["ck1"], ck)
    r = _port_renderer(checkpoint_path=ck)
    assert r.pass_idx == 1 and float(r.film.weight) == SPP
    r.render(1)
    assert r.pass_idx == 2 and float(r.film.weight) == jax_renders["weight"]
    _assert_images_agree(r.film.color.numpy(), jax_renders["color"])
    with np.load(ck) as z:  # the port's own checkpoint, same keys
        assert sorted(z.files) == ["color", "m2", "pass_idx", "seed", "weight"]
        assert int(z["pass_idx"]) == 2


@pytest.mark.parametrize("gamma", [False, True])
def test_film_updates_match_jax(gamma):
    rs = np.random.RandomState(4)
    batches = [rs.uniform(0, 2, (6, 5, 3)).astype(np.float32) for _ in range(3)]
    jf, tf = jfilm.Film.zeros(6, 5), film.Film.zeros(6, 5)
    jup = jfilm.film_update_gamma if gamma else jfilm.film_update
    tup = film.film_update_gamma if gamma else film.film_update
    for i, b in enumerate(batches):
        jf = jup(jf, b, float(i + 1))
        tf = tup(tf, torch.from_numpy(b), float(i + 1))
    np.testing.assert_allclose(tf.color.numpy(), np.asarray(jf.color), rtol=1e-6, atol=1e-6)
    assert float(tf.weight) == float(jf.weight)
    np.testing.assert_allclose(float(tf.m2), float(jf.m2), rtol=1e-5)
    for tm in ("tonemap_linear", "tonemap_gamma", "tonemap_identity"):
        np.testing.assert_array_equal(getattr(film, tm)(tf.color),
                                      getattr(jfilm, tm)(np.asarray(jf.color)))


def test_png_writer_reads_back_with_pil(tmp_path):
    from PIL import Image

    img = np.random.RandomState(0).randint(0, 256, (7, 9, 3)).astype(np.uint8)
    path = str(tmp_path / "sub" / "x.png")
    save_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), img)
    np.testing.assert_array_equal(load_png(path), img)


def test_cli_cpu_writes_png(tmp_path):
    out = str(tmp_path / "r.png")
    steps = str(tmp_path / "steps")
    rc = cli.main([
        "--device", "cpu", "--scene", "cornell-full", "--intersector", "megakernel",
        "--width", "32",
        "--height", "24", "--spp-per-pass", "1", "--passes", "2",
        "--max-depth", "2", "--out", out, "--step-dir", steps,
        "--checkpoint", str(tmp_path / "ck.npz"), "--quiet",
    ])
    assert rc == 0
    img = load_png(out)
    assert img.shape == (24, 32, 3) and img.dtype == np.uint8 and img.max() > 0
    assert sorted(os.listdir(steps)) == ["step000000.png", "step000001.png"]


def test_renderer_step_pngs_and_preview(tmp_path):
    _, _, ts, tcam = _scenes(16, 12)
    steps = str(tmp_path / "steps")
    r = Renderer(ts, tcam, TraceConfig(max_depth=1),
                 RenderSettings(width=16, height=12, spp_per_pass=1, seed=1,
                                step_dir=steps, preview=True, accum="gamma"),
                 device="cpu")
    r.render(2)
    assert sorted(os.listdir(steps)) == ["index.html", "preview.png", "step000000.png",
                                         "step000001.png"]
    np.testing.assert_array_equal(load_png(os.path.join(steps, "preview.png")),
                                  r.image_u8())


def test_cli_without_gpu_fails_rather_than_using_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(tmp_path / "r.png")
    rc = cli.main(["--width", "8", "--height", "6", "--passes", "1", "--out", out])
    assert rc != 0 and not os.path.exists(out)
    assert "no CUDA device" in capsys.readouterr().err


def test_unported_options_raise():
    # Every intersector of the JAX package is ported; an unknown one raises.
    with pytest.raises(ValueError, match="unknown intersector"):
        TraceConfig(intersector="bvh")
    for intersector in ("megakernel", "traverse", "fused", "brute", "kdtree"):
        for whole in (True, False):
            cfg = TraceConfig(intersector=intersector, whole_segment=whole)
            assert cfg.use_whole == (whole and intersector in ("megakernel", "traverse"))
    assert TraceConfig(chunk_cull=True).chunk_cull
    for intersector in ("traverse", "fused", "brute"):
        with pytest.raises(ValueError, match="chunk_cull"):
            TraceConfig(intersector=intersector, chunk_cull=True)


def test_renderer_defaults_to_the_card():
    """A Renderer built without a device renders on the card and, with
    none present, raises rather than moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, ts, tcam = _scenes(8, 6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Renderer(ts, tcam, TraceConfig(max_depth=1), RenderSettings(width=8, height=6))
