"""The port's golden-image metrics and golden-run twin against the JAX
package's ``utils/golden.py`` and the repository's ``tools/golden_run.py``
(on the CPU)."""

import importlib.util
import json
import os

import numpy as np
import pytest

from montecarlopathtracer_tpu.utils import golden as jgolden
from montecarlopathtracer_tpu_torch.testing import cap_torch_threads
from montecarlopathtracer_tpu_torch.tools import golden_run
from montecarlopathtracer_tpu_torch.utils import golden
from montecarlopathtracer_tpu_torch.utils.image import save_png

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_golden_run():
    """The repository's tools/golden_run.py (numpy at import; no package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_golden_run", os.path.join(REPO, "tools", "golden_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_identical_images():
    rng = np.random.default_rng(0)
    img = (rng.uniform(size=(64, 64, 3)) * 255).astype(np.uint8)
    m = golden.compare_images(img, img)
    assert m["mae"] == 0.0
    assert m["psnr_db"] > 100.0


def test_noise_vs_structure_separation():
    """Two noisy renders of one signal: per-pixel MAE large, downsampled
    MAE small; a brightness shift shows in mean_shift."""
    rng = np.random.default_rng(1)
    base = rng.uniform(0.2, 0.8, size=(64, 64, 3))
    a = np.clip(base + rng.normal(0, 0.1, base.shape), 0, 1)
    b = np.clip(base + rng.normal(0, 0.1, base.shape), 0, 1)
    m = golden.compare_images(a, b)
    assert m["mae"] > 3 * m["mae_down8"]
    m2 = golden.compare_images(base, np.clip(base + 0.2, 0, 1))
    assert min(m2["mean_shift"]) > 0.15


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        golden.compare_images(np.zeros((4, 4, 3)), np.zeros((8, 8, 3)))


@pytest.mark.parametrize("kind", ["uint8", "float", "mixed"])
@pytest.mark.parametrize("down", [8, 4])
def test_metrics_equal_jax(kind, down):
    rng = np.random.default_rng(7)
    u8 = [(rng.uniform(size=(37, 53, 3)) * 255).astype(np.uint8) for _ in range(2)]
    fl = [rng.uniform(size=(37, 53, 3)) for _ in range(2)]
    a, b = {"uint8": u8, "float": fl, "mixed": (u8[0], fl[1])}[kind]
    got = golden.compare_images(a, b, down=down)
    assert got == jgolden.compare_images(a, b, down=down)
    assert set(got) == {"mae", "rmse", "psnr_db", "mean_shift", f"mae_down{down}"}


def test_compare_files_and_cli(tmp_path, capsys):
    rng = np.random.default_rng(3)
    a, b = ((rng.uniform(size=(24, 32, 3)) * 255).astype(np.uint8) for _ in range(2))
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    save_png(pa, a)
    save_png(pb, b)
    got = golden.compare_files(pa, pb)
    assert got == golden.compare_images(a, b) == jgolden.compare_files(pa, pb)
    assert golden.main([pa, pb]) == 0
    assert json.loads(capsys.readouterr().out) == got
    assert golden.main([pa]) == 2


def test_fit_scale_equals_jax():
    jrun = _jax_golden_run()
    rng = np.random.default_rng(5)
    film = rng.uniform(0, 0.6, size=(30, 40, 3)).astype(np.float32)
    for s in (0.7, 1.0, 2.9):
        gold = np.clip(film * s * 255.0 + rng.normal(0, 3, film.shape), 0, 255).astype(np.uint8)
        got = golden_run._fit_scale(film, gold)
        assert abs(got - jrun._fit_scale(film, gold)) <= 1e-12
        assert abs(got - s) < 0.05 * s


def test_golden_run_exits_2_without_the_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MCPT_REFERENCE_ROOT", str(tmp_path / "no_reference"))
    assert golden_run.main(["--device", "cpu"]) == 2
    assert "reference checkout is not at" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()
    assert golden_run.OUT == os.path.join("out", "goldens_torch")
