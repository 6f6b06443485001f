"""The port's bench twin and suite twin against the repository's
``bench.py`` and ``tools/bench_suite.py`` (on the CPU, at tiny sizes).

The originals are read as text: importing them would start JAX's
compile cache."""

import json
import os
import re

import pytest

from montecarlopathtracer_tpu_torch import bench
from montecarlopathtracer_tpu_torch.testing import cap_torch_threads
from montecarlopathtracer_tpu_torch.tools import bench_suite, wseg_check

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"BENCH_WIDTH": "16", "BENCH_HEIGHT": "12", "BENCH_SPP_PER_PASS": "1",
        "BENCH_PASSES": "1", "BENCH_GRAD_ITERS": "1"}


def _read(rel):
    with open(os.path.join(REPO, rel)) as f:
        return f.read()


def _bench_keys():
    """The metric name and every key that bench.py's record can hold."""
    text = _read("bench.py")
    block = text[text.index("record = {"):text.index("print(json.dumps(record))")]
    keys = set(re.findall(r'^\s*"(\w+)":', block, re.M)) | set(re.findall(r'record\["(\w+)"\]',
                                                                          block))
    return re.search(r'"metric": "(\w+)"', block).group(1), keys


def _run_bench(monkeypatch, capsys, **env):
    for k, v in {**TINY, **env}.items():
        monkeypatch.setenv(k, v)
    for k in ("BENCH_RAY_CHUNK", "BENCH_PROFILE_DIR"):
        monkeypatch.delenv(k, raising=False)
    assert bench.main(device="cpu") == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    return json.loads(lines[0]), err


def test_bench_twin_prints_bench_py_line(monkeypatch, capsys):
    metric, keys = _bench_keys()
    rec, err = _run_bench(monkeypatch, capsys)
    assert set(rec) == keys
    assert rec["metric"] == metric == bench.METRIC
    assert rec["unit"] == "Msamples/s"
    assert rec["vs_baseline"] == round(rec["value"] / bench.BASELINE_MSAMPLES_S, 3)
    assert rec["value"] == rec["fwd_msamples_s"]
    # At 16x12 on the CPU the rounded rates may read 0.
    assert all(isinstance(rec[k], float) and rec[k] >= 0 for k in keys - {"metric", "unit"})
    assert "cpu" in err.splitlines()


def test_bench_twin_leaves_regen_out_for_brute(monkeypatch, capsys):
    """C1: bench.py runs its regen block under BENCH_INTERSECTOR=brute,
    where regen raises; the twin leaves the field out and says why."""
    rec, err = _run_bench(monkeypatch, capsys, BENCH_INTERSECTOR="brute", BENCH_GRAD="0")
    assert "rr_regen_msamples_s" not in rec and "fwdbwd_msamples_s" not in rec
    assert "rr regen: left out" in err and "'brute'" in err


def _jax_suite_names():
    text = _read("tools/bench_suite.py")
    names = re.findall(r'^\s*\("(\w+)", s[12gb], c[12gb],', text, re.M)
    assert "bunny_grad_fwdbwd" in text
    return names + ["bunny_grad_fwdbwd"]


def test_suite_rows_are_the_originals_less_the_tile_rows():
    want = [n for n in _jax_suite_names() if n not in bench_suite.DROPPED]
    got = [row[0] for row in bench_suite.plan(quick=False, kdtree=True)] + ["bunny_grad_fwdbwd"]
    assert sorted(got) == sorted(want)
    assert set(bench_suite.DROPPED) <= set(_jax_suite_names())
    assert all("_rt" in n or "_tc" in n for n in bench_suite.DROPPED)


@pytest.fixture
def tiny_suite(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    for name, value in (("WIDTH", 16), ("HEIGHT", 12), ("KD_RES", (16, 12)),
                        ("SPP_PASSES", (1, 1))):
        monkeypatch.setattr(bench_suite, name, value)
    return tmp_path / bench_suite.OUT


def test_suite_twin_rows_on_cpu(tiny_suite, capsys):
    assert bench_suite.main(["--device", "cpu", "--only", "scene1_megakernel"]) == 0
    assert bench_suite.main(["--device", "cpu", "--only", "scene1_kdtree", "--append"]) == 0
    with open(tiny_suite) as f:
        out = json.load(f)
    assert out["device"] == "cpu"
    rows = {r["config"]: r for r in out["results"]}
    assert set(rows) == {"scene1_megakernel", "scene1_kdtree_lax"}
    for r in rows.values():
        assert r["tris"] == 652 and r["seconds_per_pass"] > 0 and r["launches"] == {}
    assert rows["scene1_kdtree_lax"]["res"] == "16x12"
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["config"] for r in printed] == ["scene1_megakernel", "scene1_kdtree_lax"]


def test_suite_twin_exits_1_on_a_failing_row(tiny_suite, monkeypatch):
    def broken(name, *a, **k):
        raise RuntimeError(f"{name} broke")

    monkeypatch.setattr(bench_suite, "run_config", broken)
    assert bench_suite.main(["--device", "cpu", "--only", "scene1_megakernel"]) == 1
    with open(tiny_suite) as f:
        (row,) = json.load(f)["results"]
    assert row == {"config": "scene1_megakernel", "error": "RuntimeError: scene1_megakernel "
                   "broke"}


def test_wseg_check_twin_on_cpu(monkeypatch, tmp_path, capsys):
    """The whole segment against the split path, forward and gradient, at
    16x12 (the check of chip_smoke.py phases 28-29)."""
    monkeypatch.chdir(tmp_path)
    for name, value in (("QUICK_SIZE", (16, 12)), ("QUICK_SPP_PASSES", (1, 1)),
                        ("QUICK_GRAD_ITERS", 1)):
        monkeypatch.setattr(wseg_check, name, value)
    assert wseg_check.main(["--device", "cpu", "--quick"]) == 0
    out = json.loads(capsys.readouterr().out)
    with open(tmp_path / wseg_check.OUT) as f:
        assert json.load(f) == out
    assert out["ok"] and out["device"] == "cpu"
    assert out["forward"]["film"]["pixel_share"] >= 0.99
    assert set(out["gradient"]["grads"]) == {*wseg_check.FIELDS, "ok"}
