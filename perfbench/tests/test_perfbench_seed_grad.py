"""The decorrelated inverse-rendering cell,
``cornell_box_inverse_seed_grad.adam_seed_grad``, on the CPU at a small
size: a sound run is correct, traced and untraced; each control (the
adjoint under the primal's key, the gradient x 1.02, the adjoint at half
the samples, the reference in bfloat16 in the program's place) fails a
limit; a program without the option fails at once; the configuration's
scene and job are the correlated cell's, key for key; the new reader
reads its inputs and nothing without them, and the readers it shares
with the correlated cell read this cell's runs. On the card, a short
traced run is correct and prints the cell's per-layer metrics."""

import json
import re

import pytest

import perfbench_testing as PT
from perfbench_testing import card  # noqa: F401 (the fixture)

from perfbench import control_seed_grad as C
from perfbench import harness, tracing

CELL = "cornell_box_inverse_seed_grad.adam_seed_grad"
LIMITS = harness.load_json(PT.ROOT / "perfbench/limits" / f"{CELL}.json")
CONFIG = harness.load_json(PT.ROOT / "perfbench/configs/cornell_box_inverse_seed_grad.json")
FAST = {"target_spp": 16}  # the target's samples: the CPU's time, not what is checked
# A CPU job is a few steps of seconds each: three from the published
# value at a tenth of the rate, so param_gap reads a job that ends near
# it, as a whole job on the card does.
SOUND = {**FAST, "job_steps": 3, "start": CONFIG["builder_args"]["materials"]["red"]["Kd"],
         "lr": 0.005}
SHORT_JOBS = {**FAST, "job_steps": 3}  # a fault run reads its own check, not param_gap
CAUGHT_BY = {"one_key": "grad_gap", "grad_x1.02": "grad_gap", "half_adjoint": "grad_gap"}
SHARED = ("pass_ms_p50", "device_idle_share.render", "host_ms_per_step.forward",
          "host_ms_per_step.backward", "b1_roofline", "b2_roofline")


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(trace):
    rc, line, err = PT.run_cell(CELL, overrides=SOUND, trace=trace)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert set(line["checks"]) == set(LIMITS)
    assert line["attempted"] >= 3  # at least one whole job
    if trace:
        # The CPU's trace has the program's spans and the steps' median;
        # no card, so no roofline, no idle share and no kernel to share.
        assert set(line["metrics"]) == {"host_ms_per_step.forward", "host_ms_per_step.backward",
                                        "pass_ms_p50"}
        assert line["notes"]["host_ms_per_step.forward"].endswith(
            f"over {line['attempted']} steps")
    else:
        assert set(line["metrics"]) == {"msamples_per_s", "pass_ms_p95", "setup_s"}
        # An event is a step of both renders: 2 x W x H x spp samples.
        seconds, steps = re.search(r"window ([0-9.]+) s of ([0-9]+)", err).groups()
        assert int(steps) == line["attempted"]
        want = int(steps) * 2 * PT.SMALL["width"] * PT.SMALL["height"] * 4 / float(seconds) / 1e6
        assert line["metrics"]["msamples_per_s"]["value"] == pytest.approx(want, rel=1e-3)


@pytest.mark.parametrize("fault", sorted(C.FAULTS))
def test_a_broken_gradient_path_is_not_correct(fault):
    correct, checks = C.fault_checks(PT.SEED, 0.3, fault, device="cpu",
                                     overrides={**PT.SMALL, **SHORT_JOBS})
    assert correct is False
    assert checks[CAUGHT_BY[fault]] > LIMITS[CAUGHT_BY[fault]], checks


def test_the_bf16_control_is_not_correct():
    ctx = harness.load_context(CELL, PT.SEED, 0.3, False, "cpu", {**PT.SMALL, **FAST})
    readings = C.bf16_readings(ctx)
    assert set(readings) == {"target_gap", "loss_gap", "grad_gap", "update_gap"}
    assert all(v > LIMITS[k] for k, v in readings.items()), readings


def test_a_program_without_the_option_fails_at_once(monkeypatch):
    from montecarlopathtracer_tpu_torch.diff import grad as G

    monkeypatch.delattr(G, "SEED_GRAD")
    with pytest.raises(SystemExit, match="seed_grad"):
        PT.run_cell(CELL, overrides=SOUND)


def test_the_scene_and_job_are_the_correlated_cells_key_for_key():
    inverse = harness.load_json(PT.ROOT / "perfbench/configs/cornell_box_inverse.json")
    assert set(CONFIG) - set(inverse) == {"seed_grad", "job_source"}
    assert CONFIG["seed_grad"] == "own"
    # The job is the tutorial's; the source is mi.render's, whose
    # seed_grad and spp_grad make this deployment the one it is.
    assert CONFIG["job_source"] == inverse["source"] != CONFIG["source"]
    assert CONFIG["source"].endswith("api_reference.html#mitsuba.render")
    for key in set(inverse) - {"name", "assumed", "source"}:
        assert CONFIG[key] == inverse[key], key
    assert CONFIG["reduced"] == [] and CONFIG["name"] == "cornell_box_inverse_seed_grad"
    mine = harness.load_json(PT.ROOT / "perfbench/traffic/adam_seed_grad.json")
    theirs = harness.load_json(PT.ROOT / "perfbench/traffic/adam_red_wall.json")
    for key in set(theirs) - {"driver", "source", "why"}:
        assert mine[key] == theirs[key], key


def test_no_two_configurations_share_a_source_and_its_cuts():
    manifest = harness.load_json(PT.ROOT / "BENCHMARK.json")
    pairs = [(c["source"], tuple(sorted(c["reduced"]))) for c in manifest["configs"]]
    assert len(pairs) == len(set(pairs))
    mine = next(c for c in manifest["configs"] if c["name"] == CONFIG["name"])
    assert mine["source"] == CONFIG["source"] and mine["reduced"] == CONFIG["reduced"]


def _run(kernels=None, steps=4, work=True):
    events = [(0.03 * i, 0.03 * i + 0.004, 0.03 * (i + 1)) for i in range(steps)]
    win = harness.Window(t0=0.0, t1=0.03 * steps, events=events, samples_per_event=100)
    summary = tracing.Summary(window_s=0.12, busy_s=0.1, kernels=kernels or {},
                              device_ops=[], idle_gaps=[])
    ctx = harness.load_context(CELL, PT.SEED, 0.3, False, "cpu", {**PT.SMALL, "reach_pixels": 8})
    entries = harness.driver(ctx).work(ctx) if work else None
    return harness.Run(setup_s=1.0, window=win, kind=harness.driver(ctx).KIND, trace=summary,
                       work=entries, peak={"f32_flops": 67e12, "bytes_per_s": 3.35e12})


@pytest.fixture
def traced(monkeypatch):
    from montecarlopathtracer_tpu_torch.utils import profiling

    def give(rec):
        monkeypatch.setattr(profiling, "traced", lambda: rec)
    return give


KERNELS = {"mega_segment_kernel<false>": [128, 0.02], "uniform_kernel": [144, 0.004],
           "segment_backward_kernel": [64, 0.02]}  # four steps at 4 spp


def test_the_primal_share_reads_the_programs_counts_and_nothing_without(traced):
    launches = {"B1": 128, "B1p": 64, "RNG": 144, "RNGp": 72, "B2": 64}
    traced({"steps": 4, "passes": 0, "launches": launches, "spans": {}})
    share, note = harness.reader("primal_device_share").read(_run(KERNELS, work=False))
    assert share == pytest.approx(100.0 * (0.02 * 64 / 128 + 0.004 * 72 / 144) / 0.1)
    assert note.startswith("B1p 64 of B1 128, 0.02 s in 128 launches; RNGp 72 of RNG 144")
    for launched in ({**launches, "B1p": 0}, {"B1": 128, "RNG": 144}):  # a program that
        traced({"steps": 4, "passes": 0, "launches": launched, "spans": {}})  # counts none
        assert harness.reader("primal_device_share").read(_run(KERNELS, work=False)) is None
    traced({"steps": 4, "passes": 0, "launches": launches, "spans": {}})
    assert harness.reader("primal_device_share").read(_run({}, work=False)) is None
    traced({"steps": 5, "passes": 0, "launches": launches, "spans": {}})  # another stretch
    assert harness.reader("primal_device_share").read(_run(KERNELS, work=False)) is None
    traced(None)
    assert harness.reader("primal_device_share").read(_run(KERNELS, work=False)) is None


def test_the_shared_readers_read_this_cells_runs(traced):
    manifest = harness.load_json(PT.ROOT / "BENCHMARK.json")
    listed = {m["name"] for m in manifest["per_layer"] if CELL in m.get("workloads", [])}
    assert listed == set(SHARED) | {"primal_device_share"}
    traced({"steps": 4, "passes": 0, "spans": {"grad.forward": [4, 0.008],
                                               "grad.backward": [4, 0.012]}})
    run = _run(KERNELS)
    assert harness.reader("pass_ms_p50").read(run) == pytest.approx(30.0)
    assert harness.reader("device_idle_share.render").read(run) == pytest.approx(100 / 6)
    assert harness.reader("host_ms_per_step.forward").read(run)[0] == pytest.approx(2.0)
    assert harness.reader("host_ms_per_step.backward").read(run)[0] == pytest.approx(3.0)
    # Both renders' B1 launches are calls of the same work; B2 only the adjoint's.
    for name, entry, calls in (("b1_roofline", "B1", 128), ("b2_roofline", "B2", 64)):
        share, note = harness.reader(name).read(run)
        w = run.work[entry]
        bound = max(w["ops"] / 67e12, w["bytes"] / 3.35e12) * calls
        assert share == pytest.approx(100.0 * bound / 0.02) and f"{calls} calls" in note


@pytest.mark.cuda
def test_a_short_traced_run_on_the_card_is_correct(card, capsys):
    from perfbench import run

    assert run.main(["--workload", CELL, "--seed", str(PT.SEED), "--seconds", "3",
                     "--trace", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == set(SHARED) | {"primal_device_share"}
    for name in ("b1_roofline", "b2_roofline", "primal_device_share"):
        assert 0.0 < line["metrics"][name]["value"] <= 100.0
    assert 0.0 <= line["metrics"]["device_idle_share.render"]["value"] < 100.0
