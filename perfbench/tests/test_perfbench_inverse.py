"""The inverse-rendering cell, ``cornell_box_inverse.adam_red_wall``, on
the CPU at a small size: a sound run is correct, traced and untraced;
each control (a run with half the samples, with the gradient x 1.02,
with one segment's row scatter dropped, and the reference in bfloat16
in the program's place) fails a limit; the configuration's scene is the
launch cell's, key for key; the step's readers read their inputs and
nothing without them. On the card, a short traced run is correct and
prints the cell's per-layer metrics."""

import json

import pytest

import perfbench_testing as PT
from perfbench_testing import card  # noqa: F401 (the fixture)

from perfbench import control_inverse as C
from perfbench import harness, tracing

CELL = "cornell_box_inverse.adam_red_wall"
FAST = {"target_spp": 16}  # the target's samples: the CPU's time, not what is checked
SHORT_JOBS = {**FAST, "job_steps": 4}  # a fault run reads its own check, not param_gap
# Traced, the CPU takes seconds a step: a job of 3 steps from near where
# a whole job ends, so param_gap still reads a finished job.
TRACED = {**FAST, "job_steps": 3, "start": [0.05, 0.02, 0.02]}
LIMITS = harness.load_json(PT.ROOT / "perfbench/limits" / f"{CELL}.json")
NEW = ("host_ms_per_step.forward", "host_ms_per_step.backward", "b1_roofline", "b2_roofline",
       "b3_roofline")
CAUGHT_BY = {"half_samples": "loss_gap", "grad_x1.02": "grad_gap", "b3_dropped": "grad_gap"}


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(trace):
    rc, line, err = PT.run_cell(CELL, overrides=TRACED if trace else FAST, trace=trace)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert set(line["checks"]) == set(LIMITS)
    assert line["attempted"] >= (3 if trace else 50)  # at least one whole job
    if trace:
        # The CPU's trace has the program's spans and the steps' median;
        # no card, so no roofline and no idle share.
        assert set(line["metrics"]) == {"host_ms_per_step.forward", "host_ms_per_step.backward",
                                        "pass_ms_p50"}
        assert line["notes"]["host_ms_per_step.forward"].endswith(
            f"over {line['attempted']} steps")
    else:
        assert set(line["metrics"]) == {"msamples_per_s", "pass_ms_p95", "setup_s"}


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


def test_the_scene_is_the_launch_cells_key_for_key():
    launch = harness.load_json(PT.ROOT / "perfbench/configs/cornell_box.json")
    inverse = harness.load_json(PT.ROOT / "perfbench/configs/cornell_box_inverse.json")
    for key in ("builder", "builder_args", "triangles", "camera", "precision"):
        assert inverse[key] == launch[key], key
    assert inverse["scene_source"] == launch["source"]
    assert inverse["reduced"] == [] and inverse["material"] in launch["builder_args"]["materials"]


def _run(steps=4, kernels=None, work=True, kind="progressive"):
    events = [(0.03 * i, 0.03 * i + 0.004, 0.03 * (i + 1)) for i in range(steps)]
    win = harness.Window(t0=0.0, t1=0.03 * steps, events=events, samples_per_event=100)
    summary = tracing.Summary(window_s=0.12, busy_s=0.11, kernels=kernels or {},
                              device_ops=[], idle_gaps=[])
    entries = {"B1": {"kernel": "mega_segment_kernel<false>", "launches_a_call": 1,
                      "ops": 0.0, "bytes": 3.35e12 * 1e-4},
               "B3": {"kernel": "scatter_rows_", "launches_a_call": 3, "ops": 0.0,
                      "bytes": 3.35e12 * 1e-4}}
    return harness.Run(setup_s=1.0, window=win, kind=kind, trace=summary,
                       work=entries if work else None,
                       peak={"f32_flops": 67e12, "bytes_per_s": 3.35e12})


@pytest.fixture
def traced(monkeypatch):
    from montecarlopathtracer_tpu_torch.utils import profiling

    def give(rec):
        monkeypatch.setattr(profiling, "traced", lambda: rec)
    return give


def test_the_step_readers_read_the_programs_spans(traced):
    rec = {"passes": 0, "steps": 4, "spans": {"grad.forward": [4, 0.008],
                                              "grad.backward": [4, 0.012]}}
    traced(rec)
    run = _run()
    fwd, note = harness.reader("host_ms_per_step.forward").read(run)
    assert fwd == pytest.approx(2.0) and note == "4 spans over 4 steps"
    assert harness.reader("host_ms_per_step.backward").read(run)[0] == pytest.approx(3.0)
    for other in ({**rec, "steps": 5}, {"passes": 4, "spans": rec["spans"]}, None):
        traced(other)  # another stretch, a program that counts no steps, no record
        assert harness.reader("host_ms_per_step.forward").read(run) is None


def test_the_rooflines_count_calls_and_read_nothing_without_kernels():
    kernels = {"mega_segment_kernel<false>": [8, 8e-3], "scatter_rows_sort_kernel": [8, 2e-3],
               "scatter_rows_sum_kernel": [8, 4e-3], "scatter_rows_combine_kernel": [8, 2e-3]}
    run = _run(kernels=kernels)
    b1, note = harness.reader("b1_roofline").read(run)
    assert b1 == pytest.approx(10.0) and note.startswith("bound by bytes; 8 calls")
    b3, note = harness.reader("b3_roofline").read(run)
    assert b3 == pytest.approx(10.0) and "8 calls, 24 launches" in note
    assert harness.reader("b2_roofline").read(run) is None  # no entry for it here
    assert harness.reader("b1_roofline").read(_run(work=False, kernels=kernels)) is None
    assert harness.reader("b1_roofline").read(_run(kernels={})) is None


@pytest.mark.cuda
def test_a_short_traced_run_on_the_card_is_correct(card, capsys):
    from perfbench import run

    assert run.main(["--workload", CELL, "--seed", str(PT.SEED), "--seconds", "3",
                     "--trace", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(NEW) <= set(line["metrics"]) and set(NEW) <= set(line["notes"])
    assert {"pass_ms_p50", "device_idle_share.render"} <= set(line["metrics"])
    assert 0.0 <= line["metrics"]["device_idle_share.render"]["value"] < 100.0
    for name in ("b1_roofline", "b2_roofline", "b3_roofline"):
        assert 0.0 < line["metrics"][name]["value"] <= 100.0
