"""The readers of the program's own spans and counters
(``perfbench/recorded.py``): their ratios on a synthetic record, nothing
read without one (an untraced run, a program that keeps none, a record
of other passes, the culled instance), a traced CPU run still correct
with them, and on the card a traced run that prints them."""

import json

import pytest

import perfbench_testing as PT
from perfbench_testing import card  # noqa: F401 (the fixture)

from perfbench import harness, tracing

CELL = "cornell_box.cvmc_launch"
NEW = ("host_ms_per_pass.keys", "b1r_live_share", "b1r_tail_share")
KERNEL = "regen_pass_kernel<false>"


def _record(passes=4, **kw):
    rec = {"passes": passes, "block_steps": 100, "slot_steps": 25_600, "live_steps": 19_200,
           "overflow": 0, "vote_chunks": 0, "blocks": 528, "kernel_ms": 120.0,
           "tail_ms": 6.0, "grid": 528, "launches": {"B1r": passes},
           "spans": {"pass": [passes, 0.13], "regen.keys": [passes, 0.0048]}}
    rec.update(kw)
    return rec


def _run(passes=4, trace=True):
    events = [(0.03 * i, 0.03 * i + 0.002, 0.03 * (i + 1)) for i in range(passes)]
    win = harness.Window(t0=0.0, t1=0.03 * passes, events=events, samples_per_event=100)
    summary = tracing.Summary(window_s=0.12, busy_s=0.118,
                              kernels={KERNEL: [passes, 0.1212]}, device_ops=[], idle_gaps=[])
    return harness.Run(setup_s=1.0, window=win, kind="progressive",
                       trace=summary if trace else None,
                       work={"B1r": {"kernel": KERNEL, "ops": 1.0, "bytes": 1.0}})


@pytest.fixture
def traced(monkeypatch):
    """Set what the program's ``profiling.traced()`` returns."""
    from montecarlopathtracer_tpu_torch.utils import profiling

    def give(rec):
        monkeypatch.setattr(profiling, "traced", lambda: rec)
    return give


def _read(name, run):
    return harness.reader(name).read(run)


def test_the_readers_compute_their_ratios(traced):
    traced(_record())
    run = _run()
    keys, note = _read("host_ms_per_pass.keys", run)
    assert keys == pytest.approx(0.0048 / 4 * 1e3) and note == "4 spans over 4 passes"
    live, note = _read("b1r_live_share", run)
    assert live == pytest.approx(75.0) and note.startswith("overflow 0; blocks 528 of 528")
    tail, note = _read("b1r_tail_share", run)
    assert tail == pytest.approx(5.0)
    assert "kernel_ms / passes 30.0" in note and "30.3 ms a launch over 4" in note


@pytest.mark.parametrize("case", ["untraced", "no_record", "other_passes", "culled",
                                  "no_kernel", "no_keys_span"])
def test_the_readers_read_nothing_without_their_inputs(traced, case):
    run = _run(trace=case != "untraced")
    rec = {"no_record": None, "other_passes": _record(passes=5),
           "culled": _record(launches={"B1r": 2, "B1rc": 2}),
           "no_kernel": _record(slot_steps=0, kernel_ms=0.0),
           "no_keys_span": _record(spans={"pass": [4, 0.13]})}.get(case, _record())
    traced(rec)
    got = {name: _read(name, run) for name in NEW}
    if case == "culled":
        assert got["b1r_live_share"] is None and got["b1r_tail_share"] is None
        assert got["host_ms_per_pass.keys"] is not None
    elif case == "no_kernel":
        assert got["b1r_live_share"] is None and got["b1r_tail_share"] is None
    elif case == "no_keys_span":
        assert got["host_ms_per_pass.keys"] is None and got["b1r_live_share"] is not None
    else:
        assert got == dict.fromkeys(NEW)


def test_a_program_without_a_record_gives_nothing(monkeypatch):
    from montecarlopathtracer_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "traced")
    assert {name: _read(name, _run()) for name in NEW} == dict.fromkeys(NEW)


def test_a_traced_cpu_run_keeps_the_windows_passes_and_is_correct():
    from montecarlopathtracer_tpu_torch.utils import profiling

    rc, line, err = PT.run_cell(CELL, overrides={"spp_per_pass": 4}, trace=1)
    assert rc == 0, err
    assert line["correct"] is True, err
    rec = profiling.traced()
    assert rec["passes"] == line["attempted"]
    assert rec["spans"]["pass"][0] == line["attempted"]
    assert rec["spans"]["regen.step"][0] >= line["attempted"]  # the CPU's host loop
    assert not set(NEW) & set(line["metrics"])  # no pass kernel and no key table here


@pytest.mark.cuda
def test_a_traced_run_on_the_card_prints_the_programs_metrics(card, capsys):
    from perfbench import run

    assert run.main(["--workload", CELL, "--seed", str(PT.SEED), "--seconds", "2",
                     "--trace", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert 0.0 < m["host_ms_per_pass.keys"] < m["host_ms_per_pass.render"]
    assert 0.0 < m["b1r_live_share"] <= 100.0
    assert line["notes"]["b1r_live_share"].startswith("overflow 0;")
    assert 0.0 <= m["b1r_tail_share"] < 100.0
