"""The smallpt cell: its scene builder's spheres and cap, the readers of
the culled pass kernel B1rc on synthetic records and traces (nothing
read for an unculled record, an untraced run or a program that does not
count the table's chunks), the culled driver's work count, and runs of
the cell on the CPU at 32x24: sound ones correct, a frame biased by 2 %
and the controls not; on the card, a short traced run that prints the
new metrics."""

import json
import math

import numpy as np
import pytest

import perfbench_testing as PT
from perfbench_testing import card  # noqa: F401 (the fixture)

from perfbench import counts_cull, harness, tracing
from perfbench.scenes import spheres

CELL = "smallpt.rr_progressive"
SIZE = {"width": 32, "height": 24, "spp_per_pass": 4}
NEW = ("b1rc_roofline", "b1rc_live_share", "b1rc_tail_share", "b1rc_chunk_share")
KERNEL = counts_cull.KERNEL


def test_spheres_and_caps_lie_on_their_spheres():
    unit, faces = spheres.icosphere(2)
    assert len(faces) == 320 and np.allclose(np.linalg.norm(unit, axis=1), 1.0)
    unit, faces = spheres.cap((0.0, 10.0, 0.0), 10.0, 1.0, segments=8, rings=3)
    assert len(faces) == 8 * 5 and len(unit) == 1 + 8 * 3
    pts = 10.0 * unit + np.array([0.0, 10.0, 0.0])
    assert np.allclose(pts[-8:, 1], 1.0) and pts[:, 1].min() == pytest.approx(0.0)
    a = spheres.build(materials={"m": {"Kd": [0.5, 0.5, 0.5]}},
                      spheres=[{"group": "s", "material": "m", "center": [1, 2, 3], "radius": 2,
                                "subdiv": 1}],
                      caps=[{"group": "c", "material": "m", "center": [0, 5, 0], "radius": 5,
                             "below": 1.0, "segments": 6, "rings": 2}])
    assert a.num_triangles == 80 + 18
    n = a.normals[a.tri_n].reshape(-1, 3)
    assert np.allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)


def _record(passes=4, **kw):
    rec = {"passes": passes, "block_steps": 100, "slot_steps": 12_800, "live_steps": 9_600,
           "overflow": 0, "vote_chunks": 105_600, "blocks": 264, "kernel_ms": 200.0,
           "tail_ms": 30.0, "grid": 264, "chunks": 22 * passes, "launches": {"B1rc": passes},
           "spans": {"pass": [passes, 0.13], "regen.keys": [passes, 0.0048]}}
    rec.update(kw)
    return rec


def _run(passes=4, trace=True, work=True):
    events = [(0.05 * i, 0.05 * i + 0.002, 0.05 * (i + 1)) for i in range(passes)]
    win = harness.Window(t0=0.0, t1=0.05 * passes, events=events, samples_per_event=100)
    summary = tracing.Summary(window_s=0.2, busy_s=0.19, kernels={KERNEL: [passes, 0.184]},
                              device_ops=[], idle_gaps=[])
    return harness.Run(setup_s=1.0, window=win, kind="progressive",
                       trace=summary if trace else None,
                       work={"B1rc": {"kernel": KERNEL, "ops": 3.35e9, "bytes": 1.0e6}}
                       if work else None,
                       peak={"f32_flops": 67e12, "bytes_per_s": 3.35e12})


@pytest.fixture
def traced(monkeypatch):
    """Set what the program's ``profiling.traced()`` returns."""
    from montecarlopathtracer_tpu_torch.utils import profiling

    def give(rec):
        monkeypatch.setattr(profiling, "traced", lambda: rec)
    return give


def _read(name, run):
    return harness.reader(name).read(run)


def test_the_b1rc_readers_compute_their_ratios(traced):
    traced(_record())
    run = _run()
    roof, note = _read("b1rc_roofline", run)
    assert roof == pytest.approx(100.0 * 3.35e9 / 67e12 * 4 / 0.184)
    assert note.startswith("bound by ops; 4 launches")
    live, note = _read("b1rc_live_share", run)
    assert live == pytest.approx(75.0) and note.startswith("overflow 0; blocks 264 of 264")
    tail, note = _read("b1rc_tail_share", run)
    assert tail == pytest.approx(15.0)
    assert "kernel_ms / passes 50.0" in note and "46.0 ms a launch over 4" in note
    share, note = _read("b1rc_chunk_share", run)
    assert share == pytest.approx(100.0 * (105_600 / 9_600) / 22)
    assert note == "11.0 chunks tested a live lane-step of 22.0"


@pytest.mark.parametrize("case", ["untraced", "no_record", "other_passes", "unculled",
                                  "mixed", "no_kernel", "no_chunks", "no_work"])
def test_the_b1rc_readers_read_nothing_without_their_inputs(traced, case):
    run = _run(trace=case != "untraced", work=case != "no_work")
    rec = {"no_record": None, "other_passes": _record(passes=5),
           "unculled": _record(launches={"B1r": 4}, chunks=0),
           "mixed": _record(launches={"B1r": 2, "B1rc": 2}),
           "no_kernel": _record(slot_steps=0, kernel_ms=0.0, live_steps=0),
           "no_chunks": {k: v for k, v in _record().items() if k != "chunks"}}.get(
               case, _record())
    traced(rec)
    got = {name: _read(name, run) for name in NEW}
    if case == "no_chunks":  # a program that does not count the table's chunks
        assert got["b1rc_chunk_share"] is None
        assert None not in (got["b1rc_live_share"], got["b1rc_tail_share"],
                            got["b1rc_roofline"])
    elif case in ("unculled", "mixed", "no_kernel", "other_passes", "no_record"):
        assert got["b1rc_live_share"] is None and got["b1rc_tail_share"] is None
        assert got["b1rc_chunk_share"] is None
        assert got["b1rc_roofline"] is not None  # the trace's kernel, not the record
    elif case == "no_work":
        assert got["b1rc_roofline"] is None and got["b1rc_live_share"] is not None
    else:
        assert got == dict.fromkeys(NEW)


def test_the_unculled_readers_read_nothing_of_a_culled_record(traced):
    traced(_record())
    run = _run()
    assert _read("b1r_live_share", run) is None and _read("b1r_tail_share", run) is None
    assert _read("b1r_roofline", run) is None  # no B1r entry in the culled work


def test_the_culled_drivers_work_count():
    from perfbench.drivers import progressive_culled as D

    ctx = harness.load_context(CELL, PT.SEED, 0.0, True, "cpu",
                               {**SIZE, "reach_pixels": 32})
    w = D.work(ctx)
    assert set(w) == {"B1rc"} and w["B1rc"]["kernel"] == KERNEL
    T = ctx.scene_arrays().num_triangles
    assert T == 2696
    # 32x24 lanes of 4 samples, each segment reaching at least its own hit's box.
    assert 32 * 24 * 4 * 17 <= w["B1rc"]["ops"] <= 32 * 24 * 4 * 16 * T * 17
    nc, leaves = math.ceil(T / 128), math.ceil(T / 16)
    table = T * 48 * 4 + nc * 8 * 4 + (T + leaves) * 16 * 4
    assert w["B1rc"]["bytes"] == table + (4 * 16 + 1) * 40 + 56 + 32 * 24 * 16 + 80
    with pytest.raises(ValueError):
        D.work(harness.load_context(CELL, PT.SEED, 0.0, True, "cpu",
                                    {**SIZE, "chunk_cull": False}))


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_of_the_cell_is_correct(trace):
    rc, line, err = PT.run_cell(CELL, seconds=1.0, trace=trace, overrides=SIZE)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert line["checks"]["film_gap"]["value"] <= 1e-6  # the CPU's plain path is the reference's
    if trace:
        assert not set(NEW) & set(line["metrics"])  # no pass kernel on the CPU
        assert "pass_ms_p50" in line["metrics"]
    else:
        assert {"msamples_per_s", "pass_ms_p95", "setup_s"} <= set(line["metrics"])


def test_a_frame_biased_by_two_percent_is_not_correct():
    def biased(drv):
        from montecarlopathtracer_tpu_torch.render import renderer

        update = renderer.film_update
        renderer.film_update = lambda film, mean, weight: update(film, mean * 1.02, weight)

    from montecarlopathtracer_tpu_torch.render import renderer

    saved = renderer.film_update
    try:
        rc, line, err = PT.run_cell(CELL, seconds=0.3, patch=biased, overrides=SIZE)
    finally:
        renderer.film_update = saved
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


def test_the_controls_are_not_correct_but_the_blurred_mirror_may_be():
    from perfbench import control_smallpt as C

    ctx = harness.load_context(CELL, PT.SEED, 0.3, False, "cpu",
                               {**PT.SMALL, **SIZE, "check_pixels": 64})
    got = C.render_controls(ctx, passes=2)
    assert set(got) == {"bf16", "bf16_tables", "biased", "mirror_ns1000"}
    limit = float(ctx.limits["film_gap"])
    assert got["biased"] == pytest.approx(0.02)
    assert min(got["bf16"], got["bf16_tables"], got["biased"]) > limit, got
    assert C.mirror_at(ctx, 5.0).config["builder_args"]["materials"]["mirror"]["Ns"] == 5.0
    assert ctx.config["builder_args"]["materials"]["mirror"]["Ns"] == 1e6


@pytest.mark.cuda
def test_a_traced_run_on_the_card_prints_the_b1rc_metrics(card, capsys):
    from perfbench import run

    assert run.main(["--workload", CELL, "--seed", str(PT.SEED), "--seconds", "2",
                     "--trace", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(m)
    assert 0.0 < m["b1rc_roofline"] < 100.0 and 0.0 < m["b1rc_live_share"] <= 100.0
    assert 0.0 <= m["b1rc_tail_share"] < 100.0 and 0.0 < m["b1rc_chunk_share"] <= 100.0
