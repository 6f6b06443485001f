"""The rate and tail readers on synthetic pass records: a stall inside
the window lowers the rate and raises the 95th percentile; the trace's
busy time is the union of the device's intervals."""

import perfbench_testing as PT  # noqa: F401

from perfbench import harness, tracing


def _run(durations, kind="progressive", samples=1000):
    t, events = 0.0, []
    for dur in durations:
        events.append((t, t + 0.1 * dur, t + dur))
        t += dur
    win = harness.Window(t0=0.0, t1=t, events=events, samples_per_event=samples)
    return harness.Run(setup_s=1.0, window=win, kind=kind)


def _read(name, run):
    return harness.reader(name).read(run)


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    steady = _run([0.015] * 400)
    stalled = _run([0.015] * 180 + [0.2] * 30 + [0.015] * 190)
    assert abs(_read("msamples_per_s", steady) - 1000 / 0.015 / 1e6) < 1e-12
    assert _read("msamples_per_s", stalled) < _read("msamples_per_s", steady)
    assert _read("pass_ms_p95", stalled) > _read("pass_ms_p95", steady)
    assert abs(_read("pass_ms_p95", steady) - 15.0) < 1e-9


def test_p95_is_the_nearest_rank():
    run = _run([0.001 * (i + 1) for i in range(200)])
    assert abs(_read("pass_ms_p95", run) - 190.0) < 1e-9
    assert abs(_read("pass_ms_p50", run) - 100.5) < 1e-9


def test_readers_of_the_other_kind_read_nothing():
    run = _run([0.01] * 10, kind="another")
    assert _read("msamples_per_s", run) is None
    assert _read("pass_ms_p95", run) is None
    assert _read("b1r_roofline", run) is None
    assert _read("setup_s", run) == 1.0


def test_busy_time_is_the_union_of_device_intervals():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "perfbench.window", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "perfbench.dispatch", "ts": 0, "dur": 50},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 20, "dur": 5},
          {"ph": "X", "cat": "kernel", "name": "void k<false>(int)", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "void k<false>(int)", "ts": 25, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90, "dur": 20}]
    s = tracing.summarize(ev)
    assert abs(s.busy_s - 35e-6) < 1e-12 and abs(s.window_s - 100e-6) < 1e-12
    n, sec = s.kernel("k<false>")
    assert n == 2 and abs(sec - 30e-6) < 1e-12
    assert s.idle_gaps[0][0].startswith("dispatch") or s.idle_gaps[0][0].startswith("outside")
    assert abs(sum(g[1] for g in s.idle_gaps) - 65e-6) < 1e-12
