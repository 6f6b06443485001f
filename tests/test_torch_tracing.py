"""The port's spans and counters (utils/profiling.py) on the CPU: a span
is one shared null context while no profiler records, a Renderer pass
emits its nested spans under ``torch.profiler``, a recording sums the
pass kernel's counters and decodes their clocks, nothing is kept
while nothing records, a CUDA graph's replay adds the launches its
capture counted, and the launch table works under
``testing.plain_kernels`` and takes its own names only."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from montecarlopathtracer_tpu_torch.diff import grad as G
from montecarlopathtracer_tpu_torch.models import cornell
from montecarlopathtracer_tpu_torch.ops import regen_pass as RP
from montecarlopathtracer_tpu_torch.ops import selection_micro as SM
from montecarlopathtracer_tpu_torch.ops.rng import make_key
from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
from montecarlopathtracer_tpu_torch.testing import (
    cap_torch_threads,
    plain_kernels,
    program_spans,
)
from montecarlopathtracer_tpu_torch.utils import profiling

cap_torch_threads()

W, H = 16, 12


def test_a_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a RecordFunction was created with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("pass", {"pass": 0, "request": 1})
    assert first is profiling.span("regen.keys")
    assert isinstance(first, contextlib.nullcontext)
    with first:
        pass


@pytest.mark.parametrize("regen", [True, False], ids=["regen", "sample_loop"])
def test_a_renderer_pass_emits_its_nested_spans(tmp_path, regen):
    scene, camera = cornell.cornell_box(width=W, height=H, device="cpu")
    config = TraceConfig(mode="fixed", max_depth=2, intersector="megakernel")
    settings = RenderSettings(width=W, height=H, spp_per_pass=2, regen=regen)
    r = Renderer(scene, camera, config, settings, device="cpu")
    r.render(1)  # pass 0, untraced
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render(1)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = program_spans(tmp_path / "trace.json")
    passes = [s for s in spans if s[0] == "pass"]
    assert [p[1] for p in passes] == [{"pass": 1, "request": 2}]
    _, _, lo, hi = passes[0]
    inner = "regen.step" if regen else "sample"
    for name in ("film.update", inner):
        assert any(s[0] == name and lo <= s[2] and s[3] <= hi for s in spans), name
    assert not any(s[0] == ("sample" if regen else "regen.step") for s in spans)
    rec = profiling.traced()
    assert rec["passes"] == 1 and rec["spans"]["pass"][0] == 1
    assert rec["spans"]["film.update"][0] == 1 and rec["spans"][inner][0] >= 2
    assert rec["kernel_ms"] == 0.0 and rec["live_steps"] == 0  # the CPU runs no pass kernel


def _work(counts, t_start, t_spent, t_end):
    """A pass kernel's work buffer as the kernel leaves it: the counters,
    the clocks kept as -1 - t, -1 - t (0: never spent) and t, the head."""
    spent = 0 if t_spent is None else -1 - t_spent
    return torch.tensor([*counts, -1 - t_start, spent, t_end, 7], dtype=torch.int64)


def test_a_recording_sums_the_counters_and_decodes_the_clocks():
    t = 1_700_000_000_000_000_000  # the card's clock, ns
    works = [_work((10, 2560, 2000, 0, 0, 9, 0, 0), t, t + 3_000_000, t + 4_500_000),
             _work((4, 1024, 900, 1, 5, 3, 40, 31), t + 9_000_000, None, t + 10_250_000),
             _work((7, 1792, 1500, 0, 2, 9, 12, 0), t + 20_000_000, t + 20_100_000,
                   t + 20_100_001)]
    assert RP.COUNTERS[-2:] == ("leaf_visits", "pair_leaves")  # before the three clocks
    with profiling.recording() as outer:
        with profiling.recording() as rec:
            for i, w in enumerate(works):
                profiling.count_pass()
                profiling.keep(w, 9 + i, ordered=i != 1, chunks=22 if i == 2 else 0)
        profiling.count_pass()
    times = [RP.pass_times(w[:len(RP.STATS)]) for w in works]
    assert times[1][0] is None
    assert rec["passes"] == 3 and outer["passes"] == 4
    for i, name in enumerate(RP.COUNTERS):
        assert rec[name] == outer[name] == sum(int(w[i]) for w in works), name
    assert (rec["leaf_visits"], rec["pair_leaves"]) == (52, 31)
    assert rec["grid"] == 9 + 10 + 11 and rec["ordered"] == outer["ordered"] == 2
    assert rec["chunks"] == outer["chunks"] == 22  # one culled launch of 22 chunks
    assert rec["kernel_ms"] == pytest.approx(sum(end for _, end in times), abs=1e-12)
    assert rec["kernel_ms"] == pytest.approx(4.5 + 1.25 + 0.100001, abs=1e-12)
    assert rec["tail_ms"] == pytest.approx(1.5 + 0.0 + 0.000001, abs=1e-12)
    assert rec["tail_ms"] == pytest.approx(
        sum(end - spent for spent, end in times if spent is not None), abs=1e-12)
    clocks = RP.pass_clocks(torch.stack(works)[:, :len(RP.STATS)])
    assert clocks[1].tolist() == [t + 9_000_000, -1, t + 10_250_000]
    assert torch.equal(clocks[0], RP.pass_clocks(works[0][:len(RP.STATS)]))
    assert rec["launches"] == {} and rec["spans"] == {}


def test_nothing_is_kept_while_nothing_records():
    assert not torch.autograd._profiler_enabled() and not profiling._recordings
    traced = profiling._traced
    state = None if traced is None else (traced.passes, len(traced.work), traced.grid)
    profiling.count_pass()
    profiling.keep(_work((1,) * len(RP.COUNTERS), 5, 6, 7), 4)
    assert profiling._traced is traced
    assert state == (None if traced is None else (traced.passes, len(traced.work), traced.grid))
    with profiling.recording() as rec:
        pass
    assert rec["passes"] == 0 and rec["grid"] == 0 and rec["kernel_ms"] == 0.0
    assert rec["ordered"] == 0 and rec["chunks"] == 0


def test_a_replay_adds_exactly_what_its_capture_counted(monkeypatch):
    """diff/grad.py's ``graphed_loss`` books what one replay holds as
    ``{name: n}``: the launches counted over its eager runs and captures,
    divided by their number (at 4 spp and depth 7 + the gather: 32 each
    of B1, B2 and B3, 36 of RNG); ``count_replay`` adds exactly that at
    each replay, by name and nothing else. The CPU has no CUDA graphs: the
    capture here runs the loss as often as the real one runs it, and the
    loss counts its launches by hand."""
    per_run = {"B1": 32, "B2": 32, "B3": 32, "RNG": 36}

    def loss_fn(params, key):
        for name, n in per_run.items():
            profiling.count_launch(name, n)
        return params["mat_kd"].sum()

    def capture(fn, sample, num_warmup_iters):
        for _ in range(num_warmup_iters + 1):  # the eager runs, then the capture
            fn(*sample)
        return fn

    monkeypatch.setattr(torch.cuda, "make_graphed_callables", capture)
    saved = profiling.launches()
    try:
        _, held = G.graphed_loss(loss_fn, {"mat_kd": torch.ones(3, 3)}, make_key(1))
        assert held == per_run
        with profiling.recording() as rec:
            for _ in range(3):
                profiling.count_replay(held)
        assert rec["launches"] == {name: 3 * n for name, n in per_run.items()}
    finally:
        profiling._launched.update(saved)


def test_the_launch_table_works_under_plain_kernels():
    """The counts live in utils/profiling.py, not on the kernel wrappers
    that ``testing.plain_kernels`` swaps for their plain versions: a
    recording, ``launches`` and ``reset_launches`` run inside it, and a
    render there counts no launch."""
    scene, camera = cornell.cornell_box(width=W, height=H, device="cpu")
    config = TraceConfig(mode="fixed", max_depth=2, intersector="megakernel")
    r = Renderer(scene, camera, config, RenderSettings(width=W, height=H, spp_per_pass=1),
                 device="cpu")
    saved = profiling.launches()
    try:
        with plain_kernels():
            before = profiling.launches()
            with profiling.recording() as rec:
                r.render(1)
            assert rec["passes"] == 1 and rec["launches"] == {}
            assert profiling.launches() - before == {}
            profiling.reset_launches()
            assert profiling.launches() == dict.fromkeys(profiling.KERNELS, 0)
    finally:
        profiling._launched.update(saved)


def test_the_launch_table_refuses_a_name_outside_it():
    """``count_launch`` takes the kernel table's names only (B12's per
    variant among them), and after ``reset_launches`` every name reads 0,
    printed as nothing launched."""
    saved = profiling.launches()
    try:
        with pytest.raises(ValueError, match="B2i"):
            profiling.count_launch("B2i")
        with pytest.raises(ValueError, match="launch table"):
            profiling.count_replay({"B1": 1, "mega_segment": 1})
        assert {f"B12 {v}" for v in SM.VARIANTS} <= set(profiling.KERNELS)
        assert len(set(profiling.KERNELS)) == len(profiling.KERNELS)
        profiling.count_launch("B4c", 2)
        profiling.reset_launches()
        counts = profiling.launches()
        assert set(counts) == set(profiling.KERNELS)
        assert all(counts[name] == 0 for name in profiling.KERNELS)
        assert repr(counts) == "{}" and counts["not a kernel"] == 0
    finally:
        profiling._launched.update(saved)
