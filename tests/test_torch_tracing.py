"""The port's spans and counters (utils/profiling.py) on the CPU: a span
is one shared null context while no profiler records, a Renderer pass
emits its nested spans under ``torch.profiler``, a recording sums the
pass kernel's counters and decodes their clocks, nothing is kept
while nothing records, and a CUDA graph's replay counts B2 through the
index as it counts B2."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from montecarlopathtracer_tpu_torch.models import cornell
from montecarlopathtracer_tpu_torch.ops import regen_pass as RP
from montecarlopathtracer_tpu_torch.ops import segment_fused as F
from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
from montecarlopathtracer_tpu_torch.testing import cap_torch_threads, program_spans
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
    works = [_work((10, 2560, 2000, 0, 0, 9), t, t + 3_000_000, t + 4_500_000),
             _work((4, 1024, 900, 1, 5, 3), t + 9_000_000, None, t + 10_250_000),
             _work((7, 1792, 1500, 0, 2, 9), t + 20_000_000, t + 20_100_000, t + 20_100_001)]
    with profiling.recording() as outer:
        with profiling.recording() as rec:
            for i, w in enumerate(works):
                profiling.count_pass()
                profiling.keep(w, 9 + i, ordered=i != 1)
        profiling.count_pass()
    times = [RP.pass_times(w[:len(RP.STATS)]) for w in works]
    assert times[1][0] is None
    assert rec["passes"] == 3 and outer["passes"] == 4
    for i, name in enumerate(RP.COUNTERS):
        assert rec[name] == outer[name] == sum(int(w[i]) for w in works), name
    assert rec["grid"] == 9 + 10 + 11 and rec["ordered"] == outer["ordered"] == 2
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
    profiling.keep(_work((1,) * 6, 5, 6, 7), 4)
    assert profiling._traced is traced
    assert state == (None if traced is None else (traced.passes, len(traced.work), traced.grid))
    with profiling.recording() as rec:
        pass
    assert rec["passes"] == 0 and rec["grid"] == 0 and rec["kernel_ms"] == 0.0
    assert rec["ordered"] == 0


def test_a_replay_counts_b2_through_the_index_as_it_counts_b2():
    """The launch table holds B2's launches through the winner index beside
    B2's, so what a graphed step's capture launched (diff/grad.py's
    ``graphed_loss``: 32 B2 launches, all through the index, at 4 spp and
    depth 7 + the gather) is added to both at each replay. The CPU runs no
    graph: the capture's counts are made here by hand."""
    table = profiling._counters()
    k = table.index((F.segment_backward, "launches"))
    assert table[k + 1] == (F.segment_backward, "indexed_launches")
    saved = F.segment_backward.launches, F.segment_backward.indexed_launches
    try:
        before = profiling.launch_counts()
        F.segment_backward.launches += 32
        F.segment_backward.indexed_launches += 32
        captured = [n - b for n, b in zip(profiling.launch_counts(), before)]
        held = profiling.replay_counts(captured)
        assert held == [(F.segment_backward, "launches", 32),
                        (F.segment_backward, "indexed_launches", 32)]
        with profiling.recording() as rec:
            for _ in range(3):
                profiling.count_replay(held)
        assert rec["launches"] == {"B2": 96, "B2i": 96}
    finally:
        F.segment_backward.launches, F.segment_backward.indexed_launches = saved
