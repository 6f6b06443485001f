"""The traced run: ``torch.profiler`` over the window, reduced to the
device's busy time, each kernel's time and launches, and the idle gaps
named by the benchmark span (and the innermost host operation) the host
was in.

The trace is exported as Chrome trace JSON into ``$TMPDIR`` and deleted
once read. Device activity is every ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` event; the window is the ``perfbench.window`` span.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: dict  # short name -> [launches, seconds]
    device_ops: list  # [[name, seconds]] the longest in total, at most TOP
    idle_gaps: list  # [[what the host was doing, seconds]], at most TOP

    def kernel(self, needle: str):
        """(launches, seconds) of the kernels whose name holds ``needle``."""
        n, s = 0, 0.0
        for name, (k, sec) in self.kernels.items():
            if needle in name:
                n += k
                s += sec
        return n, s


@contextlib.contextmanager
def profiled(on: bool, out: dict):
    """Profile the block when ``on``; ``out["summary"]`` then holds its
    :class:`Summary`."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=False, profile_memory=False,
                 with_stack=False) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out["summary"] = summarize(events)


def short(name: str) -> str:
    """A kernel's name without its namespace, return type and arguments."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return base[5:] if base.startswith("void ") else base


def union_within(intervals, lo, hi):
    """Merged [start, end) intervals clipped to [lo, hi]."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class _Innermost:
    """The innermost of nested host intervals that holds a time."""

    def __init__(self, spans):
        self.spans = sorted(spans)  # (start, end, name)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float, look: int = 64):
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - look, -1), -1):
            s, e, name = self.spans[j]
            if s <= t < e:
                return name
        return None


def summarize(events) -> Summary:
    """The :class:`Summary` of a Chrome trace's events (times in us)."""
    window = None
    device, spans, ops = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        name = ev.get("name", "")
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name, cat))
        elif cat == "user_annotation" and name.startswith("perfbench."):
            if name == "perfbench.window":
                window = (ts, ts + dur)
            else:
                spans.append((ts, ts + dur, name[len("perfbench."):]))
        elif cat == "cpu_op":
            ops.append((ts, ts + dur, name))
    if window is None:
        raise RuntimeError("the trace holds no perfbench.window span")
    lo, hi = window
    inside = [d for d in device if d[1] > lo and d[0] < hi]
    busy = union_within([(s, e) for s, e, _, _ in inside], lo, hi)
    kernels = defaultdict(lambda: [0, 0.0])
    for s, e, name, cat in inside:
        k = kernels[short(name) if cat == "kernel" else cat]
        k[0] += 1
        k[1] += (min(e, hi) - max(s, lo)) / 1e6
    span_at, op_at = _Innermost(spans), _Innermost(ops)
    gaps = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        what = f"{span_at.at(mid) or 'outside spans'} / {op_at.at(mid) or 'no host op'}"
        gaps[what] += (e - s) / 1e6
    busy_s = sum(e - s for s, e in busy) / 1e6
    device_ops = sorted(([n, v[1]] for n, v in kernels.items()), key=lambda x: -x[1])[:TOP]
    idle = sorted(([n, v] for n, v in gaps.items()), key=lambda x: -x[1])[:TOP]
    return Summary(window_s=(hi - lo) / 1e6, busy_s=busy_s, kernels=dict(kernels),
                   device_ops=device_ops, idle_gaps=idle)
