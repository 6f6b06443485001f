"""Profiling helpers, the counterpart of
``montecarlopathtracer_tpu/utils/profiling.py``.

- :func:`trace` profiles the enclosed block with ``torch.profiler``
  (host activity, and the card's kernels when CUDA is available) and
  writes a Chrome trace (``trace.json``, loadable in Perfetto or
  ``chrome://tracing``) into a directory. The CLI enables it with
  ``--profile-dir``.
- :func:`time_fn` times one call: CUDA events on the card, the host
  clock on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the enclosed block into ``<log_dir>/trace.json`` (no-op
    when ``log_dir`` is None or empty)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 1,
    device="cuda",
) -> float:
    """Seconds per call of ``fn(*args)`` after ``warmup`` calls: CUDA
    events around ``iters`` back-to-back calls on ``device``'s current
    stream when it is a CUDA device, the host clock otherwise."""
    device = torch.device(device)
    for _ in range(warmup):
        fn(*args)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
