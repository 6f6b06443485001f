"""Profiling helpers, the counterpart of
``montecarlopathtracer_tpu/utils/profiling.py``.

- :func:`trace` profiles the enclosed block with ``torch.profiler``
  (host activity, and the card's kernels when CUDA is available) and
  writes a Chrome trace (``trace.json``, loadable in Perfetto or
  ``chrome://tracing``) into a directory. The CLI enables it with
  ``--profile-dir``.
- :func:`time_fn` times one call: CUDA events on the card, the host
  clock on the CPU.
- :func:`reset_launches` and :func:`launches` zero and read every
  kernel wrapper's launch count (a wrapper counts only the launches of
  its CUDA kernel, never its plain version).
- :func:`card` names the card and its power limit, as ``nvidia-smi``
  reports them, for the lines that carry a measurement.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
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


class Counts(dict):
    """Launch counts of every kernel; printed with the kernels that
    launched only."""

    def __repr__(self):
        return repr({k: v for k, v in self.items() if v})


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from ..ops import cull as CU
    from ..ops import nearest_shade as NS
    from ..ops import nearest_variants as NV
    from ..ops import regen_pass as RP
    from ..ops import rng as RNG
    from ..ops import scatter_rows as S
    from ..ops import segment_fused as F
    from ..ops import selection_micro as SM
    from ..ops import traverse_walk as TW

    CU.cull_records.launches = RNG.stream_uniforms.launches = 0
    RP.regen_pass.launches = RP.regen_pass.cull_launches = 0
    F.mega_segment.launches = F.segment_backward.launches = S.scatter_rows.launches = 0
    F.mega_segment.lane_launches = F.mega_segment.cull_launches = 0
    F.mega_segment.lane_cull_launches = 0
    F.rows_segment.launches = F.rows_segment.lane_launches = 0
    TW.traverse_select.launches = TW.walk_tables.launches = NS.nearest_triangle.launches = 0
    NS.nearest_shade_full.launches = NS.nearest_shade_full.cull_launches = 0
    NV.nearest_shade.launches = NV.nearest_shade2.launches = NV.nearest_shade_culled.launches = 0
    NV.nearest_shade_streamed.launches = NV.nearest_shade_streamed.cull_launches = 0
    SM.selection_micro.launches = dict.fromkeys(SM.VARIANTS, 0)
    SM.epilogue_only.launches = SM.epilogue_shared.launches = 0


def launches() -> Counts:
    """Launches of every kernel since :func:`reset_launches`: B1 apart
    from its per-lane-flag form B1l and its culling form B1c (a culled
    regen step counts under both), B4 apart from B4c, B5's tables (B5t, one count
    per build) apart from B5, B6 apart from B6l; the entries B8-B11
    (each also counted under B4 or B4c, which it launches), B10 apart
    from B10c; B12 per variant, B13, B14; the culled loop's records (B4r,
    one count per build); the uniform draws (RNG, rng.cu, one count per
    draw of 1-4 streams); the regen pass B1r apart from its culled instance
    B1rc (one count per pass)."""
    from ..ops import cull as CU
    from ..ops import nearest_shade as NS
    from ..ops import nearest_variants as NV
    from ..ops import regen_pass as RP
    from ..ops import rng as RNG
    from ..ops import scatter_rows as S
    from ..ops import segment_fused as F
    from ..ops import selection_micro as SM
    from ..ops import traverse_walk as TW

    B1 = F.mega_segment
    B10 = NV.nearest_shade_streamed
    return Counts({
        "B8": NV.nearest_shade.launches, "B9": NV.nearest_shade2.launches,
        "B10": B10.launches - B10.cull_launches, "B10c": B10.cull_launches,
        "B11": NV.nearest_shade_culled.launches,
        **{f"B12 {v}": n for v, n in SM.selection_micro.launches.items()},
        "B13": SM.epilogue_only.launches, "B14": SM.epilogue_shared.launches,
        "B1": B1.launches - B1.lane_launches - B1.cull_launches + B1.lane_cull_launches,
        "B1l": B1.lane_launches, "B1c": B1.cull_launches,
        "B2": F.segment_backward.launches, "B3": S.scatter_rows.launches,
        "B4": NS.nearest_shade_full.launches - NS.nearest_shade_full.cull_launches,
        "B4c": NS.nearest_shade_full.cull_launches, "B4r": CU.cull_records.launches,
        "B5": TW.traverse_select.launches, "B5t": TW.walk_tables.launches,
        "B6": F.rows_segment.launches - F.rows_segment.lane_launches,
        "B6l": F.rows_segment.lane_launches, "B7": NS.nearest_triangle.launches,
        "RNG": RNG.stream_uniforms.launches,
        "B1r": RP.regen_pass.launches, "B1rc": RP.regen_pass.cull_launches,
    })


def card(device) -> str:
    """The host's first card as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives it (``"cpu"`` when ``device`` is the
    CPU): every time this package measures on the card is written beside
    it, since a card set below its maximum power runs slower under load."""
    if torch.device(device).type != "cuda":
        return "cpu"
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]
