"""Structured per-pass render logging: one JSON object per pass (spp,
seconds, samples/s and whatever the caller adds) to a stream."""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, TextIO


class RenderLog:
    """Emits one JSON object per render batch to a stream (default
    stderr) and keeps simple aggregates."""

    def __init__(self, stream: Optional[TextIO] = None, enabled: bool = True):
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = enabled
        self.t0 = time.perf_counter()
        self.total_samples = 0

    def batch(self, *, spp: int, width: int, height: int, seconds: float, **extra):
        self.total_samples += spp * width * height
        if not self.enabled:
            return
        rec = {
            "t": round(time.perf_counter() - self.t0, 4),
            "spp": spp,
            "batch_s": round(seconds, 4),
            "samples_per_s": round(spp * width * height / max(seconds, 1e-9), 1),
            **extra,
        }
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()
