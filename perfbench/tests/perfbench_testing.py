"""Helpers of the harness's own tests: the checkout on ``sys.path``, a
CPU run of a cell at a small size, and the fixture that skips a test
that needs the card."""

from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {"width": 24, "height": 18, "check_pixels": 48, "reach_pixels": 48}
SEED = 2**31 + 977


def run_cell(cell: str, *, seed: int = SEED, seconds: float = 0.3, trace: int = 0,
             patch=None, overrides=None):
    """Run ``cell`` on the CPU at a small size; (exit code, result line or
    None, standard error)."""
    from perfbench import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu",
                      overrides={**SMALL, **(overrides or {})}, patch=patch)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
