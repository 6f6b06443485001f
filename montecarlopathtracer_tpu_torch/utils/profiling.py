"""The port's tracing and profiling, the counterpart of
``montecarlopathtracer_tpu/utils/profiling.py``.

- :func:`span` names a stretch of the host's work on the device trace's
  clock: a ``torch.profiler.record_function`` range ``mcpt.<name>``
  (category ``user_annotation``) while a profiler records, one shared
  null context otherwise. A span given ``args`` carries them in its name
  after a space (``mcpt.pass pass=3 request=1``), since the trace's
  export drops ``record_function``'s own arguments: a reader groups
  spans by the name's first word.
- :func:`recording` keeps the program's counters over the enclosed
  block: the Renderer's passes, the gradient steps (``diff/grad.py``),
  each pass kernel's (B1r, B1rc) counters and grid, the culled table's
  chunks, the launches whose work list was ordered, the spans' host
  time, the launches.
  :func:`traced` gives the same over the newest stretch of passes or
  steps that a profiler recorded, for a tool that only starts
  ``torch.profiler``.
- :func:`trace` profiles the enclosed block with ``torch.profiler``
  (host activity, and the card's kernels when CUDA is available) and
  writes a Chrome trace (``trace.json``, loadable in Perfetto or
  ``chrome://tracing``) and the recorded counters (``counters.json``)
  into a directory. The CLI enables it with ``--profile-dir``.
- :func:`count_launch` adds a launch to the kernel table's count by name
  (:data:`KERNELS`): each kernel wrapper calls it where it launches its
  CUDA kernel, never for its plain version; inside :func:`primal` the
  wrappers of B1 and the draws count a launch under a second name too.
  :func:`reset_launches` and :func:`launches` zero and read the counts;
  :func:`count_replay` adds a CUDA graph's launches at each replay.
- :func:`card` names the card and its power limit, as ``nvidia-smi``
  reports them, for the lines that carry a measurement.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from typing import Optional

import torch

_OFF = contextlib.nullcontext()  # span() while no profiler records


class _Span:
    """A ``record_function`` range that also adds its host time to the
    open records."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str, args: Optional[dict]):
        self.name = name
        label = f"mcpt.{name}"
        if args:
            label += " " + " ".join(f"{k}={v}" for k, v in args.items())
        self.range = torch.profiler.record_function(label)

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        for rec in _records():
            tally = rec.spans.setdefault(self.name, [0, 0.0])
            tally[0] += 1
            tally[1] += seconds
        return self.range.__exit__(*exc)


def span(name: str, args: Optional[dict] = None):
    """The host span ``mcpt.<name>`` (with ``args``, a dict, in its name)
    while a profiler records; else one shared ``contextlib.nullcontext``,
    so a span costs one check of the profiler's state."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, args)


class _Record:
    """What the program kept over a stretch: the Renderer's passes, the
    gradient steps, each pass kernel's work buffer (its counters first, on
    its device until :meth:`close`), the blocks launched, the chunks of
    the culled launches' tables, the launches whose work list was
    ordered, and each span's count and host seconds."""

    def __init__(self):
        self.passes = 0
        self.steps = 0
        self.work = []
        self.grid = 0
        self.chunks = 0
        self.ordered = 0
        self.spans = {}
        self.before = launches()
        self.sums = None

    def close(self) -> dict:
        """The sums (one host sync, the first time; the buffers are
        dropped then)."""
        if self.sums is None:
            from ..ops.regen_pass import STATS, COUNTERS, pass_clocks

            if self.work:
                c = torch.stack([w[:len(STATS)] for w in self.work]).cpu()
            else:
                c = torch.zeros(0, len(STATS), dtype=torch.int64)
            start, spent, end = pass_clocks(c).unbind(-1)
            self.sums = {
                "passes": self.passes,
                "steps": self.steps,
                **{name: int(c[:, i].sum()) for i, name in enumerate(COUNTERS)},
                "kernel_ms": int((end - start).sum()) / 1e6,
                "tail_ms": int(torch.where(spent >= 0, end - spent, 0).sum()) / 1e6,
                "grid": self.grid,
                "chunks": self.chunks,
                "ordered": self.ordered,
                "launches": dict(launches() - self.before),
                "spans": {k: list(v) for k, v in self.spans.items()},
            }
            self.work = []
        return self.sums


_recordings: list = []  # the open recording()s; empty: nothing is kept
_traced: Optional[_Record] = None  # the newest stretch of passes under a profiler
_tracing = False  # whether the last look found a profiler recording


def _records() -> list:
    """The records that keep what happens now: those of the open
    :func:`recording` blocks and, while a profiler records, the traced
    stretch's, which the first look that finds a profiler after one that
    found none starts anew."""
    global _traced, _tracing
    on = torch.autograd._profiler_enabled()
    if on != _tracing:
        _tracing = on
        if on:
            _traced = _Record()
    return _recordings + [_traced] if on else _recordings


def count_pass() -> None:
    """A Renderer pass begins: count it in every open record."""
    for rec in _records():
        rec.passes += 1


def count_step() -> None:
    """A gradient step begins (``diff/grad.py``): count it in every open
    record."""
    for rec in _records():
        rec.steps += 1


def keep(work: torch.Tensor, grid: int, ordered: bool = False, chunks: int = 0) -> None:
    """Keep a pass kernel's work buffer (its counters first,
    ``ops/regen_pass.py`` STATS; a reference, no copy), its grid's blocks,
    the chunks of its culled table (``chunks``; 0 for the whole-table
    instance) and whether its work list ran in an order (``ordered``) in
    every open record."""
    for rec in _records():
        rec.work.append(work)
        rec.grid += grid
        rec.chunks += chunks
        rec.ordered += int(ordered)


@contextlib.contextmanager
def recording():
    """Keep the program's counters over the enclosed block. The dict it
    yields is filled when the block ends (one host sync): ``passes`` (the
    Renderer's), ``steps`` (the gradient steps of ``diff/grad.py``), the
    sum of each pass kernel counter (``ops/regen_pass.py`` COUNTERS),
    ``kernel_ms`` (the kernels' time on the card's clock, first block
    start to last block end) and ``tail_ms`` (the part after the work
    list ran dry; 0 for a launch whose list was never found spent),
    ``grid`` (blocks launched), ``chunks`` (the chunks of the culled
    launches' tables, summed over those launches: B1rc's chunk-passes,
    beside ``vote_chunks``), ``ordered`` (the launches given a
    work-list order: a Renderer's, from its previous pass,
    :class:`..render.regen.LaneHistory`),
    ``launches`` (of the kernels that launched, counted on the host at
    each launch: a gradient step's B1, B2, B3 and RNG among them) and
    ``spans`` (``{name: [count, host seconds]}``, while a profiler
    records)."""
    rec = _Record()
    _recordings.append(rec)
    out = {}
    try:
        yield out
    finally:
        _recordings.remove(rec)
    out.update(rec.close())


def traced() -> Optional[dict]:
    """:func:`recording`'s dict over the newest stretch of passes or steps
    that a profiler recorded, or None before any. The first call ends the
    stretch and reads it (one host sync); its launches count up to that
    call."""
    global _tracing
    if _traced is None:
        return None
    _tracing = False
    return _traced.close()


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the enclosed block into ``<log_dir>/trace.json``, with
    :func:`recording`'s counters in ``<log_dir>/counters.json`` (no-op
    when ``log_dir`` is None or empty)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, recording() as counters:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(counters, f, indent=1)


KERNELS = (
    "B1", "B1l", "B1c", "B2", "B3", "B3s", "B4", "B4c", "B4r", "B5", "B5t", "B6", "B6l", "B7",
    "B8", "B9", "B10", "B10c", "B11", "B12 full", "B12 matmul_only", "B12 matmul_bf16",
    "B13", "B14", "RNG", "B1r", "B1rc", "B1p", "RNGp",
)
"""The names that :func:`count_launch` takes, PERF.md's kernel table's:
B1 apart from its per-lane-flag form B1l and its culling form B1c (a
culled regen step counts under both), and, for a B1 launch of a
decorrelated gradient step's primal render (inside :func:`primal`),
B1p too; B3 and, for a B3 call that
its small-table path served, B3s too, B4 apart from B4c, B5's tables
(B5t, one count per build) apart from B5, B6 apart from B6l; the entries
B8-B11 (each also counted under B4 or B4c, which it launches), B10 apart
from B10c; B12 per variant, B13, B14; the culled loop's records (B4r, one
count per build); the uniform draws (RNG, rng.cu, one count per draw of
1-4 streams; inside :func:`primal`, RNGp too); the regen pass B1r apart
from its culled instance B1rc (one count per pass)."""


class Counts(dict):
    """Launch counts by kernel name; a name that is not in it reads 0, and
    it prints the kernels that launched only. ``a - b`` is what launched
    between two readings, the kernels that launched only."""

    def __missing__(self, name):
        return 0

    def __repr__(self):
        return repr({k: v for k, v in self.items() if v})

    def __sub__(self, before):
        return Counts({k: n - before[k] for k, n in self.items() if n != before[k]})


_launched = Counts.fromkeys(KERNELS, 0)  # launches since reset_launches()
_primal = 0  # the open primal() blocks


def count_launch(name: str, n: int = 1) -> None:
    """Add ``n`` launches of the kernel ``name`` (one of :data:`KERNELS`);
    each kernel wrapper calls it where it launches its CUDA kernel, never
    for its plain version."""
    if name not in _launched:
        raise ValueError(f"no kernel {name!r} in the launch table")
    _launched[name] += n


@contextlib.contextmanager
def primal():
    """Mark the enclosed launches as a primal render's: the render of a
    decorrelated gradient step (``diff/grad.py``) that gives the loss and
    keeps no tape. The wrappers of B1 and of the draws count each launch
    in it under B1p or RNGp beside B1 or RNG."""
    global _primal
    _primal += 1
    try:
        yield
    finally:
        _primal -= 1


def in_primal() -> bool:
    """Whether a :func:`primal` block is open."""
    return _primal > 0


def count_replay(held: dict) -> None:
    """A CUDA graph replays: add the launches it holds (``{name: n}``, as
    :func:`..diff.grad.graphed_loss` counted them at its capture), as
    those launches would have."""
    for name, n in held.items():
        count_launch(name, n)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    _launched.update(dict.fromkeys(KERNELS, 0))


def launches() -> Counts:
    """Launches of every kernel of :data:`KERNELS` since
    :func:`reset_launches`, a copy."""
    return Counts(_launched)


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
