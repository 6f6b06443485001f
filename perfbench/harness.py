"""What every run shares: the cell's files found by name, the seed's
keys, the spans, the record of a window and the checks that decide
``correct``.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``,
its scene built by ``scenes/<builder>.py``) and a traffic mix
(``traffic/<name>.json``, whose ``driver`` names ``drivers/<driver>.py``).
Each metric is read by ``metrics/<metric name>.py``; each cell's limits
are in ``limits/<cell>.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
M32 = 0xFFFFFFFF


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Context:
    """One run's inputs: the cell, its configuration and traffic, the seed,
    the window's length, whether it is traced, and the device."""

    manifest: dict
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    marks: list = dataclasses.field(default_factory=list)  # [(what, perf_counter)] of set-up

    def mark(self, what: str) -> None:
        """Note the end of a phase of set-up (``setup_s``'s breakdown)."""
        self.sync()
        self.marks.append((what, time.perf_counter()))

    @property
    def seed32(self) -> int:
        """The seed as a 32-bit key seed: its two halves xor-ed."""
        return (self.seed ^ (self.seed >> 32)) & M32

    @property
    def width(self) -> int:
        return int(self.traffic["width"])

    @property
    def height(self) -> int:
        return int(self.traffic["height"])

    def camera(self) -> dict:
        """The configuration's camera at the traffic's resolution: eye,
        forward, up, jitter and the horizontal field ``fov_x_deg``, from
        the focal length and the film's height, its width at the
        resolution's aspect."""
        c = dict(self.config["camera"])
        tan_y = 0.5 * c.pop("film_height") / c.pop("focal_length")
        c["fov_x_deg"] = math.degrees(2.0 * math.atan(tan_y * self.width / self.height))
        return c

    def rng(self, purpose: int) -> np.random.Generator:
        """A numpy generator of the seed, one stream per purpose."""
        return np.random.default_rng([self.seed & M32, self.seed >> 32, purpose])

    def scene_arrays(self):
        builder = importlib.import_module(f"perfbench.scenes.{self.config['builder']}")
        return builder.build(**self.config.get("builder_args", {}))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def load_context(name: str, seed: int, seconds: float, trace: bool, device,
                 overrides: Optional[dict] = None) -> Context:
    """The context of cell ``name`` from ``BENCHMARK.json`` and the files it
    names. ``overrides`` replaces configuration and traffic keys (the
    harness's own tests run cells at a size the CPU holds)."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json "
                         f"(there are {', '.join(sorted(cells))})")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    for k, v in (overrides or {}).items():
        (config if k in config else traffic)[k] = v
    return Context(manifest=manifest, cell=cell, config=config, traffic=traffic, limits=limits,
                   seed=seed, seconds=seconds, trace=trace, device=torch.device(device))


def driver(ctx: Context):
    return importlib.import_module(f"perfbench.drivers.{ctx.traffic['driver']}")


def reader(metric: str):
    """The reader module of a metric, ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spans:
    """The benchmark's spans: ``torch.profiler.record_function`` ranges
    named ``perfbench.<name>`` in a traced run, nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"perfbench.{name}")


@dataclasses.dataclass
class Window:
    """The host clock of a window: its start and end (``perf_counter``
    seconds) and, per pass or iteration, when it was dispatched, when the
    dispatch returned and when its result was on the host (None where the
    loop does not wait for each)."""

    t0: float
    t1: float
    events: list  # [(t_dispatch, t_enqueued, t_done or None)]
    samples_per_event: int

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Check:
    """A number compared, with its limit: ``correct`` needs value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What the readers see of a run."""

    setup_s: float
    window: Window
    kind: str  # the driver's kind
    trace: Optional[object] = None  # tracing.Summary of a traced run
    work: Optional[dict] = None  # counts.work of a traced run
    peak: Optional[dict] = None  # the card's row of peaks.json


def peaks(kind: str) -> Optional[dict]:
    """The published peaks of a card by its name, or None."""
    table = load_json(HERE / "peaks.json")
    for row in table["cards"]:
        if row["match"] in kind:
            return row
    return None


def relative_l1(got: torch.Tensor, want: torch.Tensor) -> float:
    """sum |got - want| / sum |want|, in float64."""
    got, want = got.double(), want.double()
    den = want.abs().sum()
    return float((got - want).abs().sum() / den) if den > 0 else float((got - want).abs().sum())
