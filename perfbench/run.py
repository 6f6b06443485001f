"""Run one cell of the benchmark and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. In order: the cell's inputs from the seed, the program's set-up and
warm-up (``setup_s`` runs from process start to the window), the
window, a check that no JAX module was loaded, the device's memory peak,
with ``--trace 1`` the trace's reduction and the pass's work, then the
plain reference's check of what the window produced. The last lines of
standard error name each number compared with its limit; the last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``, then ``checks``. A traced run's window is at most
:data:`TRACED_SECONDS` long, all of it traced. Without a card, or with too few, it
exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
CACHE = CHECKOUT / "build" / "perfbench"
# Every build and kernel cache of the run at a fixed path inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

T_TORCH = time.perf_counter()
FORBIDDEN = ("jax", "jaxlib", "flax", "montecarlopathtracer_tpu")
TRACED_SECONDS = 14.0  # a traced run's window is at most this long: its trace's export grows with it
PORT = "montecarlopathtracer_tpu_torch"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="perfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def applies(metric: dict, cell: str, manifest: dict) -> bool:
    return cell in metric.get("workloads", [w["name"] for w in manifest["workloads"]])


def main(argv=None, *, device="cuda", overrides=None, patch=None) -> int:
    """Run a cell. ``device``, ``overrides`` and ``patch`` serve the
    harness's own tests: the CPU, smaller sizes, and a function called
    with the driver module before set-up (to break the timed path)."""
    from perfbench import harness, tracing

    args = parse(argv)
    if args.seed < 0:
        print("perfbench: the seed must be non-negative", file=sys.stderr)
        return 2
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("perfbench: no CUDA device is available", file=sys.stderr)
            return 2
    try:
        __import__(PORT)
    except ImportError as exc:
        print(f"perfbench: the program {PORT} cannot be imported: {exc}", file=sys.stderr)
        return 3
    t_port = time.perf_counter()
    seconds = min(args.seconds, TRACED_SECONDS) if args.trace else args.seconds
    ctx = harness.load_context(args.workload, args.seed, seconds, bool(args.trace), dev,
                               overrides)
    ctx.marks += [("python and torch imported", T_TORCH), ("the port imported", t_port)]
    chips = int(ctx.cell["chips"])
    if dev.type == "cuda" and torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    drv = harness.driver(ctx)
    if patch is not None:
        patch(drv)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    st = drv.setup(ctx)
    spans = harness.Spans(ctx.trace)
    out = {}
    ctx.sync()
    setup_s = time.perf_counter() - T_PROCESS
    with tracing.profiled(ctx.trace, out):
        win = drv.window(ctx, st, spans)
    t_window = time.perf_counter()
    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX modules loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 4
    mem_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    kept = drv.release(st)
    del st
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run = harness.Run(setup_s=setup_s, window=win, kind=drv.KIND,
                      trace=out.get("summary"),
                      peak=harness.peaks(torch.cuda.get_device_name(dev))
                      if dev.type == "cuda" else None)
    if ctx.trace:
        run.work = drv.work(ctx)
    t_work = time.perf_counter()
    checks = drv.check(ctx, kept)
    t_check = time.perf_counter()
    last = T_PROCESS
    for what, t in ctx.marks:
        print(f"perfbench: set-up {t - last:.3f} s: {what}", file=sys.stderr)
        last = t
    print(f"perfbench: {args.workload} seed {args.seed}: set-up {setup_s:.3f} s, window "
          f"{win.seconds:.3f} s of {len(win.events)}, trace reduced by "
          f"{t_window - setup_s - T_PROCESS - win.seconds:.3f} s, work counted in "
          f"{t_work - t_window:.3f} s, reference {t_check - t_work:.3f} s", file=sys.stderr)

    section = "per_layer" if ctx.trace else "end_to_end"
    metrics, notes = {}, {}
    for m in ctx.manifest[section]:
        if not applies(m, args.workload, ctx.manifest):
            continue
        value = harness.reader(m["name"]).read(run)
        if isinstance(value, tuple):
            value, notes[m["name"]] = value
        if value is None:
            if section == "end_to_end":
                print(f"perfbench: {m['name']} read nothing in {args.workload}", file=sys.stderr)
                return 5
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": chips, "memory_peak_bytes": mem_peak}
    if dev.type == "cuda":
        dev_info["power_limit"] = card_power_limit()
    if run.trace is not None:
        dev_info["busy_s"] = run.trace.busy_s
        dev_info["window_s"] = run.trace.window_s
    correct = all(c.ok for c in checks)
    line = {"correct": correct, "attempted": len(win.events), "failed": 0, "metrics": metrics,
            "device": dev_info}
    if run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    if notes:
        line["notes"] = notes
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX modules loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 4
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def card_power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or ``"unknown"``."""
    import subprocess

    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if proc.returncode == 0 and lines else "unknown"


if __name__ == "__main__":
    raise SystemExit(main())
