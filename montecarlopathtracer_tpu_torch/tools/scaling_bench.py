"""Scaling harness of the sharded pass: the twin of the repository's
``tools/scaling_bench.py``.

Weak scaling, as the original: each rank owns a fixed 64-row × 512-wide
band at 2 spp (fixed depth 5), the mesh grows along the rays axis, so the
frame is 64·n rows high, and the film's spp sum and the banded output run
at every size. Each size runs on its own world of ranks
(:func:`..parallel.launch.run_ranks`); a rank times ``REPS`` passes
after one warm-up, ending each in a synchronise on the card, and the
size's time is the slowest rank's.

Two regimes, recorded in the JSON's ``regime``:

- on the card (``--device cuda``, the default), the sizes go up to the
  cards of the host, one rank each under NCCL: with one card that is
  world size 1 only, which measures the sharded program's overhead and
  not scaling;
- on the CPU (``--device cpu``, gloo ranks, one torch thread each), every
  rank shares the host's cores, so the times measure the sharded
  program's overhead only, never scaling; ``efficiency_vs_shared_core_floor``
  sets them against ``t1·n / min(n, cores)``.

The overhead of the sharded program alone is measured first, on one
process with no process group: the same band rendered by
:func:`..render.integrator.render_rows` directly and through a 1×1
:func:`..parallel.sharded.sharded_sample_pass`.

Writes the JSON to ``--out`` (default ``out/scaling_torch.json`` under the
working directory), never to the repository's ``SCALING.json``::

    python -m montecarlopathtracer_tpu_torch.tools.scaling_bench [--device cpu]
        [--max-ranks N] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..parallel.launch import run_ranks

ROWS_PER_RANK = 64
WIDTH = 512
SPP = 2
DEPTH = 5
REPS = 10


def _timed(fn, device, reps):
    """Seconds per call of ``fn()`` over ``reps`` calls, after one."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / reps


def _setup(mesh, rows, width, spp, depth):
    from ..models import cornell
    from ..render.integrator import TraceConfig

    height = rows * mesh.n_rays
    scene, camera = cornell.cornell_box(width=width, height=height, device=mesh.device)
    return scene, camera, height, TraceConfig(mode="fixed", max_depth=depth)


def overhead(device, rows, width, spp, depth, reps) -> dict:
    """The same band with and without the sharded pass around it, in this
    process (no process group)."""
    from ..ops.rng import fold_in, make_key
    from ..parallel import make_mesh, sharded_sample_pass
    from ..render.integrator import render_rows, scene_tables

    mesh = make_mesh(1, 1, device=device)
    scene, camera, height, config = _setup(mesh, rows, width, spp, depth)
    key = make_key(0)

    @torch.no_grad()
    def plain():
        tables = scene_tables(scene, config)
        return sum(render_rows(scene, camera, fold_in(key, i), width, height, 0, rows, config,
                               tables) for i in range(spp)) / spp

    f = sharded_sample_pass(mesh, width=width, height=height, spp=spp, config=config)
    t_plain = _timed(plain, mesh.device, reps)
    t_sharded = _timed(torch.no_grad()(lambda: f(scene, camera, key)), mesh.device, reps)
    return {"unsharded_seconds": t_plain, "sharded_1rank_seconds": t_sharded,
            "spmd_overhead_pct": 100.0 * (t_sharded / t_plain - 1.0)}


def _rank_pass(rows, width, spp, depth, reps, device) -> float:
    """One rank of a size: seconds per sharded pass."""
    from ..ops.rng import make_key
    from ..parallel import make_mesh, sharded_sample_pass

    mesh = make_mesh(device=device)  # every rank on the rays axis
    scene, camera, height, config = _setup(mesh, rows, width, spp, depth)
    f = sharded_sample_pass(mesh, width=width, height=height, spp=spp, config=config)
    return _timed(torch.no_grad()(lambda: f(scene, camera, make_key(0))), mesh.device, reps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--max-ranks", type=int, default=None,
                    help="largest world (default: the cards, or 8 on the CPU)")
    ap.add_argument("--out", default=os.path.join("out", "scaling_torch.json"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("scaling_bench: no CUDA device is available; pass --device cpu")
        cap = torch.cuda.device_count()
        where = f"{cap} x {torch.cuda.get_device_name(0)}"
        regime = "weak-scaling" if cap > 1 else "one-card-overhead"
    else:
        cap = 8
        where = "cpu"
        regime = "cpu-ranks-overhead"
    max_ranks = min(args.max_ranks or cap, cap)
    cores = len(os.sched_getaffinity(0))
    shape = (ROWS_PER_RANK, WIDTH, SPP, DEPTH, REPS)
    print(f"device={where} max_ranks={max_ranks} cores={cores} regime={regime}",
          file=sys.stderr)

    over = overhead(str(device), *shape)
    print(json.dumps({"overhead": over}), flush=True)
    rows, t1 = [], None
    for n in (k for k in (1, 2, 4, 8) if k <= max_ranks):
        dt = max(run_ranks(_rank_pass, n, (*shape, str(device)), device=str(device)))
        t1 = t1 or dt
        height = ROWS_PER_RANK * n
        row = {"ranks": n, "height": height, "seconds_per_pass": dt,
               "total_msamples_s": WIDTH * height * SPP / dt / 1e6,
               "weak_scaling_efficiency": t1 / dt,
               "efficiency_vs_shared_core_floor": t1 * n / min(n, cores) / dt}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {
        "device": where, "regime": regime, "host_cores": cores,
        "note": ("weak_scaling_efficiency = t(1)/t(n) at constant per-rank work is "
                 "scaling only with one card per rank on several cards; on the CPU the "
                 "ranks share host_cores cores and the numbers measure the sharded "
                 "program's overhead only (spmd_overhead_pct and "
                 "efficiency_vs_shared_core_floor = t1*n/min(n,cores) / t(n)); on one "
                 "card only world size 1 runs"),
        "spmd_overhead": over, "rows_per_rank": ROWS_PER_RANK, "width": WIDTH, "spp": SPP,
        "depth": DEPTH, "reps": REPS, "results": rows,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out} ({len(rows)} sizes)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
