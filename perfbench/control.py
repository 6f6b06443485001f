"""The readings that a cell's limits are set from, beside its runs' own.

    python3 -m perfbench.control --workload <cell> --seeds 11,12,13 --passes N

The control is the plain reference put in the program's place, in
bfloat16, the precision below the configurations' float32, two ways:
``bf16``, every number of the reference in bfloat16, and
``bf16_tables``, the triangles' transforms and normals stored in
bfloat16 and the arithmetic in float32 (the lower precision a later
change would take to halve the table's bytes). Each reads the film at
the run's check pixels over ``N`` passes (as many as a run folds in)
against the float32 reference. Prints one JSON line a seed. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness
from .drivers import progressive

CONTROLS = {"bf16": {"dtype": torch.bfloat16},
            "bf16_tables": {"dtype": torch.float32, "tables": torch.bfloat16}}


def render_control(ctx, passes: int) -> dict:
    """Each control's ``film_gap``."""
    pix = progressive.check_pixels(ctx)
    want = progressive.reference_pixels(ctx, pix, passes).cpu()
    out = {}
    for name, how in CONTROLS.items():
        got = progressive.reference_pixels(ctx, pix, passes, **how).cpu()
        out[name] = harness.relative_l1(got, want)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--passes", type=int, required=True,
                   help="passes folded into the film, as a run's window holds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device is available", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.load_context(args.workload, seed, 0.0, False, "cuda")
        t0 = time.perf_counter()
        out = render_control(ctx, args.passes)
        print(json.dumps({"workload": args.workload, "seed": seed, "film_gap": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
