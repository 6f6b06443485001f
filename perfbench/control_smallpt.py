"""The readings that ``smallpt.rr_progressive``'s ``film_gap`` limit is set
from, beside its runs' own.

    python3 -m perfbench.control_smallpt --seeds 11,12,13 --passes N

Each control is a film at the run's check pixels over ``N`` passes (as
many as a run folds in) in the program's place, read against the
float32 reference as a run's check reads the program's film:

- ``bf16``, ``bf16_tables``: the reference in bfloat16, and with its
  tables stored in bfloat16 (:mod:`.control`);
- ``biased``: the reference's film times 1.02, a frame biased by 2 %;
- ``mirror_ns1000``: the reference with the mirror's Blinn exponent at
  1,000 (the port's ``cornell-full`` mirror) in place of 1e6, a blurred
  mirror.

Prints one JSON line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
import time

import torch

from . import control, harness
from .drivers import progressive

CELL = "smallpt.rr_progressive"
BIAS = 1.02
MIRROR_NS = 1000.0


def mirror_at(ctx, ns: float):
    """The context with the configuration's mirror at Blinn exponent ``ns``."""
    config = copy.deepcopy(ctx.config)
    config["builder_args"]["materials"]["mirror"]["Ns"] = ns
    return dataclasses.replace(ctx, config=config)


def render_controls(ctx, passes: int) -> dict:
    """Each control's ``film_gap``."""
    out = control.render_control(ctx, passes)
    pix = progressive.check_pixels(ctx)
    want = progressive.reference_pixels(ctx, pix, passes).cpu()
    out["biased"] = harness.relative_l1(want * BIAS, want)
    blurred = progressive.reference_pixels(mirror_at(ctx, MIRROR_NS), pix, passes).cpu()
    out["mirror_ns1000"] = harness.relative_l1(blurred, want)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.control_smallpt")
    p.add_argument("--seeds", required=True)
    p.add_argument("--passes", type=int, required=True,
                   help="passes folded into the film, as a run's window holds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control_smallpt: no CUDA device is available", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.load_context(CELL, seed, 0.0, False, "cuda")
        t0 = time.perf_counter()
        out = render_controls(ctx, args.passes)
        print(json.dumps({"workload": CELL, "seed": seed, "passes": args.passes,
                          "film_gap": out, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
