"""Selection-step microbenchmarks on the card: the twin of the JAX
package's ``tools/kernel_micro.py``.

Times the cost components of one selection step over the same R × T
work (:mod:`..ops.selection_micro`):

  v3_full              contraction + accept chain (B12, ``full``)
  matmul_only_f32out   contraction + a running min (B12, ``matmul_only``)
  matmul_only_bf16out  the same on bf16-rounded p (B12, ``matmul_bf16``)
  epilogue_only        the accept chain on one resident p block reused by
                       every step (B14, the JAX tool's ``epilogue_only``)
  epilogue_resident    the accept chain on the whole p_all f32[6T, R]
                       (B13, defined and never run by the JAX tool;
                       9.06 GB at the defaults, which the H100's 80 GB
                       hold, so R is not cut)

Inputs as the JAX tool draws them: ``numpy.random.default_rng(0)``
N(0, 1) values, ws bf16[48, 6T], then rays bf16[48, R], then the p block
f32[6·tc, 512]; p_all is N(0, 1) from a seeded torch generator on the
device (2.3e9 values). Prints one JSON line per variant with
``variant``, ``t_chunk``, ``ms`` (median of ``--iters`` calls after one
warm-up, a CUDA event pair around each, as :mod:`.kernel_bench` times)
and ``gel_s`` (1e9 ray-triangle elements per second). The JAX tool's
ray-tile sweep measures a TPU grid-step cost and has no counterpart.

Usage::

    python -m montecarlopathtracer_tpu_torch.tools.kernel_micro [--rays N] [--tris T]
        [--iters K] [--skip-resident] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import selection_micro as SM
from .kernel_bench import timed

RAY_TILE = 512  # the JAX tool's ray tile: the shared p block's width


def inputs(R: int, T: int, t_chunk: int, device):
    """(ws bf16[48, 6T], rays bf16[48, R], p_blk f32[6·tc, 512]) from
    ``default_rng(0)`` in the JAX tool's order."""
    rng = np.random.default_rng(0)
    ws = torch.as_tensor(rng.normal(size=(SM.K, 6 * T)), dtype=torch.float32)
    rays = torch.as_tensor(rng.normal(size=(SM.K, R)), dtype=torch.float32)
    p_blk = torch.as_tensor(rng.normal(size=(6 * t_chunk, RAY_TILE)), dtype=torch.float32)
    return (ws.to(torch.bfloat16).to(device), rays.to(torch.bfloat16).to(device),
            p_blk.to(device))


def resident_p(R: int, T: int, device, seed: int = 1):
    """p_all f32[6T, R] of N(0, 1) values from a seeded generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(6 * T, R, device=device, generator=g)


def run(rays: int = 491_520, tris: int = 768, iters: int = 10, skip_resident: bool = False,
        device="cuda", keep=None):
    """Time every variant; returns the rows that :func:`main` prints as
    JSON lines. Given a dict ``keep``, also stores there what a caller
    needs to check the results: the inputs (``ws``, ``rays``, ``p_blk``,
    ``p_all``, ``t_chunk``) and ``out``, each variant's i32[R] from its
    last timed call."""
    device = torch.device(device)
    R, T = rays, tris
    tc = 256 if T % 256 == 0 else 128
    ws, x, p_blk = inputs(R, T, tc, device)
    calls = {
        "v3_full": lambda: SM.selection_micro(ws, x, tc, "full"),
        "matmul_only_f32out": lambda: SM.selection_micro(ws, x, tc, "matmul_only"),
        "matmul_only_bf16out": lambda: SM.selection_micro(ws, x, tc, "matmul_bf16"),
        "epilogue_only": lambda: SM.epilogue_shared(p_blk, T, R),
    }
    rows, outs = [], {}

    def report(name, fn):
        dt, out = timed(fn, iters, device)
        if keep is not None:
            outs[name] = out
        rows.append({"variant": name, "t_chunk": tc, "ms": dt * 1e3,
                     "gel_s": R * T / dt / 1e9, "device": device.type})

    for name, fn in calls.items():
        report(name, fn)
    p_all = None
    if not skip_resident:
        p_all = resident_p(R, T, device)
        report("epilogue_resident", lambda: SM.epilogue_only(p_all, tc))
    if keep is not None:
        keep.update(ws=ws, rays=x, p_blk=p_blk, p_all=p_all, t_chunk=tc, out=outs)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=491_520)  # 960 tiles of 512
    ap.add_argument("--tris", type=int, default=768)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--skip-resident", action="store_true",
                    help="skip B13 (its p_all is 6 x tris x rays x 4 bytes)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions (small sizes only)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("error: no CUDA device is available (--device cpu runs the plain versions)",
              file=sys.stderr)
        return 2
    if args.iters < 1:
        print(f"error: --iters must be at least 1, got {args.iters}", file=sys.stderr)
        return 2
    if args.tris % 128:
        print(f"error: --tris must be a multiple of 128, got {args.tris}", file=sys.stderr)
        return 2
    if args.device.startswith("cuda"):
        print(f"device: {torch.cuda.get_device_name(0)}", file=sys.stderr)
    for row in run(args.rays, args.tris, args.iters, args.skip_resident, args.device):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
