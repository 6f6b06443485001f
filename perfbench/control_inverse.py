"""The readings that ``cornell_box_inverse.adam_red_wall``'s limits are
set from, beside its sound runs' own.

    python3 -m perfbench.control_inverse --workload cornell_box_inverse.adam_red_wall \
        --seeds 11,12,13 --seconds 5

Four controls, each put where a sound run would be; each must fail at
least one limit:

- ``bf16``: the plain reference in bfloat16, the precision below the
  configuration's float32, in the program's place: its target at the
  check pixels, and its loss, gradient and update of window step 0 (from
  the start value, against a target of the float32 reference's own
  ``spp_per_pass`` samples under the target's key), each against the
  float32 reference's;
- ``half_samples``: a run whose steps render half the samples;
- ``grad_x1.02``: a run whose gradient is 1.02 times the program's;
- ``b3_dropped``: a run that drops the row scatter (B3) of segment 2 of
  each sample batch (its adjoint rows left zero; the backward visits a
  batch's segments last first).

The faults are planted in the program's modules by :func:`planted` and
taken out after. Prints one JSON line a seed. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time

import numpy as np
import torch

from . import harness
from .drivers import inverse as D
from .drivers import progressive
from .reference import inverse as RI

CELL = "cornell_box_inverse.adam_red_wall"


@contextlib.contextmanager
def _half_samples():
    from montecarlopathtracer_tpu_torch.diff import grad as G

    whole = G.make_loss_fn

    def half(*args, spp, **kw):
        return whole(*args, spp=max(1, spp // 2), **kw)

    G.make_loss_fn = half
    try:
        yield
    finally:
        G.make_loss_fn = whole


@contextlib.contextmanager
def _scaled_grad(factor=1.02):
    from montecarlopathtracer_tpu_torch.diff import grad as G

    whole = G.value_and_grad

    def scaled(loss_fn, params, key):
        loss, grads = whole(loss_fn, params, key)
        return loss, {k: g * factor for k, g in grads.items()}

    G.value_and_grad = scaled
    try:
        yield
    finally:
        G.value_and_grad = whole


@contextlib.contextmanager
def _b3_dropped(segment=2, segments=8):
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F

    whole = F.scatter_rows
    calls = [0]

    def dropping(idx, dvals, T):
        out = whole(idx, dvals, T)
        calls[0] += 1
        return out.zero_() if (segments - calls[0] % segments) % segments == segment else out

    F.scatter_rows = dropping
    try:
        yield
    finally:
        F.scatter_rows = whole


FAULTS = {"half_samples": _half_samples, "grad_x1.02": _scaled_grad,
          "b3_dropped": _b3_dropped}


def planted(name: str):
    """A context that plants fault ``name`` in the program."""
    return FAULTS[name]()


def bf16_readings(ctx) -> dict:
    """The ``bf16`` control's gaps against the float32 reference."""
    scene, cam, est = D.reference_scene(ctx)
    scene16, cam16, _ = D.reference_scene(ctx, torch.bfloat16)
    spp, target_spp = int(ctx.traffic["spp_per_pass"]), int(ctx.config["target_spp"])
    pix = torch.as_tensor(progressive.check_pixels(ctx), device=ctx.device)
    key = D.step_key(ctx, D.TARGET)
    with torch.no_grad():
        want = RI.render(scene, cam, est, pix, key, target_spp).cpu()
        low = RI.render(scene16, cam16, est, pix, key, target_spp).cpu()
        img = RI.render(scene, cam, est, torch.arange(ctx.width * ctx.height, device=ctx.device),
                        key, spp)
    out = {"target_gap": harness.relative_l1(low, want)}
    target = img.T.reshape(ctx.height, ctx.width, 3).float().cpu()
    kd, m, v, t = D.before(ctx, np.zeros((1, D.READBACK)), 0)
    opts = D.adam_options(ctx)
    res = {}
    for dt, (sc, cm) in ((torch.float32, (scene, cam)), (torch.bfloat16, (scene16, cam16))):
        loss, grad = RI.loss_and_grad(sc, cm, est, D.step_key(ctx, 0), spp, target,
                                      D.material(ctx), kd)
        res[dt] = (np.array([loss]), grad, RI.adam(kd, m, v, t, grad, **opts)[0] - kd)
    for i, name in enumerate(("loss_gap", "grad_gap", "update_gap")):
        out[name] = harness.relative_l1(torch.as_tensor(res[torch.bfloat16][i]),
                                        torch.as_tensor(res[torch.float32][i]))
    return out


def fault_checks(seed: int, seconds: float, fault: str, *, device="cuda", overrides=None) -> dict:
    """A run of the cell with ``fault`` planted: (correct, {check: value})."""
    from . import run

    out, err = io.StringIO(), io.StringIO()
    with planted(fault), contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", "0"], device=device, overrides=overrides)
    if rc != 0:
        raise RuntimeError(f"the {fault} run failed ({rc}): {err.getvalue()[-2000:]}")
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return line["correct"], {k: c["value"] for k, c in line["checks"].items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.control_inverse")
    p.add_argument("--workload", default=CELL, choices=[CELL])
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0, help="each fault run's window")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control_inverse: no CUDA device is available", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.load_context(args.workload, seed, 0.0, False, "cuda")
        t0 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, "bf16": bf16_readings(ctx)}
        for fault in FAULTS:
            correct, checks = fault_checks(seed, args.seconds, fault)
            line[fault] = {"correct": correct, **checks}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
