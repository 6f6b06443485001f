"""The readings that ``cornell_box_inverse_seed_grad.adam_seed_grad``'s
limits are set from, beside its sound runs' own.

    python3 -m perfbench.control_seed_grad --seeds 11,12 --seconds 5

Four controls, each put where a sound run would be; each must fail at
least one limit:

- ``one_key``: a run whose adjoint renders under the primal's key
  (``fold_in(key, GRAD_KEY)`` gives ``key`` back), which is the
  correlated cell's step: its jobs end far from the published value
  (``param_gap``);
- ``grad_x1.02``: a run whose gradient is 1.02 times the program's;
- ``half_adjoint``: a run whose adjoint renders half the samples;
- ``bf16``: the plain reference in bfloat16, the precision below the
  configuration's float32, in the program's place: its target at the
  check pixels, and its loss, gradient and update of window step 0
  (from the start value, against a target of the float32 reference's
  own ``spp_per_pass`` samples under the target's key), each against
  the float32 reference's.

The faults are planted in the program's modules and taken out after.
Prints one JSON line a seed. The benchmark's own runs never run this.
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
from .control_inverse import _scaled_grad
from .drivers import inverse as D
from .drivers import progressive
from .reference import inverse as RI
from .reference import inverse_seed_grad as RS

CELL = "cornell_box_inverse_seed_grad.adam_seed_grad"


@contextlib.contextmanager
def _one_key():
    from montecarlopathtracer_tpu_torch.diff import grad as G

    whole = G.fold_in

    def one_key(key, data):
        return key if data == G.GRAD_KEY else whole(key, data)

    G.fold_in = one_key
    try:
        yield
    finally:
        G.fold_in = whole


@contextlib.contextmanager
def _half_adjoint():
    from montecarlopathtracer_tpu_torch.diff import grad as G

    whole = G.render_image

    def half(*args, spp, **kw):
        if torch.is_grad_enabled():  # the adjoint; the primal and the target keep no tape
            spp = max(1, spp // 2)
        return whole(*args, spp=spp, **kw)

    G.render_image = half
    try:
        yield
    finally:
        G.render_image = whole


FAULTS = {"one_key": _one_key, "grad_x1.02": _scaled_grad, "half_adjoint": _half_adjoint}


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
        loss, grad = RS.loss_and_grad(sc, cm, est, D.step_key(ctx, 0), spp, target,
                                      D.material(ctx), kd)
        res[dt] = (np.array([loss]), grad, RS.adam(kd, m, v, t, grad, **opts)[0] - kd)
    for i, name in enumerate(("loss_gap", "grad_gap", "update_gap")):
        out[name] = harness.relative_l1(torch.as_tensor(res[torch.bfloat16][i]),
                                        torch.as_tensor(res[torch.float32][i]))
    return out


def fault_checks(seed: int, seconds: float, fault: str, *, device="cuda", overrides=None) -> dict:
    """A run of the cell with ``fault`` planted: (correct, {check: value})."""
    from . import run

    out, err = io.StringIO(), io.StringIO()
    with FAULTS[fault](), contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", "0"], device=device, overrides=overrides)
    if rc != 0:
        raise RuntimeError(f"the {fault} run failed ({rc}): {err.getvalue()[-2000:]}")
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return line["correct"], {k: c["value"] for k, c in line["checks"].items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.control_seed_grad")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0, help="each fault run's window")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control_seed_grad: no CUDA device is available", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.load_context(CELL, seed, 0.0, False, "cuda")
        t0 = time.perf_counter()
        line = {"workload": CELL, "seed": seed, "bf16": bf16_readings(ctx)}
        for fault in FAULTS:
            correct, checks = fault_checks(seed, args.seconds, fault)
            line[fault] = {"correct": correct, **checks}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
