"""Mitsuba's first gradient-based optimization job as Mitsuba runs it:
the primal image and the adjoint pass under keys of their own
(``mi.render``'s ``seed_grad``), through the port's gradient path.

The job, the window, the readback and the event are
:mod:`.inverse`'s: jobs of ``job_steps`` projected Adam steps back to
back, window step ``g`` under ``fold_in(key(seed), g)``, an event a
step. The step's loss is the port's decorrelated one
(``diff/grad.py::make_loss_fn(..., seed_grad=...)``, the
configuration's ``seed_grad``): the primal renders ``spp_per_pass``
samples under the step's key with no tape and gives the loss; the
adjoint renders as many under the step's key folded with the program's
``GRAD_KEY`` with a tape and gives the gradient. An event's samples are
both renders': 2 × W × H × ``spp_per_pass``, each traced forward once.

The check is :mod:`.inverse`'s, each checked step recomputed by
``reference/inverse_seed_grad.py``: the primal's loss, the decorrelated
gradient of the row and its update. ``param_gap`` is the median over
the window's whole jobs of each job's final row against the published
value: a job that converges ends within Adam's last steps of it (lr
0.05 on a 4-spp gradient), so one job's gap spreads by about its own
size from job to job, and the median of a window's jobs (about 100 in
51 s) reads whether the jobs converge, not how the last one landed.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..harness import Check, Context, Spans, Window, relative_l1
from ..reference import inverse_seed_grad as RS
from . import inverse as D
from . import progressive

KIND = D.KIND
release = D.release
work = D.work  # a call is a segment of either render: both trace the same lanes alike


def setup(ctx: Context) -> D.State:
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key

    seed_grad = ctx.config["seed_grad"]
    if seed_grad not in getattr(G, "SEED_GRAD", ()):
        # A program without the option fails here, before any work.
        raise SystemExit(f"perfbench: the program's make_loss_fn has no seed_grad={seed_grad!r}")
    tr, c = ctx.traffic, ctx.config
    if tr["regen"] or c["loss"] != "mse":
        raise ValueError("the gradient path renders by the segment loop (regen off), loss mse")
    dev = ctx.device
    torch.empty(1, device=dev)
    ctx.mark("the device context")
    scene, camera = progressive.program_scene(ctx)
    scene, camera = scene.to(dev), camera.to(dev)
    config = progressive.trace_config(ctx)
    W, H = ctx.width, ctx.height
    base = make_key(ctx.seed32)
    ctx.mark("the scene and camera")
    with torch.no_grad():
        target = G.render_image({}, scene, camera, fold_in(base, D.TARGET), width=W, height=H,
                                spp=int(c["target_spp"]), config=config)
    ctx.mark(f"the target: {c['target_spp']} spp of the published scene")
    loss_fn = G.make_loss_fn(scene, camera, target, width=W, height=H,
                             spp=int(tr["spp_per_pass"]), config=config, seed_grad=seed_grad)
    step = G.make_adam_step(loss_fn, rows=[D.material(ctx)], **D.adam_options(ctx))
    f = D.field(ctx)
    start = getattr(scene, f).clone()
    start[D.material(ctx)] = torch.tensor(c["start"], dtype=torch.float32)
    host = torch.empty(D.READBACK, pin_memory=dev.type == "cuda")
    st = D.State(step=step, start={f: start}, target=target, host=host)
    for _ in range(D.WARM_STEPS):
        D._step(ctx, st, Spans(False), fold_in(base, D.WARM))
    st.log.clear()
    ctx.mark(f"{D.WARM_STEPS} warm-up steps (the kernels loaded, or built in a new checkout)")
    return st


def window(ctx: Context, st: D.State, spans) -> Window:
    win = D.window(ctx, st, spans)
    return dataclasses.replace(win, samples_per_event=2 * win.samples_per_event)


def recompute(ctx: Context, log: np.ndarray, g: int, target: torch.Tensor) -> dict:
    """Each relative gap of the reference's decorrelated step ``g``, from
    the kept state before it, to the run's: {"loss", "grad", "update"}."""
    kd, m, v, t = D.before(ctx, log, g)
    scene, cam, est = D.reference_scene(ctx)
    loss, grad = RS.loss_and_grad(scene, cam, est, D.step_key(ctx, g),
                                  int(ctx.traffic["spp_per_pass"]), target, D.material(ctx), kd)
    kd_ref, _, _ = RS.adam(kd, m, v, t, grad, **D.adam_options(ctx))
    pairs = {"loss": ([log[g, 0]], [loss]), "grad": (D.run_grads(ctx, log)[g], grad),
             "update": (log[g, 1:4] - kd, kd_ref - kd)}
    return {k: relative_l1(torch.as_tensor(np.asarray(a, np.float64)),
                           torch.as_tensor(np.asarray(b, np.float64)))
            for k, (a, b) in pairs.items()}


def check(ctx: Context, kept: dict) -> list:
    log = kept["log"]
    lim = ctx.limits
    out = [Check("target_gap", D.target_gap(ctx, kept["target"]), float(lim["target_gap"]))]
    worst = {"loss": 0.0, "grad": 0.0, "update": 0.0}
    for g in D.check_steps(ctx, len(log)):
        got = recompute(ctx, log, int(g), kept["target"])
        print(f"perfbench: step {g}: " + ", ".join(f"{k}_gap {v:.3e}" for k, v in got.items()),
              file=sys.stderr)
        worst = {k: max(worst[k], got[k]) for k in worst}
    out += [Check(f"{k}_gap", v, float(lim[f"{k}_gap"])) for k, v in worst.items()]
    job = int(ctx.config["job_steps"])
    jobs = D.param_gaps(ctx, log)
    rows = log[job - 1::job, 1:4][: len(jobs)]
    print(f"perfbench: {len(jobs)} whole jobs, param_gap median {np.median(jobs):.4f}, "
          f"90th percentile {np.percentile(jobs, 90):.4f}, range {jobs.min():.4f}-"
          f"{jobs.max():.4f}; final rows: median {np.median(rows, axis=0).tolist()}",
          file=sys.stderr)
    out.append(Check("param_gap", float(np.median(jobs)), float(lim["param_gap"])))
    return out

