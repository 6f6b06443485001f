"""Inverse rendering as its users run it: Mitsuba's first gradient-based
optimization job (the tutorial "Gradient-based optimization") on the
published Cornell box, through the port's gradient path.

Set-up renders the target (the configuration's ``target_spp`` samples of
the published scene, by the port's forward path under
``fold_in(key(seed), TARGET)``), builds the port's loss (the mean
squared error of a ``spp_per_pass``-sample render against the target)
and its projected Adam step over one material's row of one field, and
runs :data:`WARM_STEPS` steps (the kernels load, or build in a new
checkout). The window runs jobs of ``job_steps`` steps back to back,
each from the start value with fresh Adam state, window step ``g`` under
``fold_in(key(seed), g)``, until the window has closed and at least one
job is whole. An event is a step: from its dispatch to its loss, the
row and Adam's moments of the row on the host (10 floats, the one
wait of a step).

The check (:func:`check`), against the plain reference
(``reference/inverse.py``):

- ``target_gap``: the target at pixels drawn from the seed against the
  reference's mean of the same samples;
- ``loss_gap``, ``grad_gap``, ``update_gap``: for window steps drawn
  from the seed among the first ``check_first`` of each job (later in a
  job the gradient is mostly sampling noise, and one sample that the
  card and the reference trace along different paths moves it by a
  large share), the reference recomputes the step from the state the
  run kept before it (the row and the moments): the loss, the row's
  gradient (the run's own, from its moments before and after) and the
  row's update;
- ``param_gap``: the last whole job's final row against the published
  value.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from .. import counts_grad
from ..harness import Check, Context, Spans, Window, relative_l1
from ..reference import inverse as RI
from ..reference import threefry as TF
from ..reference import tracer as R
from . import progressive

KIND = "progressive"  # the end-to-end readers' kind: an event a step
TARGET = 0xFFFFFFFF  # the target's key: fold_in(key(seed), TARGET)
WARM = 0xFFFFFFFE  # the warm-up steps' key
WARM_STEPS = 2
READBACK = 10  # loss, the row, its first and second moments


@dataclasses.dataclass
class State:
    step: object  # the port's projected Adam step
    start: dict  # the parameters at a job's start
    target: torch.Tensor  # f32[H, W, 3] on the device
    host: torch.Tensor  # f32[READBACK] on the host (pinned on a card)
    params: dict = None
    adam: object = None  # the step's state; None at a job's start
    log: list = dataclasses.field(default_factory=list)  # [READBACK] a window step


def material(ctx: Context) -> int:
    """The job's material's row in the scene's tables (the builder's
    order, after the unnamed material 0)."""
    return 1 + list(ctx.config["builder_args"]["materials"]).index(ctx.config["material"])


def published(ctx: Context) -> np.ndarray:
    m = ctx.config["builder_args"]["materials"][ctx.config["material"]]
    return np.asarray(m[ctx.config["field"]], np.float64)


def field(ctx: Context) -> str:
    """The port's name of the job's field."""
    return "mat_" + ctx.config["field"].lower()


def adam_options(ctx: Context) -> dict:
    c = ctx.config
    return dict(lr=float(c["lr"]), betas=tuple(c["betas"]), eps=float(c["eps"]),
                bounds=tuple(c["bounds"]))


def setup(ctx: Context) -> State:
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key

    make_step = G.make_adam_step  # a program without it fails here, before any work
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
        target = G.render_image({}, scene, camera, fold_in(base, TARGET), width=W, height=H,
                                spp=int(c["target_spp"]), config=config)
    ctx.mark(f"the target: {c['target_spp']} spp of the published scene")
    loss_fn = G.make_loss_fn(scene, camera, target, width=W, height=H,
                             spp=int(tr["spp_per_pass"]), config=config)
    step = make_step(loss_fn, rows=[material(ctx)], **adam_options(ctx))
    f = field(ctx)
    start = getattr(scene, f).clone()
    start[material(ctx)] = torch.tensor(c["start"], dtype=torch.float32)
    host = torch.empty(READBACK, pin_memory=dev.type == "cuda")
    st = State(step=step, start={f: start}, target=target, host=host)
    for _ in range(WARM_STEPS):
        _step(ctx, st, Spans(False), fold_in(base, WARM))
    st.log.clear()
    ctx.mark(f"{WARM_STEPS} warm-up steps (the kernels loaded, or built in a new checkout)")
    return st


def _step(ctx: Context, st: State, spans: Spans, key):
    """One step and its readback; returns when its dispatch returned."""
    if st.adam is None:
        st.params = st.start
    f, row = field(ctx), material(ctx)
    with spans("dispatch"):
        st.params, loss, st.adam = st.step(st.params, key, st.adam)
    t_enq = time.perf_counter()
    with spans("readback"):
        got = torch.cat([loss.reshape(1), st.params[f][row], st.adam.m[f][0], st.adam.v[f][0]])
        st.host.copy_(got, non_blocking=True)
        if ctx.device.type == "cuda":
            torch.cuda.current_stream(ctx.device).synchronize()
    st.log.append(st.host.tolist())
    if st.adam.t == int(ctx.config["job_steps"]):
        st.adam = None  # the job is whole: the next step starts another
    return t_enq


def window(ctx: Context, st: State, spans) -> Window:
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key

    base = make_key(ctx.seed32)
    job = int(ctx.config["job_steps"])
    st.adam = None
    events = []
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    with spans("window"):
        while True:
            with spans("pass"):
                t_a = time.perf_counter()
                t_b = _step(ctx, st, spans, fold_in(base, len(events)))
                t_c = time.perf_counter()
            events.append((t_a, t_b, t_c))
            if t_c >= deadline and len(events) >= job:
                break
    return Window(t0=t0, t1=events[-1][2], events=events,
                  samples_per_event=ctx.width * ctx.height * int(ctx.traffic["spp_per_pass"]))


def release(st: State) -> dict:
    """Free the program's state; returns what the check needs of it."""
    kept = {"log": np.asarray(st.log, np.float64), "target": st.target.cpu()}
    st.step = st.params = st.adam = st.start = st.target = None
    return kept


def reference_scene(ctx: Context, dtype=torch.float32):
    """The reference's scene, camera and estimator at the run's size."""
    scene = R.prepare_scene(ctx.scene_arrays(), ctx.device, dtype)
    cam = R.make_camera(ctx.camera(), ctx.width, ctx.height, ctx.device, dtype)
    return scene, cam, progressive.estimator(ctx)


def step_key(ctx: Context, g: int) -> np.ndarray:
    return TF.fold_in(TF.make_key(ctx.seed32), g)


def before(ctx: Context, log: np.ndarray, g: int):
    """The row and moments before window step ``g`` and the step's count
    in its job (from 1)."""
    job = int(ctx.config["job_steps"])
    if g % job == 0:
        return np.asarray(ctx.config["start"], np.float64), np.zeros(3), np.zeros(3), 1
    return log[g - 1, 1:4], log[g - 1, 4:7], log[g - 1, 7:10], g % job + 1


def run_grads(ctx: Context, log: np.ndarray) -> np.ndarray:
    """The run's gradient of the row at every window step, from Adam's
    first moment before and after it: f64[n, 3]."""
    job, b1 = int(ctx.config["job_steps"]), adam_options(ctx)["betas"][0]
    m_before = np.where((np.arange(len(log)) % job == 0)[:, None], 0.0,
                        np.roll(log[:, 4:7], 1, axis=0))
    return (log[:, 4:7] - b1 * m_before) / (1.0 - b1)


def recompute(ctx: Context, log: np.ndarray, g: int, target: torch.Tensor) -> dict:
    """Each relative gap of the reference's step ``g``, from the kept state
    before it, to the run's: {"loss", "grad", "update"}."""
    kd, m, v, t = before(ctx, log, g)
    scene, cam, est = reference_scene(ctx)
    loss, grad = RI.loss_and_grad(scene, cam, est, step_key(ctx, g),
                                  int(ctx.traffic["spp_per_pass"]), target, material(ctx), kd)
    kd_ref, _, _ = RI.adam(kd, m, v, t, grad, **adam_options(ctx))
    pairs = {"loss": ([log[g, 0]], [loss]), "grad": (run_grads(ctx, log)[g], grad),
             "update": (log[g, 1:4] - kd, kd_ref - kd)}
    return {k: relative_l1(torch.as_tensor(np.asarray(a, np.float64)),
                           torch.as_tensor(np.asarray(b, np.float64)))
            for k, (a, b) in pairs.items()}


def target_gap(ctx: Context, target: torch.Tensor) -> float:
    pix = progressive.check_pixels(ctx)
    scene, cam, est = reference_scene(ctx)
    with torch.no_grad():
        want = RI.render(scene, cam, est, torch.as_tensor(pix, device=ctx.device),
                         step_key(ctx, TARGET), int(ctx.config["target_spp"])).cpu()
    got = target.reshape(-1, 3)[torch.as_tensor(pix)].T
    return relative_l1(got, want)


def check_steps(ctx: Context, n: int) -> np.ndarray:
    """``check_steps`` of the window's ``n`` steps drawn from the seed
    among the first ``check_first`` of each job, where the gradient is
    far above what one sample that takes another path moves it by."""
    job, first = int(ctx.config["job_steps"]), int(ctx.traffic["check_first"])
    early = np.flatnonzero(np.arange(n) % job < first)
    return np.sort(ctx.rng(3).choice(early, size=min(int(ctx.traffic["check_steps"]),
                                                     len(early)), replace=False))


def param_gaps(ctx: Context, log: np.ndarray) -> np.ndarray:
    """Each whole job's final row against the published value."""
    job = int(ctx.config["job_steps"])
    ends = log[job - 1::job, 1:4][: len(log) // job]
    want = published(ctx)
    return np.abs(ends - want).sum(axis=1) / np.abs(want).sum()


def check(ctx: Context, kept: dict) -> list:
    log = kept["log"]
    lim = ctx.limits
    out = [Check("target_gap", target_gap(ctx, kept["target"]), float(lim["target_gap"]))]
    worst = {"loss": 0.0, "grad": 0.0, "update": 0.0}
    for g in check_steps(ctx, len(log)):
        got = recompute(ctx, log, int(g), kept["target"])
        print(f"perfbench: step {g}: " + ", ".join(f"{k}_gap {v:.3e}" for k, v in got.items()),
              file=sys.stderr)
        worst = {k: max(worst[k], got[k]) for k in worst}
    out += [Check(f"{k}_gap", v, float(lim[f"{k}_gap"])) for k, v in worst.items()]
    job = int(ctx.config["job_steps"])
    grad = np.abs(run_grads(ctx, log)).sum(axis=1)
    print("perfbench: the run's gradient L1 by step of a job (median over jobs): " + ", ".join(
        f"{t} {np.median(grad[t - 1::job]):.2e}" for t in sorted({1, 2, 3, 5, 10, 25, job})
        if t <= min(job, len(log))), file=sys.stderr)
    jobs = param_gaps(ctx, log)
    print(f"perfbench: {len(jobs)} whole jobs, param_gap median {np.median(jobs):.4f}, "
          f"range {jobs.min():.4f}-{jobs.max():.4f}; the last job's row "
          f"{log[len(jobs) * job - 1, 1:4].tolist()}", file=sys.stderr)
    out.append(Check("param_gap", float(jobs[-1]), float(lim["param_gap"])))
    return out


def work(ctx: Context) -> dict:
    return counts_grad.work(ctx, progressive.estimator(ctx))
