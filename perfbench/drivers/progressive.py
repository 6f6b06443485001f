"""Progressive rendering as a user watches it: ``Renderer.render(1)`` a
pass, then the film's running mean copied to the host, over and over
until the window closes (a closed loop of one client).

Set-up builds the Renderer over the benchmark's scene arrays and camera
and renders one pass (the warm-up: kernels load, tables are built). The
check compares the film, every pass folded in, at pixels drawn from the
seed with the plain reference's mean over the same samples.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from .. import counts
from ..harness import Check, Context, Spans, Window, relative_l1
from ..reference import threefry as TF
from ..reference import tracer as R

KIND = "progressive"


@dataclasses.dataclass
class State:
    renderer: object
    host: torch.Tensor  # the film's colour on the host, f32[H, W, 3]
    passes: int = 0  # passes folded into the film


def estimator(ctx: Context) -> R.Estimator:
    tr = ctx.traffic
    return R.Estimator(mode=tr["mode"], max_depth=int(tr["max_depth"]),
                       rr_depth=int(tr["rr_depth"]), illum=float(tr["illum"]))


def program_scene(ctx: Context):
    """The port's scene and camera over the benchmark's arrays."""
    from montecarlopathtracer_tpu_torch.scene.camera import Camera
    from montecarlopathtracer_tpu_torch.scene.scene import scene_pack_from_arrays

    a = ctx.scene_arrays()
    mats = {"Ka": a.mat_ka, "Kd": a.mat_kd, "Ks": a.mat_ks, "Ns": a.mat_ns, "Tr": a.mat_tr,
            "Ni": a.mat_ni}
    scene = scene_pack_from_arrays(a.vertices, a.normals, a.tri_v, a.tri_n, a.tri_mat, mats)
    c = ctx.camera()
    camera = Camera.look(c["eye"], c["forward"], c["up"], width=ctx.width, height=ctx.height,
                         fov_x_deg=c["fov_x_deg"], jitter=c["jitter"])
    return scene, camera


def trace_config(ctx: Context):
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig

    tr = ctx.traffic
    return TraceConfig(mode=tr["mode"], max_depth=int(tr["max_depth"]),
                       rr_depth=int(tr["rr_depth"]), illum=float(tr["illum"]),
                       intersector=tr["intersector"], chunk_cull=bool(tr["chunk_cull"]),
                       ray_chunk=0)


def setup(ctx: Context) -> State:
    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings

    if not ctx.traffic["regen"]:
        raise ValueError("this driver's reference draws as the regen pass does: regen must be on")
    torch.empty(1, device=ctx.device)
    ctx.mark("the device context")
    scene, camera = program_scene(ctx)
    settings = RenderSettings(width=ctx.width, height=ctx.height,
                              spp_per_pass=int(ctx.traffic["spp_per_pass"]), seed=ctx.seed32,
                              regen=True)
    r = Renderer(scene, camera, trace_config(ctx), settings, device=ctx.device)
    host = torch.empty(ctx.height, ctx.width, 3, pin_memory=ctx.device.type == "cuda")
    st = State(renderer=r, host=host)
    ctx.mark("the scene, the Renderer and its tables")
    _pass(ctx, st, Spans(False))
    ctx.mark("the warm-up pass (the kernels loaded, or built in a new checkout)")
    return st


def _pass(ctx: Context, st: State, spans: Spans):
    with spans("dispatch"):
        st.renderer.render(1)
    t_enq = time.perf_counter()
    with spans("readback"):
        st.host.copy_(st.renderer.film.color, non_blocking=True)
        if ctx.device.type == "cuda":
            torch.cuda.current_stream(ctx.device).synchronize()
    st.passes += 1
    return t_enq


def window(ctx: Context, st: State, spans) -> Window:
    events = []
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    with spans("window"):
        while True:
            with spans("pass"):
                t_a = time.perf_counter()
                t_b = _pass(ctx, st, spans)
                t_c = time.perf_counter()
            events.append((t_a, t_b, t_c))
            if t_c >= deadline:
                break
    tr = ctx.traffic
    return Window(t0=t0, t1=events[-1][2], events=events,
                  samples_per_event=ctx.width * ctx.height * int(tr["spp_per_pass"]))


def release(st: State) -> dict:
    """Free the program's state; returns what the check needs of it."""
    kept = {"film": st.host.clone(), "passes": st.passes}
    st.renderer = None
    return kept


def reference_pixels(ctx: Context, pix: np.ndarray, passes: int, dtype=torch.float32,
                     tables=None):
    """The reference's film at pixels ``pix``: the mean, over the passes'
    samples, f64[len(pix), 3]; a lane a pixel and pass, its samples back
    to back under the pass's key, as the regen pass draws them. ``dtype``
    and ``tables``: the controls' lower precisions
    (:func:`.reference.tracer.prepare_scene`)."""
    spp = int(ctx.traffic["spp_per_pass"])
    dev = ctx.device
    est = estimator(ctx)
    scene = R.prepare_scene(ctx.scene_arrays(), dev, dtype, tables)
    cam = R.make_camera(ctx.camera(), ctx.width, ctx.height, dev, dtype)
    keys = TF.fold_in(TF.make_key(ctx.seed32)[None], np.arange(passes))
    keytab = torch.as_tensor(R.key_tables(keys, est.max_steps(spp)).astype(np.int64), device=dev)
    pixels = torch.as_tensor(np.tile(pix, passes), device=dev)
    group = torch.as_tensor(np.repeat(np.arange(passes), len(pix)), device=dev)
    total = R.run_lanes(scene, cam, est, pixels, keytab, group, spp, block=R.BLOCK)
    return (total.reshape(3, passes, len(pix)).sum(dim=1) / (passes * spp)).T


def check_pixels(ctx: Context) -> np.ndarray:
    n = min(int(ctx.traffic["check_pixels"]), ctx.width * ctx.height)
    return np.sort(ctx.rng(1).choice(ctx.width * ctx.height, size=n, replace=False))


def film_values(kept: dict, pix: np.ndarray, width: int) -> torch.Tensor:
    film = kept["film"]
    return film[torch.as_tensor(pix // width), torch.as_tensor(pix % width)]


def check(ctx: Context, kept: dict) -> list:
    pix = check_pixels(ctx)
    got = film_values(kept, pix, ctx.width)
    want = reference_pixels(ctx, pix, kept["passes"]).cpu()
    # Where the gap sits: a few pixels far off (paths that diverged) or all a little.
    per_px = ((got.double() - want).abs().sum(1) / want.abs().sum(1).clamp_min(1e-12))
    print(f"perfbench: film_gap over {len(pix)} pixels: {int((per_px > 1e-4).sum())} above "
          f"1e-4, median {float(per_px.median()):.3e}, max {float(per_px.max()):.3e}",
          file=sys.stderr)
    return [Check("film_gap", relative_l1(got, want), float(ctx.limits["film_gap"]))]


def work(ctx: Context) -> dict:
    return counts.work(ctx, estimator(ctx))
