"""Headline benchmark of the port: the twin of the repository's ``bench.py``.

The same workload and the same one JSON line: the Cornell box at
800×600, fixed depth 7 + the final emission gather, through the
whole-segment megakernel; then its value and gradient; then Russian
roulette through the regenerating wavefront. The reference scene is
used when its mount is present, the procedural box with mirror and
glass spheres (652 triangles) otherwise. The reference backend achieves
≈2.4 Msamples/s on a GTX 1070 (``vs_baseline``).

Run on the card::

    python -m montecarlopathtracer_tpu_torch.bench

It reads ``bench.py``'s environment: ``BENCH_WIDTH``, ``BENCH_HEIGHT``,
``BENCH_SPP_PER_PASS``, ``BENCH_PASSES``, ``BENCH_INTERSECTOR``,
``BENCH_RAY_CHUNK``; ``BENCH_GRAD`` (0 skips the gradient),
``BENCH_GRAD_SPP``, ``BENCH_GRAD_INTERSECTOR``, ``BENCH_GRAD_ITERS``;
``BENCH_RR`` (0 skips the regen part); ``BENCH_PROFILE_DIR`` (a
``torch.profiler`` trace of the timed forward passes). Each part runs
one warm-up (which builds the kernels at first use) before its timed
passes or iterations, and every fence is ``torch.cuda.synchronize()``.

Prints one JSON line on stdout with ``bench.py``'s metric name and keys;
diagnostics, the card's name and its power limit go to stderr. Unlike
``bench.py``, the regen part runs only where regen can: under
``BENCH_INTERSECTOR=megakernel`` or ``traverse``. With another
intersector it is left out and stderr says why (``bench.py`` raises
there). The gradient keeps no ``remat_segments``/``unroll_segments``:
the port has neither.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

BASELINE_MSAMPLES_S = 2.4  # GTX 1070, the reference's results table
METRIC = "cornell_800x600_depth7_brute_samples_throughput"
RR_SPP = 32  # samples per regen pass, as bench.py
RR_PASSES = 2


def main(device="cuda") -> int:
    from .cli import resolve_ray_chunk
    from .diff.grad import make_loss_fn, split_params, value_and_grad
    from .models import cornell
    from .ops.rng import make_key
    from .render.integrator import WHOLE_SEGMENT, TraceConfig
    from .render.renderer import Renderer, RenderSettings
    from .utils.logging import RenderLog
    from .utils.profiling import card, trace

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device is available")
    env = os.environ.get
    width = int(env("BENCH_WIDTH", 800))
    height = int(env("BENCH_HEIGHT", 600))
    spp_per_pass = int(env("BENCH_SPP_PER_PASS", 4))
    passes = int(env("BENCH_PASSES", 4))
    intersector = env("BENCH_INTERSECTOR", "megakernel")
    chunk = env("BENCH_RAY_CHUNK")
    ray_chunk = resolve_ray_chunk(None if chunk is None else int(chunk))

    if cornell.has_reference_scenes():
        scene, camera = cornell.load_reference_scene(1, width=width, height=height)
        scene_name = "scene01(ref)"
    else:
        scene, camera = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                            width=width, height=height)
        scene_name = "cornell(procedural)"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    config = TraceConfig(mode="fixed", max_depth=7, illum=10.0, ray_chunk=ray_chunk,
                         intersector=intersector)
    settings = RenderSettings(width=width, height=height, spp_per_pass=spp_per_pass, seed=0)
    log = RenderLog(stream=sys.stderr)
    r = Renderer(scene, camera, config, settings, log=log, device=dev)
    print(f"bench: {scene_name} T={scene.num_triangles} {width}x{height} depth=7+1 "
          f"spp/pass={spp_per_pass} passes={passes} intersector={intersector} "
          f"device={dev}", file=sys.stderr)
    print(card(dev), file=sys.stderr)

    t0 = time.perf_counter()
    r.render(1)
    sync()
    warmup_s = time.perf_counter() - t0
    print(f"warmup pass: {warmup_s:.1f}s", file=sys.stderr)

    # Time rendering, not logging: a pass's log line reads its noise
    # scalar back from the device.
    log.enabled = False
    t0 = time.perf_counter()
    with trace(env("BENCH_PROFILE_DIR")):
        r.render(passes)
        sync()
    dt = time.perf_counter() - t0
    log.enabled = True
    samples = width * height * spp_per_pass * passes
    msamples_s = samples / dt / 1e6
    print(f"{dt:.2f}s for {samples} samples → {msamples_s:.2f} Msamples/s "
          f"({msamples_s * 8:.1f} Mray-segments/s)", file=sys.stderr)

    # fwd+bwd: value and gradient of the pixel L2 loss in {Kd, Ka,
    # vertices}, the inverse-rendering parameters.
    fwdbwd_msamples_s = None
    if env("BENCH_GRAD", "1") != "0":
        gspp = int(env("BENCH_GRAD_SPP", 2))
        gcfg = TraceConfig(mode="fixed", max_depth=7, illum=10.0, ray_chunk=0,
                           intersector=env("BENCH_GRAD_INTERSECTOR", "megakernel"))
        target = torch.zeros(height, width, 3, device=dev)
        loss_fn = make_loss_fn(r.scene, r.camera, target, width=width, height=height,
                               spp=gspp, config=gcfg)
        params = split_params(r.scene, ("mat_kd", "mat_ka", "vertices"))
        t0 = time.perf_counter()
        loss, _ = value_and_grad(loss_fn, params, make_key(7))
        sync()
        print(f"grad first step: {time.perf_counter() - t0:.1f}s (loss {float(loss):.4f})",
              file=sys.stderr)
        iters = int(env("BENCH_GRAD_ITERS", 3))
        t0 = time.perf_counter()
        for i in range(iters):
            loss, _ = value_and_grad(loss_fn, params, make_key(8 + i))
        sync()
        gdt = time.perf_counter() - t0
        gsamples = width * height * gspp * iters
        fwdbwd_msamples_s = gsamples / gdt / 1e6
        print(f"fwd+bwd: {gdt:.2f}s for {gsamples} samples → {fwdbwd_msamples_s:.2f} "
              f"Msamples/s ({fwdbwd_msamples_s * 8:.1f} Mray-segments/s fwd+bwd)",
              file=sys.stderr)

    # RR through the regenerating wavefront: dead lanes restart their
    # pixel's next sample. An extra field; the headline stays the
    # fixed-mode scan pass.
    rr_regen_msamples_s = None
    if env("BENCH_RR", "1") != "0":
        if intersector not in WHOLE_SEGMENT:
            print(f"rr regen: left out: the regenerating wavefront needs "
                  f"BENCH_INTERSECTOR megakernel or traverse, not {intersector!r}",
                  file=sys.stderr)
        else:
            rr_cfg = TraceConfig(mode="rr", max_depth=7, illum=1.0, rr_depth=5, ray_chunk=0,
                                 intersector=intersector)
            rr_settings = RenderSettings(width=width, height=height, spp_per_pass=RR_SPP,
                                         seed=0, regen=True)
            rr = Renderer(r.scene, r.camera, rr_cfg, rr_settings, device=dev)
            rr.render(1)
            sync()
            t0 = time.perf_counter()
            rr.render(RR_PASSES)
            sync()
            rr_dt = time.perf_counter() - t0
            rr_regen_msamples_s = width * height * RR_SPP * RR_PASSES / rr_dt / 1e6
            print(f"rr regen ({RR_SPP} spp/pass): {rr_regen_msamples_s:.2f} Msamples/s",
                  file=sys.stderr)

    value = round(msamples_s, 3)
    record = {
        "metric": METRIC,
        "value": value,
        "unit": "Msamples/s",
        # Of the printed value, so that the line agrees with itself.
        "vs_baseline": round(value / BASELINE_MSAMPLES_S, 3),
        "fwd_msamples_s": value,
        "warmup_s": round(warmup_s, 1),
    }
    if rr_regen_msamples_s is not None:
        record["rr_regen_msamples_s"] = round(rr_regen_msamples_s, 3)
    if fwdbwd_msamples_s is not None:
        record["fwdbwd_msamples_s"] = round(fwdbwd_msamples_s, 3)
        record["fwdbwd_mray_segments_s"] = round(fwdbwd_msamples_s * 8, 2)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
