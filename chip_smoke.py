#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (montecarlopathtracer_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. environment: torch/CUDA versions, the GPU (compute capability 9.0
   required), nvcc, and nvidia-smi's name and power limit;
2. build: compile csrc/segment_fused.cu with nvcc for sm_90a;
3. the segment kernel against its plain-torch version on the card, on
   64x48 camera rays and a full 800x600 wavefront of first-bounce rays,
   in fixed mode (final gather off and on) and RR mode (roulette, hard
   kill), with the tolerances of montecarlopathtracer_tpu_torch.testing;
4. one 800x600 segment timed, kernel and plain (median of CUDA events);
5. the main path: Renderer at 800x600, fixed depth 7, 4 spp/pass, one
   warm-up and three timed passes, with the kernel's launch count and
   checks on the film; then a per-segment time breakdown of one sample;
6. a 160x120 frame at 1 spp, kernel against plain path, same key.

Prints one JSON line of per-kernel numbers, then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "montecarlopathtracer_tpu_torch"
KERNEL_SOURCE = f"{PKG}/csrc/segment_fused.cu"
REPLACES = "montecarlopathtracer_tpu/ops/segment_fused.py:390"
W, H = 800, 600
SPP, DEPTH = 4, 7
WARMUP_PASSES, TIMED_PASSES = 1, 3


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def run_tool(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"{cmd[0]} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def phase(name):
    print(f"\n== {name}", flush=True)


def environment(torch):
    phase("1. environment")
    check(torch.cuda.is_available(), "no CUDA device is available")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    print(f"device 0: {name}  capability {cap}  count {torch.cuda.device_count()}")
    check(cap == (9, 0), f"need compute capability (9, 0), got {cap}")
    from montecarlopathtracer_tpu_torch.ops import cuda_build

    nvcc = cuda_build.find_nvcc()
    print(f"nvcc {nvcc}: {run_tool([nvcc, '--version']).splitlines()[-1]}")
    smi = run_tool(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    print(smi)
    # f32 matmuls and convolutions in full precision (the plain path uses
    # neither, but a reference states and sets both).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


def build():
    phase("2. build")
    from montecarlopathtracer_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    lib = cuda_build.build("segment_fused")
    dt = time.perf_counter() - t0
    print(f"built {lib.relative_to(HERE)} from {KERNEL_SOURCE} "
          f"(sm_90a) in {dt:.2f} s")
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    cuda_build.load("segment_fused")


def seg_args(torch, rows, pos, dir_, tput, res, live, key, flags):
    from montecarlopathtracer_tpu_torch.ops.rng import stream_uniform

    R = pos.shape[1]
    dev = pos.device
    u1, u2, urr = (stream_uniform(key, s, R, dev) for s in (0, 1, 3))
    fl = torch.tensor(flags, dtype=torch.float32, device=dev).reshape(3, 1)
    return (rows, pos.contiguous(), dir_.contiguous(), tput.contiguous(),
            res.contiguous(), live.contiguous(), u1, u2, urr, fl)


def camera_wavefront(torch, camera, width, height, key):
    from montecarlopathtracer_tpu_torch.ops.rng import stream_uniform

    dev = camera.device
    R = width * height
    pix = torch.arange(R, device=dev)
    jx = stream_uniform(key, 1 << 30, R, dev) * 2.0 - 1.0
    jy = stream_uniform(key, (1 << 30) + 1, R, dev) * 2.0 - 1.0
    pos, dir_ = camera.generate_rays_soa(pix % width, pix // width, jx, jy,
                                         width, height)
    return (pos.contiguous(), dir_, torch.ones(3, R, device=dev),
            torch.zeros(3, R, device=dev),
            torch.ones(R, dtype=torch.bool, device=dev))


CASES = {
    "fixed fg=0": ("fixed", [0.0, 0.0, 0.0]),
    "fixed fg=1": ("fixed", [1.0, 0.0, 0.0]),
    "rr do_rr=1": ("rr", [0.0, 1.0, 0.0]),
    "rr hard_kill=1": ("rr", [0.0, 0.0, 1.0]),
}


def kernel_vs_plain(torch, scene, rows):
    phase("3. kernel vs plain on the card")
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.scene.camera import camera_for_scene
    from montecarlopathtracer_tpu_torch.testing import compare_segment

    key = make_key(11)
    small = camera_wavefront(torch, camera_for_scene(1, 64, 48, device="cuda"),
                             64, 48, key)
    full = camera_wavefront(torch, camera_for_scene(1, W, H, device="cuda"), W, H, key)
    # First-bounce wavefront: the state after the camera segment.
    out = F.mega_segment_ref(*seg_args(torch, rows, *full, key, [0.0, 0.0, 0.0]),
                             mode="fixed")
    bounce = (out[1], out[2], out[3], out[4], out[5] > 0.0)
    print(f"first-bounce wavefront: {int(bounce[4].sum())} of {W * H} live")
    worst = 0.0
    for wname, wave in (("64x48 camera", small), ("800x600 bounce", bounce)):
        for cname, (mode, flags) in CASES.items():
            args = seg_args(torch, rows, *wave, make_key(5), flags)
            got = F.mega_segment(*args, mode=mode)
            torch.cuda.synchronize()
            ref = F.mega_segment_ref(*args, mode=mode)
            torch.cuda.synchronize()
            rep = compare_segment(ref, got, live=args[5], rows=rows, pos=args[1],
                                  dir_=args[2])
            errs = rep["max_abs_err"]
            worst = max([worst, *errs.values()])
            print(f"{wname:15s} {cname:15s} idx agree {rep['idx_agree']:.6f} "
                  f"({rep['n_idx_mismatch']} near-tie mismatches of "
                  f"{rep['n_live']} live) max |err| "
                  + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f"; lanes beyond 1e-5: {rep['n_outliers']}")
            check(rep["ok"], f"kernel disagrees with plain on {wname} {cname}: {rep}")
    print("tolerance: rtol = atol = 1e-5 on agreeing lanes, at most 0.1% of them "
          f"within 1e-2 instead; worst |err| {worst:.3e}")
    return bounce, worst


def time_segment(torch, rows, bounce):
    phase("4. one 800x600 segment, kernel and plain")
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.rng import make_key

    args = seg_args(torch, rows, *bounce, make_key(5), [0.0, 0.0, 0.0])

    def timed(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args, mode="fixed")
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    timed(F.mega_segment)
    timed(F.mega_segment_ref)
    ks, ps = [], []
    for i in range(10):  # alternate which goes first
        order = (F.mega_segment, F.mega_segment_ref) if i % 2 == 0 else \
            (F.mega_segment_ref, F.mega_segment)
        for fn in order:
            (ks if fn is F.mega_segment else ps).append(timed(fn))
    ms, plain_ms = statistics.median(ks), statistics.median(ps)
    print(f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  (median of 10, "
          f"{int(bounce[4].sum())} live rays of {W * H}, {rows.shape[0]} triangles)")
    return ms, plain_ms


def main_path(torch, scene, camera):
    phase("5. main path: Renderer 800x600, fixed depth 7, 4 spp/pass")
    import numpy as np

    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings

    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0)
    settings = RenderSettings(width=W, height=H, spp_per_pass=SPP, seed=0)
    r = Renderer(scene, camera, config, settings, device="cuda")
    F.mega_segment.launches = 0
    t0 = time.perf_counter()
    r.render(WARMUP_PASSES)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    r.render(TIMED_PASSES)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = F.mega_segment.launches
    per_pass = dt / TIMED_PASSES
    msps = W * H * SPP * TIMED_PASSES / dt / 1e6
    print(f"warm-up pass {warm:.3f} s; {TIMED_PASSES} timed passes {dt:.3f} s = "
          f"{per_pass:.4f} s/pass, forward {msps:.4f} Msamples/s")
    want = config.num_segments * SPP * (WARMUP_PASSES + TIMED_PASSES)
    print(f"mega_segment launches in the main path: {launches} (expected {want})")
    check(launches == want, f"kernel launched {launches} times, expected {want}")

    img = r.film.color.cpu().numpy()
    weight = float(r.film.weight)
    check(img.shape == (H, W, 3), f"film shape {img.shape}")
    check(np.isfinite(img).all(), "film has non-finite values")
    check(weight == SPP * (WARMUP_PASSES + TIMED_PASSES), f"film weight {weight}")
    check(img.mean() > 0.0, "film is black")
    rows_ = slice(int(0.4 * H), int(0.6 * H))
    left = img[rows_, int(0.08 * W):int(0.20 * W)].reshape(-1, 3).mean(0)
    right = img[rows_, int(0.80 * W):int(0.92 * W)].reshape(-1, 3).mean(0)
    print(f"film mean {img.mean():.5f}  left wall rgb {left.round(4)}  "
          f"right wall rgb {right.round(4)}")
    check(left[0] > left[1] and left[0] > left[2], "left wall is not red-dominant")
    check(right[2] > right[0] and right[2] > right[1], "right wall is not blue-dominant")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    png = os.path.join(HERE, "build", "chip_smoke_800x600.png")
    r.save_png(png)
    print(f"wrote {os.path.relpath(png, HERE)}")
    return launches, per_pass, msps


def breakdown(torch, scene, camera, per_pass):
    """Device time of one main-path sample, split by segment: the
    kernel launch against the random draws around it."""
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key, stream_uniform
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig

    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0)
    rows = F.pack_rows_full(scene)
    key = fold_in(fold_in(make_key(0), 0), 0)
    pos, dir_, tput, res, live = camera_wavefront(torch, camera, W, H, key)
    flags = config.segment_flags("cuda")
    urr = torch.zeros(W * H, device="cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    rng_ms, kern_ms = [], []
    for seg in range(config.num_segments):
        ev[0].record()
        u1 = stream_uniform(key, 4 * seg, W * H, "cuda")
        u2 = stream_uniform(key, 4 * seg + 1, W * H, "cuda")
        ev[1].record()
        _, pos, dir_, tput, res, still = F.mega_segment(
            rows, pos, dir_, tput, res, live, u1, u2, urr, flags[seg])
        ev[2].record()
        live = still > 0.0
        torch.cuda.synchronize()
        rng_ms.append(ev[0].elapsed_time(ev[1]))
        kern_ms.append(ev[1].elapsed_time(ev[2]))
    k, g = sum(kern_ms), sum(rng_ms)
    print("per-segment kernel ms: " + " ".join(f"{x:.3f}" for x in kern_ms))
    print("per-segment rng ms:    " + " ".join(f"{x:.3f}" for x in rng_ms))
    print(f"one sample: kernel {k:.3f} ms + rng {g:.3f} ms; x{SPP} spp = kernel "
          f"{k * SPP:.2f} ms, rng {g * SPP:.2f} ms of a {per_pass * 1e3:.2f} ms pass "
          f"(kernel share {k * SPP / (per_pass * 1e3):.3f})")


@contextlib.contextmanager
def plain_segments():
    """Route the integrator's segments through the plain version, so the
    plain path runs on the card too."""
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.render import integrator

    integrator.mega_segment = F.mega_segment_ref
    try:
        yield
    finally:
        integrator.mega_segment = F.mega_segment


def whole_frame(torch, scene):
    phase("6. whole frame 160x120, 1 spp: kernel vs plain path")
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.render.integrator import (
        TraceConfig,
        render_sample_batch,
    )
    from montecarlopathtracer_tpu_torch.scene.camera import camera_for_scene
    from montecarlopathtracer_tpu_torch.testing import compare_images

    w, h = 160, 120
    cam = camera_for_scene(1, w, h, device="cuda")
    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0)
    got = render_sample_batch(scene, cam, make_key(3), w, h, config)
    with plain_segments():
        ref = render_sample_batch(scene, cam, make_key(3), w, h, config)
    check(tuple(got.shape) == (h, w, 3), f"kernel frame shape {tuple(got.shape)}")
    rep = compare_images(got, ref)
    print(f"pixels within 1e-4: {rep['pixel_share']:.5f}  max |err| "
          f"{rep['max_abs_err']:.3e}  mean {float(got.mean()):.6f} vs "
          f"{float(ref.mean()):.6f} (rel {rep['mean_rel']:.2e})")
    check(rep["ok"], f"kernel frame disagrees with the plain path: {rep}")


def main():
    if not os.path.isdir(os.path.join(HERE, PKG, "csrc")):
        print(f"chip_smoke: FAIL: {PKG} is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch

    try:
        name, smi = environment(torch)
        build()
        from montecarlopathtracer_tpu_torch.models import cornell

        scene, camera = cornell.cornell_box(
            with_mirror_sphere=True, with_glass_sphere=True, width=W, height=H,
            device="cuda",
        )
        from montecarlopathtracer_tpu_torch.ops.segment_fused import pack_rows_full

        rows = pack_rows_full(scene)
        print(f"scene: procedural Cornell box with mirror + glass spheres, "
              f"{scene.num_triangles} triangles")
        bounce, max_err = kernel_vs_plain(torch, scene, rows)
        ms, plain_ms = time_segment(torch, rows, bounce)
        launches, per_pass, msps = main_path(torch, scene, camera)
        breakdown(torch, scene, camera, per_pass)
        whole_frame(torch, scene)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"\nmain path: {per_pass:.4f} s/pass, {msps:.4f} Msamples/s forward")
    print(json.dumps({"kernels": [{
        "name": "mega_segment", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
