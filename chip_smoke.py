#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (montecarlopathtracer_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. environment: torch/CUDA versions, the GPU (compute capability 9.0
   required), nvcc, and nvidia-smi's name and power limit;
2. build: compile every csrc/*.cu of the port with nvcc for sm_90a, one
   nvcc process each, all started together;
3. the segment kernel against its plain-torch version on the card, on
   64x48 camera rays and a full 800x600 wavefront of first-bounce rays,
   in fixed mode (final gather off and on) and RR mode (roulette, hard
   kill), with the tolerances of montecarlopathtracer_tpu_torch.testing;
4. one 800x600 segment timed, kernel and plain (median of CUDA events);
5. the main path: Renderer at 800x600, fixed depth 7, 4 spp/pass, one
   warm-up and three timed passes, with the kernel's launch count and
   checks on the film; then a per-segment time breakdown of one sample;
6. a 160x120 frame at 1 spp, kernel against plain path, same key;
7. the gradient path's kernels (segment_backward.cu, scatter_rows.cu):
   their builds and ptxas reports;
8. the segment vjp kernel (B2) against its plain version on the 800x600
   first-bounce wavefront of phase 3, seeded random cotangents on all
   four outputs, in fixed mode (final gather off and on), RR mode
   (roulette on tied grey throughput, hard kill) and classic Phong;
9. the row scatter kernel (B3) against its plain version, 652 triangles,
   480,000 rays, on phase 8's row cotangents and on N(0,1) ones, each
   entry held to its own rounding bound;
10. one 800x600 segment's B2 and B3 timed against their plain versions;
11. the gradient main path (bench.py's fwd+bwd): value and gradient of
    an L2 pixel loss at 800x600, 2 spp, fixed depth 7, params
    {mat_kd, mat_ka, vertices}; one warm-up and three timed iterations,
    launch counts of all three kernels, checks on the gradients, and a
    profile of one iteration;
12. five SGD steps at 800x600, 1 spp, Kd started at 0.6x: the loss falls;
13. a 64x48 gradient render, kernel path against plain path, same key.

Prints one JSON line of per-kernel numbers, then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

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
BWD_SOURCE = f"{PKG}/csrc/segment_backward.cu"
BWD_REPLACES = "montecarlopathtracer_tpu/ops/segment_fused.py:619"
SCATTER_SOURCE = f"{PKG}/csrc/scatter_rows.cu"
SCATTER_REPLACES = "montecarlopathtracer_tpu/ops/intersect_pallas.py:1367"
KERNEL_NAMES = ("segment_fused", "segment_backward", "scatter_rows")
W, H = 800, 600
SPP, DEPTH = 4, 7
WARMUP_PASSES, TIMED_PASSES = 1, 3
GRAD_SPP, GRAD_ITERS = 2, 3


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


def ptxas_report(lib):
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())


def build():
    phase("2. build")
    from montecarlopathtracer_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build_all(KERNEL_NAMES)
    dt = time.perf_counter() - t0
    lib = libs["segment_fused"]
    print(f"built {len(libs)} sources in parallel in {dt:.2f} s; "
          f"{lib.relative_to(HERE)} from {KERNEL_SOURCE} (sm_90a)")
    ptxas_report(lib)
    cuda_build.load("segment_fused")
    return libs


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
    reset_counts()
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


def whole_frame(torch, scene):
    phase("6. whole frame 160x120, 1 spp: kernel vs plain path")
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.render.integrator import (
        TraceConfig,
        render_sample_batch,
    )
    from montecarlopathtracer_tpu_torch.scene.camera import camera_for_scene
    from montecarlopathtracer_tpu_torch.testing import compare_images, plain_kernels

    w, h = 160, 120
    cam = camera_for_scene(1, w, h, device="cuda")
    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0)
    got = render_sample_batch(scene, cam, make_key(3), w, h, config)
    with plain_kernels():
        ref = render_sample_batch(scene, cam, make_key(3), w, h, config)
    check(tuple(got.shape) == (h, w, 3), f"kernel frame shape {tuple(got.shape)}")
    rep = compare_images(got, ref)
    print(f"pixels within 1e-4: {rep['pixel_share']:.5f}  max |err| "
          f"{rep['max_abs_err']:.3e}  mean {float(got.mean()):.6f} vs "
          f"{float(ref.mean()):.6f} (rel {rep['mean_rel']:.2e})")
    check(rep["ok"], f"kernel frame disagrees with the plain path: {rep}")


def reset_counts():
    from montecarlopathtracer_tpu_torch.ops import scatter_rows as S
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F

    F.mega_segment.launches = F.segment_backward.launches = S.scatter_rows.launches = 0


def read_counts():
    from montecarlopathtracer_tpu_torch.ops import scatter_rows as S
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F

    return {"mega_segment": F.mega_segment.launches,
            "segment_backward": F.segment_backward.launches,
            "scatter_rows": S.scatter_rows.launches}


def grad_builds(libs):
    phase("7. build: the gradient path's kernels")
    from montecarlopathtracer_tpu_torch.ops import cuda_build

    for name, src in (("segment_backward", BWD_SOURCE), ("scatter_rows", SCATTER_SOURCE)):
        print(f"built {libs[name].relative_to(HERE)} from {src} (sm_90a)")
        ptxas_report(libs[name])
        cuda_build.load(name)


BWD_CASES = {
    "fixed fg=0": ("fixed", [0.0, 0.0, 0.0], {}),
    "fixed fg=1": ("fixed", [1.0, 0.0, 0.0], {}),
    "rr roulette, tied": ("rr", [0.0, 1.0, 0.0], {"illum": 1.0}),
    "rr hard_kill=1": ("rr", [0.0, 0.0, 1.0], {}),
    "phong_model=phong": ("fixed", [0.0, 0.0, 0.0], {"phong_model": "phong"}),
}


def backward_args(torch, rows, bounce, mode, flags, kw, tput=None, seed=0):
    """Segment-vjp inputs on a wavefront: its winners, the gathered rows
    and seeded random cotangents on the four outputs."""
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.rng import make_key

    pos, dir_, tput0, res, live = bounce
    tput = tput0 if tput is None else tput
    args = seg_args(torch, rows, pos, dir_, tput, res, live, make_key(5), flags)
    idx = F.mega_segment(*args, mode=mode, **kw)[0]
    full = rows.T.contiguous()[:, idx.clamp_min(0).long()]
    g = torch.Generator(device="cuda").manual_seed(seed)
    cts = [torch.randn(3, pos.shape[1], device="cuda", generator=g) for _ in range(4)]
    return idx, (*args[1:6], idx >= 0, full, *args[6:10], *cts)


def backward_vs_plain(torch, rows, bounce):
    phase("8. segment vjp kernel (B2) vs plain, 800x600 first-bounce wavefront")
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.testing import GRAD_TOL, compare_grads

    worst, last = 0.0, None
    for i, (cname, (mode, flags, kw)) in enumerate(BWD_CASES.items()):
        # Tied grey throughput: RR's p is a three-way tie on every lane.
        tput = torch.full_like(bounce[2], 0.6) if "tied" in cname else None
        idx, args = backward_args(torch, rows, bounce, mode, flags, kw, tput, seed=i)
        got = F.segment_backward(*args, mode=mode, **kw)
        torch.cuda.synchronize()
        want = F.segment_backward_ref(*args, mode=mode, **kw)
        torch.cuda.synchronize()
        rep = compare_grads(want, got, lanes=args[4])
        errs = rep["max_abs_err"]
        worst = max([worst, *errs.values()])
        print(f"{cname:18s} {rep['n_lanes']} live lanes; share within tol "
              + " ".join(f"{k} {v:.6f}" for k, v in rep["share_within"].items()))
        print(f"{'':18s} max |err| (scale) "
              + " ".join(f"{k} {errs[k]:.2e} ({rep['scale'][k]:.2e})" for k in errs))
        check(rep["ok"], f"segment_backward disagrees with plain on {cname}: {rep}")
        last = (idx, got[4])
    print(f"tolerance: per output |err| <= {GRAD_TOL:g} * (|ref| + max |ref|) on at "
          f"least 99.9% of live lanes, 1e-2 on all; worst |err| {worst:.3e}")
    return worst, last


def scatter_vs_plain(torch, rows, idx, d_full):
    phase("9. row scatter kernel (B3) vs plain, 652 triangles x 480,000 rays")
    from montecarlopathtracer_tpu_torch.ops import scatter_rows as S
    from montecarlopathtracer_tpu_torch.testing import SCATTER_ULPS, compare_scatter

    T = rows.shape[0]
    check(T == 652 and idx.shape[0] == W * H, f"T {T}, R {idx.shape[0]}")
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(9)
    for name, dvals in (("800x600 segment vjp d_full", d_full),
                        ("N(0,1) cotangents", torch.randn(d_full.shape, device="cuda",
                                                          generator=g))):
        got = S.scatter_rows(idx, dvals, T)
        torch.cuda.synchronize()
        want = S.scatter_rows_ref(idx, dvals, T)
        rep = compare_scatter(want, got, S.scatter_rows_ref(idx, dvals.abs(), T))
        worst = max(worst, rep["max_abs_err"])
        print(f"{name:28s} {int((idx >= 0).sum())} rays hit; max |err| "
              f"{rep['max_abs_err']:.3e} of a table max {float(want.abs().max()):.3e}; "
              f"worst |err| / (eps32 x sum |dvals|) {rep['worst_ulps']:.3f}")
        check(rep["ok"], f"scatter_rows disagrees with plain on {name}: {rep}")
    print(f"tolerance per entry: |err| <= {SCATTER_ULPS} x eps32 x (sum of |dvals| "
          f"added into it); atomics add in no fixed order")
    return worst


def time_pair(torch, kernel, plain, n=10):
    """Median CUDA-event ms of `kernel()` and `plain()`, alternating."""
    def timed(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    timed(kernel)
    timed(plain)
    ks, ps = [], []
    for i in range(n):
        for fn in ((kernel, plain) if i % 2 == 0 else (plain, kernel)):
            (ks if fn is kernel else ps).append(timed(fn))
    return statistics.median(ks), statistics.median(ps)


def time_backward(torch, rows, bounce):
    phase("10. one 800x600 segment's B2 and B3, kernel and plain")
    from montecarlopathtracer_tpu_torch.ops import scatter_rows as S
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F

    idx, args = backward_args(torch, rows, bounce, "fixed", [0.0, 0.0, 0.0], {})
    d_full = F.segment_backward(*args)[4]
    T = rows.shape[0]
    bwd = time_pair(torch, lambda: F.segment_backward(*args),
                    lambda: F.segment_backward_ref(*args))
    sc = time_pair(torch, lambda: S.scatter_rows(idx, d_full, T),
                   lambda: S.scatter_rows_ref(idx, d_full, T))
    print(f"segment_backward kernel {bwd[0]:.4f} ms  plain {bwd[1]:.4f} ms; "
          f"scatter_rows kernel {sc[0]:.4f} ms  plain {sc[1]:.4f} ms (median of 10, "
          f"{int(bounce[4].sum())} live rays of {W * H}, {T} triangles)")
    return bwd, sc


def grad_main_path(torch, scene, camera):
    phase(f"11. gradient main path: value and grad, {W}x{H}, {GRAD_SPP} spp, "
          f"fixed depth {DEPTH}")
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig

    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0)
    loss_fn = G.make_loss_fn(scene, camera, torch.zeros(H, W, 3, device="cuda"),
                             width=W, height=H, spp=GRAD_SPP, config=config)
    params = G.split_params(scene, ("mat_kd", "mat_ka", "vertices"))
    reset_counts()
    t0 = time.perf_counter()
    loss, grads = G.value_and_grad(loss_fn, params, make_key(7))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(GRAD_ITERS):
        loss, grads = G.value_and_grad(loss_fn, params, make_key(8 + i))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    msps = W * H * GRAD_SPP * GRAD_ITERS / dt / 1e6
    print(f"warm-up iteration {warm:.3f} s; {GRAD_ITERS} timed iterations {dt:.3f} s = "
          f"{dt / GRAD_ITERS:.4f} s/iteration, fwd+bwd {msps:.4f} Msamples/s "
          f"(loss {float(loss):.6f})")
    want = config.num_segments * GRAD_SPP * (1 + GRAD_ITERS)
    print(f"launches in the gradient path: {counts} (expected {want} each)")
    for name, n in counts.items():
        check(n == want, f"{name} launched {n} times, expected {want}")
    for name, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"gradient of {name} is not finite")
        print(f"grad {name}: shape {tuple(g.shape)} max |g| {float(g.abs().max()):.6e}")
    check(float(grads["mat_kd"].abs().max()) > 0.0, "mat_kd gradient is zero")
    check(float(grads["mat_ka"].abs().max()) > 0.0, "mat_ka gradient is zero")
    check(float(grads["vertices"].abs().max()) == 0.0,
          "interior vertex gradient is not exactly zero")
    grad_profile(torch, loss_fn, params, dt / GRAD_ITERS)
    return counts, dt / GRAD_ITERS, msps


def grad_profile(torch, loss_fn, params, per_iter):
    """Device time of one gradient iteration by kernel, from
    torch.profiler's kernel records; then the iteration's uniform draws
    alone on the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops.rng import make_key, stream_uniform

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        G.value_and_grad(loss_fn, params, make_key(20))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = {"B1 mega_segment": 0.0, "B2 segment_backward": 0.0,
              "B3 scatter_rows": 0.0, "other kernels": 0.0}
    n_other = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if "mega_segment_kernel" in e.key:
            groups["B1 mega_segment"] += us
        elif "segment_backward_kernel" in e.key:
            groups["B2 segment_backward"] += us
        elif "scatter_rows" in e.key:
            groups["B3 scatter_rows"] += us
        else:
            groups["other kernels"] += us
            n_other += e.count
    busy = sum(groups.values()) / 1e3
    if busy == 0.0:
        print("profiler recorded no device time; breakdown not measured")
    else:
        print(f"profiled iteration: wall {wall:.2f} ms (unprofiled "
              f"{per_iter * 1e3:.2f} ms), device busy {busy:.2f} ms "
              f"(share {busy / wall:.3f})")
        for name, us in groups.items():
            print(f"  {name:22s} {us / 1e3:9.3f} ms  ({us / 1e3 / wall:.3f} of wall)")
        print(f"  ({n_other} other kernel launches: threefry draws, gathers, "
              f"elementwise and reductions)")
    # The iteration's uniform draws alone (jitter and u1, u2 per segment,
    # per sample) on the host clock: the threefry is launch-bound, so its
    # wall time, not its device time, is what it costs the iteration.
    sids = (1 << 30, (1 << 30) + 1,
            *(4 * seg + k for seg in range(DEPTH + 1) for k in (0, 1)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRAD_SPP):
        for sid in sids:
            stream_uniform(make_key(21), sid, W * H, "cuda")
    torch.cuda.synchronize()
    print(f"  the iteration's {GRAD_SPP * len(sids)} uniform draws alone: "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms wall")


def sgd_steps(torch, scene, camera):
    phase(f"12. five SGD steps, {W}x{H}, 1 spp, Kd started at 0.6x")
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig

    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0)
    key = make_key(20)
    with torch.no_grad():
        target = G.render_image(G.split_params(scene, ("mat_kd",)), scene, camera, key,
                                width=W, height=H, spp=1, config=config)
    step = G.make_sgd_step(G.make_loss_fn(scene, camera, target, width=W, height=H,
                                          spp=1, config=config), lr=1.0)
    params = {"mat_kd": scene.mat_kd * 0.6}
    err0 = float((params["mat_kd"] - scene.mat_kd).abs().sum())
    losses = []
    for _ in range(5):
        params, loss = step(params, key)
        losses.append(float(loss))
    err1 = float((params["mat_kd"] - scene.mat_kd).abs().sum())
    print("losses " + " ".join(f"{x:.6e}" for x in losses)
          + f"; L1 error to the true Kd {err0:.4f} -> {err1:.4f}")
    check(all(x == x and abs(x) != float("inf") for x in losses), "loss not finite")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")


def grad_frame(torch, scene):
    phase("13. 64x48 gradient render: kernel path vs plain path")
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
    from montecarlopathtracer_tpu_torch.scene.camera import camera_for_scene
    from montecarlopathtracer_tpu_torch.testing import compare_param_grads, plain_kernels

    w, h = 64, 48
    cam = camera_for_scene(1, w, h, device="cuda")
    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0)
    loss_fn = G.make_loss_fn(scene, cam, torch.zeros(h, w, 3, device="cuda"), width=w,
                             height=h, spp=1, config=config)
    params = G.split_params(scene, ("mat_kd", "mat_ka", "vertices"))
    loss, got = G.value_and_grad(loss_fn, params, make_key(4))
    with plain_kernels():
        loss_ref, want = G.value_and_grad(loss_fn, params, make_key(4))
    rep = compare_param_grads(want, got, 1e-4)
    print(f"loss {float(loss):.7f} vs plain {float(loss_ref):.7f}; "
          + " ".join(f"{k} max |err| {v['max_abs_err']:.3e} of {v['scale']:.3e}"
                     for k, v in rep.items() if k != "ok")
          + " (tolerance 1e-4 x (|ref| + max |ref|))")
    check(rep["ok"], f"kernel-path gradients disagree with the plain path: {rep}")


def main():
    if not os.path.isdir(os.path.join(HERE, PKG, "csrc")):
        print(f"chip_smoke: FAIL: {PKG} is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch

    try:
        name, smi = environment(torch)
        libs = build()
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
        grad_builds(libs)
        bwd_err, (idx, d_full) = backward_vs_plain(torch, rows, bounce)
        sc_err = scatter_vs_plain(torch, rows, idx, d_full)
        bwd_ms, sc_ms = time_backward(torch, rows, bounce)
        counts, per_iter, grad_msps = grad_main_path(torch, scene, camera)
        sgd_steps(torch, scene, camera)
        grad_frame(torch, scene)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"\nmain path: {per_pass:.4f} s/pass, {msps:.4f} Msamples/s forward; "
          f"gradient path: {per_iter:.4f} s/iteration, {grad_msps:.4f} Msamples/s fwd+bwd")
    print(json.dumps({"kernels": [
        {"name": "mega_segment", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
         "ms": ms, "plain_ms": plain_ms},
        {"name": "segment_backward", "route": "cuda", "source": BWD_SOURCE,
         "replaces": BWD_REPLACES, "launches": counts["segment_backward"],
         "max_abs_err": bwd_err, "ms": bwd_ms[0], "plain_ms": bwd_ms[1]},
        {"name": "scatter_rows", "route": "cuda", "source": SCATTER_SOURCE,
         "replaces": SCATTER_REPLACES, "launches": counts["scatter_rows"],
         "max_abs_err": sc_err, "ms": sc_ms[0], "plain_ms": sc_ms[1]},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
