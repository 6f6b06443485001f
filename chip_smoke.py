#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (montecarlopathtracer_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. environment: torch/CUDA versions, the GPU (compute capability 9.0
   required), nvcc, and nvidia-smi's name and power limit;
2. build: compile every csrc/*.cu of the port (seven sources) with nvcc
   for sm_90a, one nvcc process each, all started together;
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
13. a 64x48 gradient render, kernel path against plain path, same key;
14. the regen and traversal paths' kernels (traverse_select.cu,
    rows_segment.cu): their builds and ptxas reports;
15. the segment kernel with per-lane flags (B1l) against its plain
    version on phase 3's 800x600 first-bounce wavefront, flags drawn per
    lane from a seed (final gather, roulette and hard kill mixed), fixed
    and RR mode, with the segment gate; B1l timed against plain;
16. the regen main path: Renderer on the Cornell box, RR (rr_depth 5,
    illum 1), 800x600, 32 spp per pass, regen; one warm-up and two timed
    passes, steps and B1l launches per pass, and the film mean held
    against a 32-spp scan render within 5 standard errors;
17. the traversal walk (B5) against its plain version on the 81,932-
    triangle bunny: a 1024x1024 camera wavefront and its sorted bounce
    wavefront with dead lanes, the kernel on every ray and the plain
    brute selection on a seeded subset of 65,536 of them; winners agree
    on >= 99.9% of live lanes, mismatches near-ties on which the brute
    CUDA kernel B1 (the same f32 pair test) sides with B5; chunks walked
    and tested per tile;
18. the segment from known winners (B6, and B6l with per-lane flags)
    against its plain version on the bunny's bounce wavefront;
19. B5, B6 and the brute B1 timed on that 1024x1024 wavefront (median of
    10 CUDA events), with their plain versions (B5's and B1's on the
    subset);
20. the bunny main path: Renderer 1024x1024, fixed depth 7 + final
    gather, 1 spp per pass, traverse + ray sort; one warm-up and two
    timed passes, launch counts, and a per-step breakdown of one sample
    (sort + gather, RNG, traverse_select, B6; a profile splits B5's
    kernel from the tile lists); then a regen pass on the same path at
    512x512, RR, 4 spp (B5 + B6l);
21. the bunny gradient: value and grad at 512x512, 1 spp, params
    {mat_kd, mat_ka, vertices}, launch counts of B5, B6, B2 and B3;
    21b: the row scatter (B3) of that gradient's segment with the most
    hits, 81,932 triangles x 262,144 rays (its f64 global-atomics path),
    against its plain version on those cotangents and on N(0,1) ones,
    and timed;
22. a 64x48 bunny gradient render (subdiv 3), kernel path against plain
    path;
23. the split path's kernels (nearest_shade.cu: B4 and its cull instance
    B4c; nearest_triangle.cu: B7) and B1c (segment_fused.cu's cull
    instance): ptxas reports;
24. B1c against its plain version (brute selection on the Morton-ordered
    table) on the glossy stage's 800x600 camera wavefront and its sorted
    first bounce with dead lanes, fixed and RR, scalar and per-lane
    flags (the segment gate), and against B1 on the same table (the same
    winners); chunks tested per block;
25. B4, B4c and B7 against their plain versions on phase 3's Cornell
    800x600 first bounce and the glossy wavefronts: winners with the
    near-tie allowance, shading rows equal, t, beta, gamma to 1e-5 or
    within 16 x eps32 x their rounding scale of the float64 values;
26. B1c, B4, B4c and B7 timed (median of 10 CUDA events) beside their
    plain versions and B1 on the same wavefront;
27. the cull main path: Renderer on the glossy stage, 800x600, fixed
    depth 7 + gather, 4 spp/pass, chunk_cull + ray_sort, one warm-up and
    two timed passes, B1c launches; one sample against the render
    without culling; then one pass of the same path split (B4c);
28. the split path: Renderer on the Cornell box, 800x600,
    whole_segment=False, 4 spp/pass, B4 launches, its film against the
    whole-segment film of the same passes; one pass of the fused
    intersector (B7);
29. the split-path gradient: value and grad at 800x600, 2 spp, {mat_kd,
    mat_ka, vertices}, B4 and B3 launches, against the whole-segment
    gradient of the same key;
30. the geometry step (BASELINE config 5): make_translation_problem on
    the Cornell lamp at 800x600, fixed depth 2, 2 spp, 4096 edge samples,
    split path: loss and gradient finite, the gradient against a central
    difference of the same-key loss (0.35 x max(|fd|, 0.05)), time per
    step.

Every kernel line carries its bound: the least time for its bytes (each
input read once, each output written once, 3.35 TB/s) and its f32
operations (67 TFLOP/s), both the H100 SXM's published rates.

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
LANE_REPLACES = "montecarlopathtracer_tpu/ops/segment_fused.py:570"
BWD_SOURCE = f"{PKG}/csrc/segment_backward.cu"
BWD_REPLACES = "montecarlopathtracer_tpu/ops/segment_fused.py:619"
SCATTER_SOURCE = f"{PKG}/csrc/scatter_rows.cu"
SCATTER_REPLACES = "montecarlopathtracer_tpu/ops/intersect_pallas.py:1367"
TRAVERSE_SOURCE = f"{PKG}/csrc/traverse_select.cu"
TRAVERSE_REPLACES = "montecarlopathtracer_tpu/ops/traverse_pallas.py:199"
ROWS_SOURCE = f"{PKG}/csrc/rows_segment.cu"
ROWS_REPLACES = "montecarlopathtracer_tpu/ops/segment_fused.py:911"
ROWS_LANE_REPLACES = "montecarlopathtracer_tpu/ops/segment_fused.py:991"
CULL_REPLACES = "montecarlopathtracer_tpu/ops/segment_fused.py:570"
SHADE_SOURCE = f"{PKG}/csrc/nearest_shade.cu"
SHADE_REPLACES = "montecarlopathtracer_tpu/ops/intersect_pallas.py:1006"
SHADE_CULL_REPLACES = "montecarlopathtracer_tpu/ops/intersect_pallas.py:1297"
TRIANGLE_SOURCE = f"{PKG}/csrc/nearest_triangle.cu"
TRIANGLE_REPLACES = "montecarlopathtracer_tpu/ops/intersect_pallas.py:173"
KERNEL_NAMES = ("segment_fused", "segment_backward", "scatter_rows", "traverse_select",
                "rows_segment", "nearest_shade", "nearest_triangle")
W, H = 800, 600
SPP, DEPTH = 4, 7
WARMUP_PASSES, TIMED_PASSES = 1, 3
GRAD_SPP, GRAD_ITERS = 2, 3
REGEN_SPP, REGEN_TIMED = 32, 2
BW = BH = 1024  # the bunny's frame
SUBSET = 65_536  # rays on which the plain brute selection is compared
BUNNY_TIMED = 2
BUNNY_GRAD_W, BUNNY_GRAD_ITERS = 512, 2
BUNNY_REGEN_SPP = 4


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
    bounce = tuple(x.contiguous() for x in (out[1], out[2], out[3], out[4], out[5] > 0.0))
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
    bound = segment_bound(rows.shape[0], W * H, int(bounce[4].sum()))
    print(f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  (median of 10, "
          f"{int(bounce[4].sum())} live rays of {W * H}, {rows.shape[0]} triangles); bound "
          f"{bound[0]:.4f} ms ({bound[1]})")
    return ms, plain_ms, bound


def main_path(torch, scene, camera):
    phase("5. main path: Renderer 800x600, fixed depth 7, 4 spp/pass")
    import numpy as np

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
    counts = read_all_counts()
    launches = counts["B1"]
    per_pass = dt / TIMED_PASSES
    msps = W * H * SPP * TIMED_PASSES / dt / 1e6
    print(f"warm-up pass {warm:.3f} s; {TIMED_PASSES} timed passes {dt:.3f} s = "
          f"{per_pass:.4f} s/pass, forward {msps:.4f} Msamples/s")
    want = config.num_segments * SPP * (WARMUP_PASSES + TIMED_PASSES)
    print(f"mega_segment launches in the main path: {launches} (expected {want})")
    check(launches == want and counts["B1l"] == 0, f"launches {counts}, expected {want} B1")

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
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
    from montecarlopathtracer_tpu_torch.ops import scatter_rows as S
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW

    F.mega_segment.launches = F.segment_backward.launches = S.scatter_rows.launches = 0
    F.mega_segment.lane_launches = F.mega_segment.cull_launches = 0
    F.rows_segment.launches = F.rows_segment.lane_launches = 0
    TW.traverse_select.launches = NS.nearest_triangle.launches = 0
    NS.nearest_shade_full.launches = NS.nearest_shade_full.cull_launches = 0


def read_all_counts():
    """Launches of every kernel: B1 apart from its per-lane-flag form B1l
    and its culling form B1c (no path here runs both at once), B4 apart
    from B4c, B6 apart from B6l."""
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
    from montecarlopathtracer_tpu_torch.ops import scatter_rows as S
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW

    B1 = F.mega_segment
    return {"B1": B1.launches - B1.lane_launches - B1.cull_launches,
            "B1l": B1.lane_launches, "B1c": B1.cull_launches,
            "B2": F.segment_backward.launches, "B3": S.scatter_rows.launches,
            "B4": NS.nearest_shade_full.launches - NS.nearest_shade_full.cull_launches,
            "B4c": NS.nearest_shade_full.cull_launches,
            "B5": TW.traverse_select.launches,
            "B6": F.rows_segment.launches - F.rows_segment.lane_launches,
            "B6l": F.rows_segment.lane_launches, "B7": NS.nearest_triangle.launches}


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


def scatter_vs_plain(torch, idx, d_full, T, source):
    """B3 against its plain version on the row cotangents ``d_full`` of
    one segment (``source`` names it) and on N(0,1) ones of the same
    shape, each entry held to its own rounding bound; returns the worst
    |err|.

    The reference is the plain version on the same values in float64,
    i.e. the exact sums to f32's eyes: in f32 the plain version's
    ``index_add_`` adds with atomics in no fixed order too, so on a row
    that thousands of rays hit its own rounding error is as large as the
    kernel's. Its distance from the exact sums is printed beside."""
    from montecarlopathtracer_tpu_torch.ops import scatter_rows as S
    from montecarlopathtracer_tpu_torch.testing import SCATTER_ULPS, compare_scatter

    worst = 0.0
    hit = idx >= 0
    most = int(torch.bincount(idx[hit].long(), minlength=T).max())
    g = torch.Generator(device="cuda").manual_seed(9)
    for name, dvals in ((source, d_full),
                        ("N(0,1) cotangents", torch.randn(d_full.shape, device="cuda",
                                                          generator=g))):
        got = S.scatter_rows(idx, dvals, T)
        torch.cuda.synchronize()
        exact = S.scatter_rows_ref(idx, dvals.double(), T)
        bound = S.scatter_rows_ref(idx, dvals.double().abs(), T)
        rep = compare_scatter(exact, got, bound)
        plain = compare_scatter(exact, S.scatter_rows_ref(idx, dvals, T), bound)
        worst = max(worst, rep["max_abs_err"])
        print(f"{name:34s} {int(hit.sum())} rays hit, at most {most} into one row; "
              f"max |err| {rep['max_abs_err']:.3e} of a table max "
              f"{float(exact.abs().max()):.3e}; worst |err| / (eps32 x sum |dvals|) "
              f"{rep['worst_ulps']:.3f} (plain in f32: {plain['worst_ulps']:.3f})")
        check(rep["ok"], f"scatter_rows disagrees with plain on {name}: {rep}")
    print(f"tolerance per entry: |err| <= {SCATTER_ULPS} x eps32 x (sum of |dvals| "
          f"added into it) against the plain version in float64")
    return worst


def event_ms(torch, fn):
    """CUDA-event ms of one call of `fn()`."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def time_pair(torch, kernel, plain, n=10):
    """Median CUDA-event ms of `kernel()` and `plain()`, alternating."""
    event_ms(torch, kernel)
    event_ms(torch, plain)
    ks, ps = [], []
    for i in range(n):
        for fn in ((kernel, plain) if i % 2 == 0 else (plain, kernel)):
            (ks if fn is kernel else ps).append(event_ms(torch, fn))
    return statistics.median(ks), statistics.median(ps)


def time_one(torch, fn, n=10):
    """Median CUDA-event ms of `fn()` after one warm-up call."""
    event_ms(torch, fn)
    return statistics.median(event_ms(torch, fn) for _ in range(n))


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
    R, hits = W * H, int((idx >= 0).sum())
    bwd = (*bwd, bound_of(R * (48 + 2 + 192 + 12 + 48) + 12 + R * (48 + 192), hits * 40))
    sc = (*sc, bound_of(R * 196 + T * 192, hits * 48), library_index_add(torch, idx, d_full, T))
    print(f"segment_backward kernel {bwd[0]:.4f} ms  plain {bwd[1]:.4f} ms (bound "
          f"{bwd[2][0]:.4f} ms, {bwd[2][1]}); scatter_rows kernel {sc[0]:.4f} ms  plain "
          f"{sc[1]:.4f} ms (bound {sc[2][0]:.4f} ms, {sc[2][1]}; one index_add_ {sc[3]:.4f} ms) "
          f"(median of 10, {int(bounce[4].sum())} live rays of {W * H}, {T} triangles)")
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
    counts = {k: v for k, v in read_all_counts().items() if k in ("B1", "B2", "B3")}
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


def profile_device(torch, what, fn, kernels, unprofiled_ms):
    """Device time of one call of ``fn`` by kernel, from torch.profiler's
    kernel records: ``kernels`` maps a printed name to a substring of the
    CUDA kernel's name; every other kernel counts as "other kernels".
    Returns the ms of each group, or None when the profiler recorded no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = dict.fromkeys([*kernels, "other kernels"], 0.0)
    n_other = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        name = next((n for n, sub in kernels.items() if sub in e.key), "other kernels")
        groups[name] += us
        n_other += e.count if name == "other kernels" else 0
    busy = sum(groups.values()) / 1e3
    if busy == 0.0:
        print("profiler recorded no device time; breakdown not measured")
        return None
    print(f"profiled {what}: wall {wall:.2f} ms (unprofiled {unprofiled_ms:.2f} ms), "
          f"device busy {busy:.2f} ms (share {busy / wall:.3f})")
    for name, us in groups.items():
        print(f"  {name:22s} {us / 1e3:9.3f} ms  ({us / 1e3 / wall:.3f} of wall)")
    print(f"  ({n_other} other kernel launches: threefry draws, sorts, gathers, "
          f"elementwise and reductions)")
    return {name: us / 1e3 for name, us in groups.items()}


def grad_profile(torch, loss_fn, params, per_iter):
    """Device time of one gradient iteration by kernel; then the
    iteration's uniform draws alone on the host clock."""
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops.rng import make_key, stream_uniform

    profile_device(torch, "iteration", lambda: G.value_and_grad(loss_fn, params, make_key(20)),
                   {"B1 mega_segment": "mega_segment_kernel",
                    "B2 segment_backward": "segment_backward_kernel",
                    "B3 scatter_rows": "scatter_rows"}, per_iter * 1e3)
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


def regen_builds(libs):
    phase("14. build: the regen and traversal paths' kernels")
    from montecarlopathtracer_tpu_torch.ops import cuda_build

    for name, src in (("traverse_select", TRAVERSE_SOURCE), ("rows_segment", ROWS_SOURCE)):
        print(f"built {libs[name].relative_to(HERE)} from {src} (sm_90a)")
        ptxas_report(libs[name])
        cuda_build.load(name)


def seeded_lane_flags(torch, R, seed):
    """f32[3, R] flags, each lane's drawn from a seed: final gather on
    30%, roulette on 50%, hard kill on 20% of lanes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    share = torch.tensor([[0.3], [0.5], [0.2]], device="cuda")
    return (torch.rand(3, R, device="cuda", generator=g) < share).float()


def lane_vs_plain(torch, rows, bounce):
    phase(f"15. segment kernel with per-lane flags (B1l) vs plain, {W}x{H} first bounce")
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.testing import compare_segment

    worst = 0.0
    for i, mode in enumerate(("fixed", "rr")):
        args = list(seg_args(torch, rows, *bounce, make_key(15), [0.0, 0.0, 0.0]))
        args[9] = seeded_lane_flags(torch, W * H, seed=i)
        got = F.mega_segment(*args, mode=mode)
        torch.cuda.synchronize()
        ref = F.mega_segment_ref(*args, mode=mode)
        rep = compare_segment(ref, got, live=args[5], rows=rows, pos=args[1], dir_=args[2])
        errs = rep["max_abs_err"]
        worst = max([worst, *errs.values()])
        print(f"{mode:6s} lane flags: idx agree {rep['idx_agree']:.6f} "
              f"({rep['n_idx_mismatch']} near-tie mismatches of {rep['n_live']} live) "
              "max |err| " + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; lanes beyond 1e-5: {rep['n_outliers']}")
        check(rep["ok"], f"B1l disagrees with plain in {mode} mode: {rep}")
    ms = time_pair(torch, lambda: F.mega_segment(*args, mode="rr"),
                   lambda: F.mega_segment_ref(*args, mode="rr"))
    bound = segment_bound(rows.shape[0], W * H, int(bounce[4].sum()), lane=True)
    print(f"B1l kernel {ms[0]:.4f} ms  plain {ms[1]:.4f} ms (median of 10, RR, "
          f"{int(bounce[4].sum())} live rays of {W * H}; bound {bound[0]:.4f} ms, {bound[1]}); "
          f"tolerance as phase 3; worst |err| {worst:.3e}")
    return worst, (*ms, bound)


def regen_main_path(torch, scene, camera):
    phase(f"16. regen main path: Renderer {W}x{H}, RR, {REGEN_SPP} spp/pass, "
          "regenerating wavefront")
    import numpy as np

    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key
    from montecarlopathtracer_tpu_torch.render.integrator import (
        TraceConfig,
        render_rows_planar,
    )
    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings

    config = TraceConfig(mode="rr", rr_depth=5, illum=1.0)
    settings = RenderSettings(width=W, height=H, spp_per_pass=REGEN_SPP, seed=0, regen=True)
    r = Renderer(scene, camera, config, settings, device="cuda")
    # A regen pass launches B1l once per step, and nothing else of B1:
    # the B1l count after each pass (a host-side counter, no sync) is its
    # step count.
    reset_counts()
    t0 = time.perf_counter()
    r.render(1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    steps = [read_all_counts()["B1l"]]
    t0 = time.perf_counter()
    for _ in range(REGEN_TIMED):
        r.render(1)
        steps.append(read_all_counts()["B1l"] - sum(steps))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_all_counts()
    msps = W * H * REGEN_SPP * REGEN_TIMED / dt / 1e6
    print(f"warm-up pass {warm:.3f} s; {REGEN_TIMED} timed passes {dt:.3f} s = "
          f"{dt / REGEN_TIMED:.4f} s/pass, RR regen {msps:.4f} Msamples/s")
    print(f"steps (B1l launches) per pass {steps}; B1 {counts['B1']}")
    check(counts["B1"] == 0 and min(steps) > 0, f"regen launched {counts}, expected "
          "B1l on every step and no B1")
    check(max(steps) < REGEN_SPP * config.num_segments, f"steps {steps} hit the backstop")

    img = r.film.color.cpu().numpy()
    check(img.shape == (H, W, 3) and np.isfinite(img).all(), "regen film not finite")
    check(float(r.film.weight) == REGEN_SPP * len(steps), f"film weight {float(r.film.weight)}")
    # The scan integrator's estimate of the same image from 32 samples:
    # the frame means of its samples give the standard error. Timed too
    # (with one sync per sample for its mean), beside regen's pass.
    key = make_key(99)
    t0 = time.perf_counter()
    with torch.no_grad():
        means = [float(render_rows_planar(scene, camera, fold_in(key, i), W, H, 0, H,
                                          config, r.tables).mean())
                 for i in range(REGEN_SPP)]
    scan_s = time.perf_counter() - t0
    print(f"scan integrator, same config, {REGEN_SPP} spp: {scan_s:.4f} s, "
          f"{W * H * REGEN_SPP / scan_s / 1e6:.4f} Msamples/s, "
          f"{REGEN_SPP * config.num_segments} B1 launches")
    scan, sd = statistics.mean(means), statistics.stdev(means)
    se = sd * (1.0 / REGEN_SPP + 1.0 / (REGEN_SPP * len(steps))) ** 0.5
    film = float(img.mean())
    print(f"film mean {film:.6f} ({REGEN_SPP * len(steps)} spp) vs scan {scan:.6f} "
          f"({REGEN_SPP} spp): |diff| {abs(film - scan):.2e}, {abs(film - scan) / se:.2f} "
          f"standard errors ({se:.2e}); bound 5")
    check(abs(film - scan) <= 5.0 * se, "regen film mean is off the scan's")
    png = os.path.join(HERE, "build", "chip_smoke_regen_800x600.png")
    r.save_png(png)
    print(f"wrote {os.path.relpath(png, HERE)}")
    profile_device(torch, "regen pass", lambda: r.render(1),
                   {"B1l mega_segment": "mega_segment_kernel"}, dt / REGEN_TIMED * 1e3)
    return counts, msps, statistics.mean(steps)


def bunny_setup(torch):
    phase("bunny scene: 81,932 triangles in Morton order")
    from montecarlopathtracer_tpu_torch.models import bunny
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig, scene_tables

    t0 = time.perf_counter()
    scene, camera = bunny.bunny_scene(subdiv=6, width=BW, height=BH, device="cuda")
    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0, intersector="traverse",
                         ray_sort=True)
    tables = scene_tables(scene, config)
    torch.cuda.synchronize()
    print(f"{scene.num_triangles} triangles, {tables.clo.shape[0]} chunks of 128; "
          f"built in {time.perf_counter() - t0:.2f} s")
    check(scene.num_triangles == 81932, f"bunny has {scene.num_triangles} triangles")
    return scene, camera, config, tables


def bunny_waves(torch, camera, config, tables):
    """The 1024x1024 camera wavefront and its bounce wavefront after one
    segment through B5 and B6, sorted as the integrator sorts it (dead
    lanes last)."""
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW
    from montecarlopathtracer_tpu_torch.ops.morton import DEAD_KEY, ray_sort_keys
    from montecarlopathtracer_tpu_torch.ops.rng import make_key, stream_uniform

    key = make_key(13)
    cam = camera_wavefront(torch, camera, BW, BH, key)
    pos, dir_, tput, res, live = cam
    cam = (pos, dir_.contiguous(), tput, res, live)
    R = BW * BH
    idx = TW.traverse_select(tables.rows, tables.clo, tables.chi, *cam[:2], live)
    u1, u2 = (stream_uniform(key, s, R, "cuda") for s in (0, 1))
    out = F.rows_segment(tables.rows, idx, *cam, u1, u2, torch.zeros(R, device="cuda"),
                         config.segment_flags("cuda")[0])
    alive = out[4] > 0.0
    keys = torch.where(alive, ray_sort_keys(out[0], out[1], tables.lo, tables.hi), DEAD_KEY)
    order = torch.argsort(keys, stable=True)
    bounce = (*(x[:, order].contiguous() for x in out[:4]), alive[order].contiguous())
    return cam, bounce


def subset_of(torch, wave, sub):
    return tuple((x[:, sub] if x.dim() == 2 else x[sub]).contiguous() for x in wave)


def traverse_vs_plain(torch, tables, waves, sub):
    phase(f"17. traversal walk (B5) vs plain brute selection, bunny {BW}x{BH}")
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW
    from montecarlopathtracer_tpu_torch.testing import compare_winners

    R = BW * BH
    nt, nc = R // TW.RAY_TILE, tables.clo.shape[0]
    worst = 0.0
    zeros = torch.zeros(SUBSET, device="cuda")
    for name, wave in zip(("camera", "sorted bounce"), waves):
        pos, dir_, _, _, live = wave
        visits = torch.zeros(2, nt, dtype=torch.int32, device="cuda")
        got = TW.traverse_select(tables.rows, tables.clo, tables.chi, pos, dir_, live,
                                 visits=visits)
        torch.cuda.synchronize()
        p, d, tp, rs, lv = subset_of(torch, wave, sub)
        want = TW.traverse_select_ref(tables.rows, tables.clo, tables.chi, p, d, lv)
        rep = compare_winners(got[sub], want, live=lv, rows=tables.rows, pos=p, dir_=d)
        worst = max(worst, rep["max_t_gap"])
        # The brute CUDA kernel B1 runs B5's pair test in the same f32
        # arithmetic (FMA contraction included) over every triangle: where
        # B5 parts from the plain version, B1 must side with B5. A lane
        # that B5's slab test or early exit dropped would side with plain.
        brute = F.mega_segment(tables.rows, p, d, tp, rs, lv, zeros, zeros, zeros,
                               torch.zeros(3, 1, device="cuda"))[0]
        diff = lv & (got[sub] != want)
        n_b1 = int((brute[diff] == got[sub][diff]).sum())
        n_b1_all = int((brute[lv] == got[sub][lv]).sum())
        v = visits.cpu().numpy()
        busy = v[0] > 0
        walked, tested = (float(x[busy].mean()) if busy.any() else 0.0 for x in v)
        print(f"{name:13s}: {int(live.sum())} live of {R} rays; on the subset of "
              f"{SUBSET} ({rep['n_live']} live) winners agree {rep['idx_agree']:.6f} "
              f"({rep['n_idx_mismatch']} mismatches, all near-ties: "
              f"{rep['mismatches_all_near_ties']}, max t gap {rep['max_t_gap']:.2e})")
        print(f"{'':15s}brute kernel B1 equals B5 on {n_b1} of the {rep['n_idx_mismatch']} "
              f"mismatched lanes, and on {n_b1_all} of the subset's {rep['n_live']} live")
        print(f"{'':15s}chunks per tile of {TW.RAY_TILE} rays ({int(busy.sum())} of {nt} "
              f"tiles walk): walked mean {walked:.1f} max {v[0].max()}, tested "
              f"mean {tested:.1f} max {v[1].max()}, of {nc} chunks")
        check(rep["ok"], f"B5 disagrees with brute selection on the {name} wavefront: {rep}")
        check(n_b1 == rep["n_idx_mismatch"],
              f"B5 parts from the brute kernel B1 on {rep['n_idx_mismatch'] - n_b1} lanes "
              f"where it parts from plain ({name} wavefront)")
    print("gate: winners equal on >= 99.9% of live lanes, every mismatch a near-tie on "
          "which B1 (same f32 arithmetic) agrees with B5, dead lanes -1")
    return worst


def rows_vs_plain(torch, tables, bounce):
    phase(f"18. segment from known winners (B6, B6l) vs plain, bunny {BW}x{BH} bounce")
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW
    from montecarlopathtracer_tpu_torch.ops.rng import make_key, stream_uniform
    from montecarlopathtracer_tpu_torch.testing import compare_segment

    pos, dir_, tput, res, live = bounce
    R = pos.shape[1]
    idx = TW.traverse_select(tables.rows, tables.clo, tables.chi, pos, dir_, live)
    key = make_key(18)
    u1, u2, urr = (stream_uniform(key, s, R, "cuda") for s in (0, 1, 3))
    worst = {}
    cases = (("B6", torch.tensor([[0.0], [1.0], [0.0]], device="cuda")),
             ("B6l", seeded_lane_flags(torch, R, seed=18)))
    for name, flags in cases:
        worst[name] = 0.0
        for mode in ("fixed", "rr"):
            args = (tables.rows, idx, pos, dir_, tput, res, live, u1, u2, urr, flags)
            got = F.rows_segment(*args, mode=mode)
            torch.cuda.synchronize()
            ref = F.rows_segment_ref(*args, mode=mode)
            rep = compare_segment((idx, *ref), (idx, *got), live=live, rows=tables.rows,
                                  pos=pos, dir_=dir_)
            errs = rep["max_abs_err"]
            worst[name] = max([worst[name], *errs.values()])
            print(f"{name:3s} {mode:5s}: {rep['n_live']} live; max |err| "
                  + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f"; lanes beyond 1e-5: {rep['n_outliers']}")
            check(rep["ok"], f"{name} disagrees with plain in {mode} mode: {rep}")
    print("tolerance: rtol = atol = 1e-5, at most 0.1% of lanes within 1e-2 instead")
    return worst, idx, (u1, u2, urr), cases


def time_bunny(torch, tables, bounce, sub, idx, draws, cases):
    phase(f"19. bunny {BW}x{BH} bounce wavefront: B5, B6 and brute B1 timed")
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW

    pos, dir_, tput, res, live = bounce
    p, d, _, _, lv = subset_of(torch, bounce, sub)
    rows, clo, chi = tables.rows, tables.clo, tables.chi
    b5 = time_pair(torch, lambda: TW.traverse_select(rows, clo, chi, pos, dir_, live),
                   lambda: TW.traverse_select_ref(rows, clo, chi, p, d, lv))
    u1, u2, urr = draws
    b6 = {name: time_pair(torch, lambda f=flags: F.rows_segment(
        rows, idx, pos, dir_, tput, res, live, u1, u2, urr, f),
        lambda f=flags: F.rows_segment_ref(rows, idx, pos, dir_, tput, res, live, u1, u2,
                                           urr, f)) for name, flags in cases}
    fl = cases[0][1]
    sub_args = (*subset_of(torch, bounce, sub), u1[sub], u2[sub], urr[sub], fl)
    b1 = time_pair(torch, lambda: F.mega_segment(rows, pos, dir_, tput, res, live, u1, u2,
                                                 urr, fl),
                   lambda: F.mega_segment_ref(rows, *sub_args))
    n_live = int(live.sum())
    print(f"({n_live} live of {BW * BH} rays; plain B5 and B1 on the {SUBSET}-ray subset; "
          "median of 10 CUDA events)")
    print(f"B5 walk        kernel {b5[0]:9.4f} ms   plain {b5[1]:9.4f} ms on the subset")
    for name, (k, pl) in b6.items():
        print(f"{name:3s} segment    kernel {k:9.4f} ms   plain {pl:9.4f} ms")
    print(f"B1 brute       kernel {b1[0]:9.4f} ms   plain {b1[1]:9.4f} ms on the subset")
    print(f"walk + segment {b5[0] + b6['B6'][0]:.4f} ms against brute B1 {b1[0]:.4f} ms: "
          f"{b1[0] / (b5[0] + b6['B6'][0]):.1f}x")
    T, R, nc, hits = rows.shape[0], BW * BH, clo.shape[0], int((idx >= 0).sum())
    pairs = reached_pairs(torch, clo, chi, T, pos, dir_, live,
                          winner_t(torch, rows, idx, pos, dir_))
    b5 = (*b5, bound_of(T * 192 + nc * 24 + R * 25 + R * 4, pairs * PAIR_OPS))
    for name, lane in (("B6", False), ("B6l", True)):
        nbytes = T * 192 + R * 4 + R * STATE_BYTES + (12 * R if lane else 12) + R * 52
        b6[name] = (*b6[name], bound_of(nbytes, hits * 40))
    print(f"bounds: B5 {b5[2][0]:.4f} ms ({b5[2][1]}; {pairs:.4g} reachable pairs of "
          f"{n_live * T} live pairs), B6 {b6['B6'][2][0]:.4f} ms ({b6['B6'][2][1]}), "
          f"B6l {b6['B6l'][2][0]:.4f} ms ({b6['B6l'][2][1]})")
    return b5, b6, b1


def bunny_main_path(torch, scene, camera, config):
    phase(f"20. bunny main path: Renderer {BW}x{BH}, fixed depth {DEPTH} + gather, "
          "1 spp/pass, traverse + ray sort")
    import numpy as np

    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings

    settings = RenderSettings(width=BW, height=BH, spp_per_pass=1, seed=0)
    r = Renderer(scene, camera, config, settings, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    r.render(1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    r.render(BUNNY_TIMED)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_all_counts()
    msps = BW * BH * BUNNY_TIMED / dt / 1e6
    print(f"warm-up pass {warm:.3f} s; {BUNNY_TIMED} timed passes {dt:.3f} s = "
          f"{dt / BUNNY_TIMED:.4f} s/pass, bunny traverse {msps:.4f} Msamples/s")
    want = config.num_segments * (1 + BUNNY_TIMED)
    print(f"launches: {counts} (expected {want} each of B5 and B6)")
    check(counts["B5"] == want and counts["B6"] == want, f"launches {counts}")
    check(counts["B1"] == counts["B1l"] == counts["B6l"] == 0, f"launches {counts}")
    img = r.film.color.cpu().numpy()
    check(img.shape == (BH, BW, 3) and np.isfinite(img).all(), "bunny film not finite")
    check(img.mean() > 0.0, "bunny film is black")
    png = os.path.join(HERE, "build", "chip_smoke_bunny_1024.png")
    r.save_png(png)
    print(f"film mean {img.mean():.5f}; wrote {os.path.relpath(png, HERE)}")
    return counts, dt / BUNNY_TIMED, msps, r


def bunny_breakdown(torch, camera, config, r, per_pass):
    """Time of one bunny sample, by step of the segment loop: CUDA events
    between the steps, read after one synchronize at the end, so the
    steps queue as in the Renderer's pass and a span holds both the
    step's kernels and any wait of the device for the host's launches.
    Then the device time of one Renderer pass by kernel, whose B5 kernel
    time splits the traverse_select span into the walk and the rest
    (tile lists and launch waits)."""
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW
    from montecarlopathtracer_tpu_torch.ops.morton import DEAD_KEY, ray_sort_keys
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key, stream_uniform

    tables = r.tables
    R = BW * BH
    key = fold_in(fold_in(make_key(0), 0), 0)
    pos, dir_, tput, res, live = camera_wavefront(torch, camera, BW, BH, key)
    dir_ = dir_.contiguous()
    rid = torch.arange(R, device="cuda")
    flags = config.segment_flags("cuda")
    urr = torch.zeros(R, device="cuda")
    names = ("sort + gather", "RNG", "traverse_select", "B6 segment")
    marks = []
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    for seg in range(config.num_segments):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        marks.append(ev)
        ev[0].record()
        keys = torch.where(live, ray_sort_keys(pos, dir_, tables.lo, tables.hi), DEAD_KEY)
        order = torch.argsort(keys, stable=True)
        st = torch.cat([pos, dir_, tput, res, live[None].float(), rid[None].float()])[:, order]
        pos, dir_, tput, res, live, rid = (st[0:3], st[3:6], st[6:9], st[9:12], st[12] > 0.0,
                                           st[13].long())
        ev[1].record()
        u1 = stream_uniform(key, 4 * seg, R, "cuda")[rid]
        u2 = stream_uniform(key, 4 * seg + 1, R, "cuda")[rid]
        ev[2].record()
        idx = TW.traverse_select(tables.rows, tables.clo, tables.chi, pos, dir_, live)
        ev[3].record()
        pos, dir_, tput, res, still = F.rows_segment(tables.rows, idx, pos, dir_, tput, res,
                                                     live, u1, u2, urr, flags[seg])
        ev[4].record()
        live = still > 0.0
    torch.cuda.synchronize()
    ms = {n: [ev[i].elapsed_time(ev[i + 1]) for ev in marks] for i, n in enumerate(names)}
    for n in names:
        print(f"  {n:14s} per segment ms: " + " ".join(f"{x:.3f}" for x in ms[n])
              + f"  (sum {sum(ms[n]):.2f})")
    loop = start.elapsed_time(marks[-1][-1])
    print(f"one sample's segment loop: {loop:.2f} ms (a whole Renderer pass: "
          f"{per_pass * 1e3:.2f} ms); the row gather is inside B6, which reads rows[idx] "
          "itself")
    prof = profile_device(torch, "bunny pass", lambda: r.render(1),
                          {"B5 traverse_select": "traverse_kernel",
                           "B6 rows_segment": "rows_segment_kernel"}, per_pass * 1e3)
    if prof is not None:
        walk = prof["B5 traverse_select"]
        span = sum(ms["traverse_select"])
        print(f"traverse_select spans {span:.2f} ms per sample: B5 kernel {walk:.2f} ms "
              f"(profiled pass), tile lists and launch waits {span - walk:.2f} ms")


def bunny_regen(torch, scene, config):
    w = h = BUNNY_GRAD_W
    phase(f"20b. bunny regen pass: Renderer {w}x{h}, RR, {BUNNY_REGEN_SPP} spp, traverse "
          "(B5 + B6l)")
    import dataclasses

    import numpy as np

    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
    from montecarlopathtracer_tpu_torch.scene.camera import camera_for_scene

    rr = dataclasses.replace(config, mode="rr", rr_depth=5, illum=1.0)
    r = Renderer(scene, camera_for_scene(1, w, h, device="cuda"), rr,
                 RenderSettings(width=w, height=h, spp_per_pass=BUNNY_REGEN_SPP, seed=0,
                                regen=True), device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    r.render(1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_all_counts()
    steps = counts["B6l"]  # one B5 and one B6l launch per step
    print(f"one pass {dt:.3f} s (first, untimed warm-up included), {steps} steps, "
          f"{w * h * BUNNY_REGEN_SPP / dt / 1e6:.4f} Msamples/s; launches {counts}")
    check(0 < steps < BUNNY_REGEN_SPP * rr.num_segments and counts["B5"] == steps
          and counts["B6"] == counts["B1"] == counts["B1l"] == 0,
          f"bunny regen launched {counts}, expected one each of B5 and B6l per step")
    img = r.film.color.cpu().numpy()
    check(np.isfinite(img).all() and img.mean() > 0.0, "bunny regen film")
    return counts


def bunny_grad(torch, scene, config):
    w = h = BUNNY_GRAD_W
    phase(f"21. bunny gradient: value and grad, {w}x{h}, 1 spp, traverse + ray sort")
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.scene.camera import camera_for_scene

    cam = camera_for_scene(1, w, h, device="cuda")
    loss_fn = G.make_loss_fn(scene, cam, torch.zeros(h, w, 3, device="cuda"), width=w,
                             height=h, spp=1, config=config)
    params = G.split_params(scene, ("mat_kd", "mat_ka", "vertices"))
    reset_counts()
    t0 = time.perf_counter()
    G.value_and_grad(loss_fn, params, make_key(7))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(BUNNY_GRAD_ITERS):
        loss, grads = G.value_and_grad(loss_fn, params, make_key(8 + i))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_all_counts()
    msps = w * h * BUNNY_GRAD_ITERS / dt / 1e6
    print(f"warm-up iteration {warm:.3f} s; {BUNNY_GRAD_ITERS} timed iterations {dt:.3f} s "
          f"= {dt / BUNNY_GRAD_ITERS:.4f} s/iteration, bunny fwd+bwd {msps:.4f} Msamples/s "
          f"(loss {float(loss):.6f})")
    want = config.num_segments * (1 + BUNNY_GRAD_ITERS)
    print(f"launches: {counts} (expected {want} each of B5, B6, B2 and B3)")
    for name in ("B5", "B6", "B2", "B3"):
        check(counts[name] == want, f"{name} launched {counts[name]} times, expected {want}")
    for name, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"gradient of {name} is not finite")
        print(f"grad {name}: shape {tuple(g.shape)} max |g| {float(g.abs().max()):.6e}")
    check(float(grads["mat_kd"].abs().max()) > 0.0, "mat_kd gradient is zero")
    check(float(grads["mat_ka"].abs().max()) > 0.0, "mat_ka gradient is zero")
    check(float(grads["vertices"].abs().max()) == 0.0,
          "interior vertex gradient is not exactly zero")
    # One more iteration, untimed and uncounted, that keeps the inputs of
    # the scatter (B3) of the segment whose rays hit most often.
    caught = []

    def catch(idx, d_full, T):
        caught.append((int((idx >= 0).sum()), idx, d_full, T))
        if len(caught) > 1:
            caught.sort(key=lambda c: c[0])
            del caught[0]
        return scatter(idx, d_full, T)

    scatter = F.scatter_rows
    F.scatter_rows = catch
    try:
        G.value_and_grad(loss_fn, params, make_key(7))
    finally:
        F.scatter_rows = scatter
    check(len(caught) == 1, "the bunny gradient made no row scatter")
    return counts, msps, caught[0][1:]


def bunny_scatter(torch, idx, d_full, T):
    phase(f"21b. row scatter kernel (B3) vs plain on the bunny gradient's segment: "
          f"{T:,} triangles x {idx.shape[0]:,} rays, f64 global atomics")
    from montecarlopathtracer_tpu_torch.ops import scatter_rows as S

    # scatter_rows.cu keeps a private f32 table in shared memory when it
    # fits, and adds into an f64 table with global atomics when it does not.
    smem = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    bytes_ = T * 48 * 4
    print(f"table {bytes_:,} B against {smem:,} B of shared memory per block: "
          "the f64 global-atomics path")
    check(bytes_ > smem, "the bunny's row table fits in shared memory")
    worst = scatter_vs_plain(torch, idx, d_full, T,
                             f"{BUNNY_GRAD_W}x{BUNNY_GRAD_W} bunny vjp d_full")
    ms = time_pair(torch, lambda: S.scatter_rows(idx, d_full, T),
                   lambda: S.scatter_rows_ref(idx, d_full, T))
    hits, R = int((idx >= 0).sum()), idx.shape[0]
    ms = (*ms, bound_of(R * 196 + T * 192, hits * 48), library_index_add(torch, idx, d_full, T))
    print(f"scatter_rows kernel {ms[0]:.4f} ms  plain {ms[1]:.4f} ms (median of 10, "
          f"{hits} rays hit of {R}, {T} triangles); bound {ms[2][0]:.4f} ms ({ms[2][1]}); "
          f"one index_add_ {ms[3]:.4f} ms")
    return worst, ms


def bunny_grad_frame(torch):
    phase("22. 64x48 bunny gradient render (subdiv 3): kernel path vs plain path")
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.models import bunny
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
    from montecarlopathtracer_tpu_torch.testing import compare_param_grads, plain_kernels

    w, h = 64, 48
    scene, cam = bunny.bunny_scene(subdiv=3, width=w, height=h, device="cuda")
    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0, intersector="traverse",
                         ray_sort=True)
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
    check(rep["ok"], f"bunny kernel-path gradients disagree with the plain path: {rep}")


# ---------------------------------------------------------------- bounds

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (NVIDIA data sheet)
# f32 operations of one ray-triangle pair test: o' (3 x 6), d' (3 x 5),
# one division, beta and gamma (2 x 2), 1 - (beta + gamma) (2).
PAIR_OPS = 40
STATE_BYTES = 48 + 1 + 12  # pos, dir, tput, res f32[3]; live; u1, u2, urr
SEG_OUT_BYTES = 4 + 48 + 4  # idx, npos/ndir/ntput/nres f32[3], still


def bound_of(nbytes, ops):
    """(bound_ms, bound_by): the least time for ``nbytes`` of device
    memory traffic (each input read once, each output written once) and
    ``ops`` f32 operations at the H100's published rates. Operations
    count the ray-triangle arithmetic only (PAIR_OPS per tested pair, 40
    per recomputed winner, 48 adds per scattered row); the samplers' and
    vjps' arithmetic is left out, so an elementwise kernel's bound is a
    lower bound."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def segment_bound(T, R, live, lane=False, nc=0, pairs=None):
    """Bound of a whole segment (B1, B1l, B1c) on R rays, ``live`` of them
    live, over T triangles: brute selection tests live x T pairs, a
    culling one the ``pairs`` its rays' segments reach."""
    nbytes = T * 192 + R * STATE_BYTES + (12 * R if lane else 12) + nc * 24 + R * SEG_OUT_BYTES
    return bound_of(nbytes, (live * T if pairs is None else pairs) * PAIR_OPS)


def reached_pairs(torch, clo, chi, T, pos, dir_, live, t_best, step=1 << 14):
    """Ray-triangle pairs that culling must test on these rays: for each
    live ray, the triangles of every chunk whose box (widened as the
    kernels widen it) its segment [0, t_best] reaches. The minimum work
    of a culling selection on this data (B1c, B4c, B5)."""
    nc = clo.shape[0]
    sizes = torch.full((nc,), 128.0, device=clo.device, dtype=torch.float64)
    sizes[-1] = T - 128 * (nc - 1)
    m = 1e-5 * (1.0 + torch.maximum(clo.abs(), chi.abs()))
    lo, hi = (clo - m)[None], (chi + m)[None]  # [1, nc, 3]
    total = 0.0
    for s in range(0, pos.shape[1], step):
        o = pos[:, s:s + step].T[:, None, :]
        d = dir_[:, s:s + step].T[:, None, :]
        flat = d.abs() < 1e-12
        inv = 1.0 / torch.where(flat, 1.0, d)
        t0, t1 = (lo - o) * inv, (hi - o) * inv
        inside = (o >= lo) & (o <= hi)
        tn = torch.where(flat, torch.where(inside, -3e38, 3e38), torch.minimum(t0, t1))
        tf = torch.where(flat, torch.where(inside, 3e38, -3e38), torch.maximum(t0, t1))
        tn, tf = tn.amax(dim=2), tf.amin(dim=2)
        reach = (tn <= tf) & (tf >= 0.0) & (tn <= t_best[s:s + step, None]) \
            & live[s:s + step, None]
        total += float((reach.double() @ sizes).sum())
    return total


def winner_t(torch, rows, idx, pos, dir_):
    """f32[R] hit distance of the winners ``idx`` (3e38 for a miss)."""
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F

    return F.recompute_rows(F.gather_rows(rows, idx), idx >= 0, pos, dir_)[0]


def library_index_add(torch, idx, dvals, T):
    """Median ms of one ``index_add_`` computing the row scatter on the
    same inputs (the yardstick of B3; never called by the port)."""
    keep = idx >= 0
    rows = idx[keep].long()
    vals = dvals.T[keep].contiguous()

    def call():
        torch.zeros(T, 48, device="cuda").index_add_(0, rows, vals)

    return time_one(torch, call)


# ------------------------------------------------ the split, cull and fused paths

GW, GH = 800, 600  # the glossy stage's frame
CULL_SPP, CULL_TIMED = 4, 2
SPLIT_TIMED = 2
GEOM_SPP, GEOM_DEPTH, GEOM_EDGES = 2, 2, 4096


def split_builds(libs):
    phase("23. build: the split path's kernels (B4/B4c, B7)")
    from montecarlopathtracer_tpu_torch.ops import cuda_build

    for name, src in (("nearest_shade", SHADE_SOURCE), ("nearest_triangle", TRIANGLE_SOURCE)):
        print(f"built {libs[name].relative_to(HERE)} from {src} (sm_90a)")
        ptxas_report(libs[name])
        cuda_build.load(name)
    print(f"{libs['segment_fused'].relative_to(HERE)} holds B1c (its cull instance):")
    ptxas_report(libs["segment_fused"])


def sorted_bounce(torch, tables, cam_wave, key, config):
    """One fixed-mode segment of ``cam_wave`` through the culling kernel,
    then the wavefront sort of the integrator (dead lanes last)."""
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.morton import DEAD_KEY, ray_sort_keys

    out = F.mega_segment(*seg_args(torch, tables.rows, *cam_wave, key, [0.0, 0.0, 0.0]),
                         **tables.cull_boxes, **config.kernel_options())
    alive = out[5] > 0.0
    keys = torch.where(alive, ray_sort_keys(out[1], out[2], tables.lo, tables.hi), DEAD_KEY)
    order = torch.argsort(keys, stable=True)
    return (*(x[:, order].contiguous() for x in out[1:5]), alive[order].contiguous())


def glossy_setup(torch):
    phase(f"glossy stage: 1,332 triangles in Morton order, {GW}x{GH}")
    from montecarlopathtracer_tpu_torch.models import glossy
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig, scene_tables

    scene, camera = glossy.glossy_steps(width=GW, height=GH, device="cuda")
    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0, chunk_cull=True,
                         ray_sort=True)
    tables = scene_tables(scene, config)
    check(scene.num_triangles == 1332, f"glossy has {scene.num_triangles} triangles")
    key = make_key(24)
    cam = camera_wavefront(torch, camera, GW, GH, key)
    cam = (cam[0], cam[1].contiguous(), *cam[2:])
    bounce = sorted_bounce(torch, tables, cam, key, config)
    print(f"{scene.num_triangles} triangles, {tables.clo.shape[0]} chunks of 128; sorted "
          f"first bounce: {int(bounce[4].sum())} of {GW * GH} rays live")
    return scene, camera, config, tables, (cam, bounce)


def cull_vs_plain(torch, tables, waves):
    phase(f"24. chunk-cull segment (B1c) vs plain and vs B1, glossy {GW}x{GH} camera and "
          "sorted bounce wavefronts")
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.testing import compare_segment

    nc = tables.clo.shape[0]
    worst, identical = 0.0, True
    for wname, wave in zip(("camera", "sorted bounce"), waves):
        R = wave[0].shape[1]
        for cname, (mode, flags) in (("fixed", CASES["fixed fg=0"]),
                                     ("rr", CASES["rr do_rr=1"])):
            for lane in (False, True):
                args = list(seg_args(torch, tables.rows, *wave, make_key(25), flags))
                if lane:
                    args[9] = seeded_lane_flags(torch, R, seed=24 + lane)
                tested = torch.zeros(-(-R // 128), dtype=torch.int32, device="cuda")
                got = F.mega_segment(*args, mode=mode, tested=tested, **tables.cull_boxes)
                torch.cuda.synchronize()
                ref = F.mega_segment_ref(*args, mode=mode)
                rep = compare_segment(ref, got, live=args[5], rows=tables.rows, pos=args[1],
                                      dir_=args[2])
                worst = max([worst, *rep["max_abs_err"].values()])
                b1 = F.mega_segment(*args, mode=mode)  # the same table, every chunk tested
                same = all(torch.equal(x, y) for x, y in zip(got, b1))
                identical &= same
                t = tested.float()
                print(f"{wname:13s} {cname:5s} {'lane' if lane else 'scalar'} flags: idx agree "
                      f"{rep['idx_agree']:.6f} ({rep['n_idx_mismatch']} near-tie mismatches of "
                      f"{rep['n_live']} live), max |err| "
                      + " ".join(f"{k} {v:.2e}" for k, v in rep["max_abs_err"].items())
                      + f"; bit-identical to B1: {same}; chunks tested per block mean "
                      f"{float(t.mean()):.2f} max {int(t.max())} of {nc}")
                check(rep["ok"], f"B1c disagrees with plain on {wname} {cname} lane={lane}: "
                      f"{rep}")
                check(bool(torch.equal(got[0], b1[0])),
                      f"B1c's winners differ from B1's on the same table ({wname} {cname})")
    print(f"tolerance as phase 3; worst |err| {worst:.3e}; B1c bit-identical to B1 on every "
          f"case: {identical}")
    return worst


def shade_vs_plain(torch, rows, ctables, cornell_bounce, gtables, gwaves):
    phase(f"25. split intersectors (B4, B4c) and the fused index (B7) vs plain, Cornell "
          f"{W}x{H} first bounce and glossy {GW}x{GH} camera and sorted bounce")
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
    from montecarlopathtracer_tpu_torch.testing import compare_shade, compare_winners

    worst = {"B4": 0.0, "B4c": 0.0, "B7": 0.0}
    cases = [("Cornell bounce", rows, ctables, cornell_bounce)]
    cases += [(f"glossy {n}", gtables.rows, gtables, w)
              for n, w in zip(("camera", "sorted bounce"), gwaves)]
    for wname, table, ctab, wave in cases:
        pos, dir_, _, _, live = wave
        for name, tab, boxes in (("B4", table, {}), ("B4c", ctab.rows, ctab.cull_boxes)):
            got = NS.nearest_shade_full(tab, pos, dir_, live, **boxes)
            torch.cuda.synchronize()
            want = NS.nearest_shade_full_ref(tab, pos, dir_, live)
            rep = compare_shade(got, want, live=live, rows=tab, pos=pos, dir_=dir_)
            worst[name] = max(worst[name], rep["tbg_max_abs_err"])
            print(f"{wname:21s} {name:3s}: idx agree {rep['idx_agree']:.6f} "
                  f"({rep['n_idx_mismatch']} near-tie mismatches of {rep['n_live']} live); "
                  f"tbg max |err| {rep['tbg_max_abs_err']:.2e} ({rep['tbg_n_beyond_tol']} lanes "
                  f"beyond 1e-5, at most {rep['tbg_worst_ulps']:.2f} x eps32 x scale from f64); "
                  f"shade equal {rep['shade_equal']}")
            check(rep["ok"], f"{name} disagrees with plain on {wname}: {rep}")
        geom = table[:, :12].contiguous()
        got = NS.nearest_triangle(geom, pos, dir_)
        torch.cuda.synchronize()
        want = NS.nearest_triangle_ref(geom, pos, dir_)
        every = torch.ones_like(live)
        rep = compare_winners(got, want, live=every, rows=table, pos=pos, dir_=dir_)
        worst["B7"] = max(worst["B7"], rep["max_t_gap"])
        print(f"{wname:21s} B7 : idx agree {rep['idx_agree']:.6f} ({rep['n_idx_mismatch']} "
              f"near-tie mismatches of {rep['n_live']} rays, max t gap {rep['max_t_gap']:.2e})")
        check(rep["ok"], f"B7 disagrees with plain on {wname}: {rep}")
    print("gate: winners as phase 17's; on agreeing lanes the shading rows equal and t, beta, "
          "gamma within rtol = atol = 1e-5, or within 16 x eps32 x their rounding scale of the "
          "float64 values")
    return worst


def time_split_kernels(torch, rows, cornell_bounce, gtables, gbounce):
    phase("26. B4 and B7 on the Cornell first bounce, B1c and B4c on the glossy sorted "
          "bounce: kernel, plain, and B1 on the same wavefront (median of 10 CUDA events)")
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.rng import make_key

    out = {}
    pos, dir_, _, _, live = cornell_bounce
    T, R, n_live = rows.shape[0], pos.shape[1], int(live.sum())
    args = seg_args(torch, rows, *cornell_bounce, make_key(26), [0.0, 0.0, 0.0])
    b1 = time_one(torch, lambda: F.mega_segment(*args))
    ms = time_pair(torch, lambda: NS.nearest_shade_full(rows, pos, dir_, live),
                   lambda: NS.nearest_shade_full_ref(rows, pos, dir_, live))
    out["B4"] = (*ms, bound_of(T * 192 + R * 25 + R * 148, n_live * T * PAIR_OPS))
    geom = rows[:, :12].contiguous()
    ms = time_pair(torch, lambda: NS.nearest_triangle(geom, pos, dir_),
                   lambda: NS.nearest_triangle_ref(geom, pos, dir_))
    out["B7"] = (*ms, bound_of(T * 48 + R * 24 + R * 4, R * T * PAIR_OPS))
    print(f"Cornell first bounce ({n_live} live of {R} rays, {T} triangles): B1 {b1:.4f} ms; "
          f"B4 {out['B4'][0]:.4f} ms (plain {out['B4'][1]:.4f}); B7 {out['B7'][0]:.4f} ms "
          f"(plain {out['B7'][1]:.4f}, every ray tested)")

    pos, dir_, _, _, live = gbounce
    gr, boxes = gtables.rows, gtables.cull_boxes
    T, R, n_live, nc = gr.shape[0], pos.shape[1], int(live.sum()), gtables.clo.shape[0]
    args = seg_args(torch, gr, *gbounce, make_key(26), [0.0, 0.0, 0.0])
    b1 = time_one(torch, lambda: F.mega_segment(*args))
    ms = time_pair(torch, lambda: F.mega_segment(*args, **boxes),
                   lambda: F.mega_segment_ref(*args))
    idx = F.mega_segment(*args, **boxes)[0]
    pairs = reached_pairs(torch, gtables.clo, gtables.chi, T, pos, dir_, live,
                          winner_t(torch, gr, idx, pos, dir_))
    out["B1c"] = (*ms, segment_bound(T, R, n_live, nc=nc, pairs=pairs))
    ms = time_pair(torch, lambda: NS.nearest_shade_full(gr, pos, dir_, live, **boxes),
                   lambda: NS.nearest_shade_full_ref(gr, pos, dir_, live))
    out["B4c"] = (*ms, bound_of(T * 192 + nc * 24 + R * 25 + R * 148, pairs * PAIR_OPS))
    print(f"glossy sorted bounce ({n_live} live of {R} rays, {T} triangles, {pairs:.4g} of "
          f"{n_live * T} live pairs reachable): B1 {b1:.4f} ms; B1c {out['B1c'][0]:.4f} ms "
          f"(plain {out['B1c'][1]:.4f}); B4c {out['B4c'][0]:.4f} ms (plain "
          f"{out['B4c'][1]:.4f})")
    for name, (k, p, (bms, by)) in out.items():
        print(f"  {name:3s} bound {bms:.4f} ms ({by}): kernel at {bms / k:.3f} of it")
    return out


def cull_main_path(torch, scene, camera, config):
    phase(f"27. cull main path: Renderer glossy {GW}x{GH}, fixed depth {DEPTH} + gather, "
          f"{CULL_SPP} spp/pass, chunk_cull + ray_sort")
    import dataclasses

    import numpy as np

    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.render.integrator import render_sample_batch
    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
    from montecarlopathtracer_tpu_torch.testing import compare_images

    r = Renderer(scene, camera, config,
                 RenderSettings(width=GW, height=GH, spp_per_pass=CULL_SPP, seed=0),
                 device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    r.render(1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    r.render(CULL_TIMED)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_all_counts()
    msps = GW * GH * CULL_SPP * CULL_TIMED / dt / 1e6
    want = config.num_segments * CULL_SPP * (1 + CULL_TIMED)
    print(f"warm-up pass {warm:.3f} s; {CULL_TIMED} timed passes {dt:.3f} s = "
          f"{dt / CULL_TIMED:.4f} s/pass, glossy cull forward {msps:.4f} Msamples/s")
    print(f"launches: {counts} (expected {want} of B1c and no other segment kernel)")
    check(counts["B1c"] == want and counts["B1"] == counts["B1l"] == 0, f"launches {counts}")
    img = r.film.color.cpu().numpy()
    check(np.isfinite(img).all() and img.mean() > 0.0, "glossy film is black or not finite")
    png = os.path.join(HERE, "build", "chip_smoke_glossy_cull.png")
    r.save_png(png)
    print(f"film mean {img.mean():.5f}; wrote {os.path.relpath(png, HERE)}")
    # The frame of one sample against the render without culling, same key.
    got = render_sample_batch(scene, camera, make_key(27), GW, GH, config, r.tables)
    plain = dataclasses.replace(config, chunk_cull=False, ray_sort=False)
    rep = compare_images(got, render_sample_batch(scene, camera, make_key(27), GW, GH, plain))
    print(f"one sample against the render without culling: pixels within 1e-4 "
          f"{rep['pixel_share']:.5f}, max |err| {rep['max_abs_err']:.3e}, mean rel "
          f"{rep['mean_rel']:.2e}")
    check(rep["ok"], f"the cull frame disagrees with the non-cull frame: {rep}")
    # The split path on the same tables: B4c per segment.
    split = dataclasses.replace(config, whole_segment=False)
    rs = Renderer(scene, camera, split,
                  RenderSettings(width=GW, height=GH, spp_per_pass=CULL_SPP, seed=0),
                  device="cuda")
    rs.render(1)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rs.render(1)
    torch.cuda.synchronize()
    sdt = time.perf_counter() - t0
    scounts = read_all_counts()
    print(f"split path with culling (B4c): one timed pass {sdt:.4f} s, "
          f"{GW * GH * CULL_SPP / sdt / 1e6:.4f} Msamples/s; launches {scounts}")
    check(scounts["B4c"] == config.num_segments * CULL_SPP and scounts["B1c"] == 0,
          f"split cull launches {scounts}")
    check(bool(torch.isfinite(rs.film.color).all()), "split cull film not finite")
    return counts, scounts, dt / CULL_TIMED, msps


def split_main_path(torch, scene, camera):
    phase(f"28. split path: Renderer Cornell {W}x{H}, whole_segment=False, {SPP} spp/pass; "
          "then one pass of the fused intersector")
    import numpy as np

    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
    from montecarlopathtracer_tpu_torch.testing import compare_images

    settings = RenderSettings(width=W, height=H, spp_per_pass=SPP, seed=0)
    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0, whole_segment=False)
    r = Renderer(scene, camera, config, settings, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    r.render(1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    r.render(SPLIT_TIMED)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_all_counts()
    msps = W * H * SPP * SPLIT_TIMED / dt / 1e6
    want = config.num_segments * SPP * (1 + SPLIT_TIMED)
    print(f"warm-up pass {warm:.3f} s; {SPLIT_TIMED} timed passes {dt:.3f} s = "
          f"{dt / SPLIT_TIMED:.4f} s/pass, split forward {msps:.4f} Msamples/s")
    print(f"launches: {counts} (expected {want} of B4 and no segment kernel)")
    check(counts["B4"] == want and counts["B1"] == counts["B4c"] == 0, f"launches {counts}")
    img = r.film.color
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0, "split film")
    whole = Renderer(scene, camera, TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0),
                     settings, device="cuda")
    whole.render(1 + SPLIT_TIMED)
    rep = compare_images(img, whole.film.color)
    print(f"film against the whole-segment film of the same passes: pixels within 1e-4 "
          f"{rep['pixel_share']:.5f}, max |err| {rep['max_abs_err']:.3e}, mean rel "
          f"{rep['mean_rel']:.2e}")
    check(rep["ok"], f"the split film disagrees with the whole-segment film: {rep}")
    fused = Renderer(scene, camera, TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0,
                                                intersector="fused"), settings, device="cuda")
    fused.render(1)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fused.render(1)
    torch.cuda.synchronize()
    fdt = time.perf_counter() - t0
    fcounts = read_all_counts()
    print(f"fused intersector: one timed pass {fdt:.4f} s, {W * H * SPP / fdt / 1e6:.4f} "
          f"Msamples/s; launches {fcounts}")
    check(fcounts["B7"] == config.num_segments * SPP and fcounts["B4"] == 0,
          f"fused launches {fcounts}")
    check(np.isfinite(fused.film.color.cpu().numpy()).all(), "fused film not finite")
    return counts, fcounts, dt / SPLIT_TIMED, msps, fdt


def split_grad(torch, scene, camera):
    phase(f"29. split-path gradient: value and grad, {W}x{H}, {GRAD_SPP} spp, against the "
          "whole-segment gradient of the same key")
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
    from montecarlopathtracer_tpu_torch.testing import compare_param_grads

    fields = ("mat_kd", "mat_ka", "vertices")
    target = torch.zeros(H, W, 3, device="cuda")
    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0, whole_segment=False)
    loss_fn = G.make_loss_fn(scene, camera, target, width=W, height=H, spp=GRAD_SPP,
                             config=config)
    params = G.split_params(scene, fields)
    G.value_and_grad(loss_fn, params, make_key(29))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    loss, grads = G.value_and_grad(loss_fn, params, make_key(29))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_all_counts()
    want = config.num_segments * GRAD_SPP
    print(f"one iteration {dt:.4f} s, split fwd+bwd {W * H * GRAD_SPP / dt / 1e6:.4f} "
          f"Msamples/s (loss {float(loss):.6f}); launches {counts} (expected {want} of B4 "
          "and of B3)")
    check(counts["B4"] == want and counts["B3"] == want and counts["B2"] == 0,
          f"split gradient launches {counts}")
    whole = G.make_loss_fn(scene, camera, target, width=W, height=H, spp=GRAD_SPP,
                           config=TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0))
    wloss, wgrads = G.value_and_grad(whole, params, make_key(29))
    rep = compare_param_grads(wgrads, grads, 1e-4)
    print(f"loss {float(loss):.7f} vs whole {float(wloss):.7f}; "
          + " ".join(f"{k} max |err| {v['max_abs_err']:.3e} of {v['scale']:.3e}"
                     for k, v in rep.items() if k != "ok")
          + " (tolerance 1e-4 x (|ref| + max |ref|))")
    check(rep["ok"] and abs(float(loss) - float(wloss)) <= 1e-5 * abs(float(wloss)),
          f"split-path gradients disagree with the whole segment's: {rep}")
    return counts, dt


def geometry_step(torch):
    phase(f"30. geometry step (BASELINE config 5): lamp translation at {W}x{H}, fixed depth "
          f"{GEOM_DEPTH}, {GEOM_SPP} spp, {GEOM_EDGES} edge samples, split path (B4)")
    from montecarlopathtracer_tpu_torch.diff.boundary import make_translation_problem
    from montecarlopathtracer_tpu_torch.models import cornell
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key
    from montecarlopathtracer_tpu_torch.render.integrator import (
        TraceConfig,
        render_sample_batch,
    )

    scene, camera = cornell.cornell_box(width=W, height=H, device="cuda")
    config = TraceConfig(mode="fixed", max_depth=GEOM_DEPTH, whole_segment=False)
    emit = (scene.mat_ka > 0).any(dim=1).nonzero()[:, 0]
    tri_mask = torch.isin(scene.tri_mat.long(), emit).cpu().numpy()
    with torch.no_grad():
        target = sum(render_sample_batch(scene, camera, fold_in(make_key(123), i), W, H,
                                         config) for i in range(GEOM_SPP)) / GEOM_SPP
    step = make_translation_problem(scene, camera, tri_mask, target, width=W, height=H,
                                    spp=GEOM_SPP, config=config, n_edge_samples=GEOM_EDGES)
    th, h = torch.tensor([1.2, 0.0, 0.0], device="cuda"), 0.05
    step(th, make_key(0))  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, g = step(th, make_key(0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_all_counts()
    lp, _ = step(th + torch.tensor([h, 0.0, 0.0], device="cuda"), make_key(0))
    lm, _ = step(th - torch.tensor([h, 0.0, 0.0], device="cuda"), make_key(0))
    fd = float((lp - lm) / (2 * h))
    gx = float(g[0])
    print(f"one step {dt:.4f} s (render {GEOM_SPP} spp + {2 * GEOM_EDGES} probe rays); "
          f"launches {counts}; loss {float(loss):.6e}, grad {g.tolist()}")
    print(f"d loss / d theta_x: boundary estimate {gx:.6e}, central difference (h {h}) "
          f"{fd:.6e}; |diff| {abs(gx - fd):.3e} against the bound "
          f"{0.35 * max(abs(fd), 0.05):.3e} (0.35 x max(|fd|, 0.05))")
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(g).all()),
          "geometry loss or gradient not finite")
    check(counts["B4"] > 0 and counts["B1"] == 0, f"geometry step launches {counts}")
    check(abs(gx - fd) < 0.35 * max(abs(fd), 0.05), f"boundary gradient {gx} vs FD {fd}")
    # For the record: the JAX package's weighting, the one pixel floor(s)
    # (ROADMAP C8), on the same key.
    from montecarlopathtracer_tpu_torch.diff import boundary as B

    def one_pixel(image_grad, camera, sx, sy):
        h, w = image_grad.shape[:2]
        return image_grad[sy.floor().long().clamp(0, h - 1),
                          sx.floor().long().clamp(0, w - 1), :].T

    footprint, B._footprint_grad = B._footprint_grad, one_pixel
    try:
        g1 = float(step(th, make_key(0))[1][0])
    finally:
        B._footprint_grad = footprint
    print(f"g / fd: {gx / fd:.4f} with the pixel footprint; {g1 / fd:.4f} with the JAX "
          f"package's one-pixel weighting ({g1:.6e})")
    return counts, dt


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
        b1_timing = time_segment(torch, rows, bounce)
        launches, per_pass, msps = main_path(torch, scene, camera)
        breakdown(torch, scene, camera, per_pass)
        whole_frame(torch, scene)
        grad_builds(libs)
        bwd_err, (idx, d_full) = backward_vs_plain(torch, rows, bounce)
        phase("9. row scatter kernel (B3) vs plain, 652 triangles x 480,000 rays")
        check(rows.shape[0] == 652 and idx.shape[0] == W * H,
              f"T {rows.shape[0]}, R {idx.shape[0]}")
        sc_err = scatter_vs_plain(torch, idx, d_full, rows.shape[0],
                                  "800x600 segment vjp d_full")
        bwd_ms, sc_ms = time_backward(torch, rows, bounce)
        counts, per_iter, grad_msps = grad_main_path(torch, scene, camera)
        sgd_steps(torch, scene, camera)
        grad_frame(torch, scene)
        regen_builds(libs)
        lane_err, lane_ms = lane_vs_plain(torch, rows, bounce)
        regen_counts, regen_msps, regen_steps = regen_main_path(torch, scene, camera)
        del idx, d_full
        bscene, bcam, bconfig, tables = bunny_setup(torch)
        waves = bunny_waves(torch, bcam, bconfig, tables)
        g = torch.Generator(device="cuda").manual_seed(17)
        sub = torch.randperm(BW * BH, device="cuda", generator=g)[:SUBSET].sort().values
        b5_err = traverse_vs_plain(torch, tables, waves, sub)
        b6_err, b_idx, b_draws, b6_cases = rows_vs_plain(torch, tables, waves[1])
        b5_ms, b6_ms, b1_ms = time_bunny(torch, tables, waves[1], sub, b_idx, b_draws,
                                         b6_cases)
        del waves, b_idx, b_draws, b6_cases
        bunny_counts, bunny_per_pass, bunny_msps, brenderer = bunny_main_path(
            torch, bscene, bcam, bconfig)
        bunny_breakdown(torch, bcam, bconfig, brenderer, bunny_per_pass)
        bregen_counts = bunny_regen(torch, bscene, bconfig)
        bgrad_counts, bgrad_msps, bgrad_scatter = bunny_grad(torch, bscene, bconfig)
        bsc_err, bsc_ms = bunny_scatter(torch, *bgrad_scatter)
        del bgrad_scatter, bscene, brenderer, tables
        bunny_grad_frame(torch)
        split_builds(libs)
        from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig, scene_tables

        gscene, gcam, gconfig, gtables, gwaves = glossy_setup(torch)
        b1c_err = cull_vs_plain(torch, gtables, gwaves)
        ctables = scene_tables(scene, TraceConfig(chunk_cull=True))
        shade_err = shade_vs_plain(torch, rows, ctables, bounce, gtables, gwaves)
        split_ms = time_split_kernels(torch, rows, bounce, gtables, gwaves[1])
        del gwaves, ctables
        cull_counts, cull_split_counts, cull_per_pass, cull_msps = cull_main_path(
            torch, gscene, gcam, gconfig)
        split_counts, fused_counts, split_per_pass, split_msps, fused_s = split_main_path(
            torch, scene, camera)
        split_grad_counts, split_grad_s = split_grad(torch, scene, camera)
        geom_counts, geom_s = geometry_step(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"\nmain path: {per_pass:.4f} s/pass, {msps:.4f} Msamples/s forward; "
          f"gradient path: {per_iter:.4f} s/iteration, {grad_msps:.4f} Msamples/s fwd+bwd")
    print(f"RR regen (Cornell {W}x{H}, {REGEN_SPP} spp/pass): {regen_msps:.4f} Msamples/s, "
          f"{regen_steps:.1f} steps/pass; bunny traverse ({BW}x{BH}, depth {DEPTH} + 1, "
          f"1 spp): {bunny_msps:.4f} Msamples/s; bunny fwd+bwd ({BUNNY_GRAD_W}x"
          f"{BUNNY_GRAD_W}, 1 spp): {bgrad_msps:.4f} Msamples/s; on {smi}")
    print(f"glossy cull ({GW}x{GH}, {CULL_SPP} spp/pass): {cull_msps:.4f} Msamples/s; split "
          f"path (Cornell {W}x{H}, {SPP} spp/pass): {split_msps:.4f} Msamples/s, fused pass "
          f"{fused_s:.4f} s; split fwd+bwd {split_grad_s:.4f} s/iteration "
          f"({split_grad_counts}); geometry step {geom_s:.4f} s ({geom_counts})")

    def entry(name, source, replaces, launches, err, timing, **extra):
        ms, plain_ms, (bound_ms, bound_by), *lib = timing
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib[0] if lib else None, **extra}

    print(json.dumps({"kernels": [
        entry("mega_segment", KERNEL_SOURCE, REPLACES, launches, max_err, b1_timing),
        entry("mega_segment (lane flags, B1l)", KERNEL_SOURCE, LANE_REPLACES,
              regen_counts["B1l"], lane_err, lane_ms),
        entry("segment_backward", BWD_SOURCE, BWD_REPLACES, counts["B2"], bwd_err, bwd_ms),
        entry("scatter_rows (shared-memory table, T = 652)", SCATTER_SOURCE,
              SCATTER_REPLACES, counts["B3"], sc_err, sc_ms),
        entry("scatter_rows (f64 global atomics, T = 81,932)", SCATTER_SOURCE,
              SCATTER_REPLACES, bgrad_counts["B3"], bsc_err, bsc_ms),
        entry("traverse_select (B5)", TRAVERSE_SOURCE, TRAVERSE_REPLACES,
              bunny_counts["B5"], b5_err, b5_ms, max_t_gap_on_near_ties=b5_err,
              rays=BW * BH, plain_rays=SUBSET),
        entry("rows_segment (B6)", ROWS_SOURCE, ROWS_REPLACES, bunny_counts["B6"],
              b6_err["B6"], b6_ms["B6"]),
        entry("rows_segment (lane flags, B6l)", ROWS_SOURCE, ROWS_LANE_REPLACES,
              bregen_counts["B6l"], b6_err["B6l"], b6_ms["B6l"]),
        entry("mega_segment (chunk cull, B1c)", KERNEL_SOURCE, CULL_REPLACES,
              cull_counts["B1c"], b1c_err, split_ms["B1c"]),
        entry("nearest_shade_full (B4)", SHADE_SOURCE, SHADE_REPLACES, split_counts["B4"],
              shade_err["B4"], split_ms["B4"]),
        entry("nearest_shade_full (chunk cull, B4c)", SHADE_SOURCE, SHADE_CULL_REPLACES,
              cull_split_counts["B4c"], shade_err["B4c"], split_ms["B4c"]),
        entry("nearest_triangle (B7)", TRIANGLE_SOURCE, TRIANGLE_REPLACES,
              fused_counts["B7"], shade_err["B7"], split_ms["B7"],
              max_t_gap_on_near_ties=shade_err["B7"]),
    ]}))
    print(f"bunny gradient launches: {bgrad_counts}; brute B1 on the bunny wavefront "
          f"{b1_ms[0]:.4f} ms")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
