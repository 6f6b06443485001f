#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (montecarlopathtracer_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. environment: torch/CUDA versions, the GPU (compute capability 9.0
   required), nvcc, and nvidia-smi's name and power limit;
2. build: compile every csrc/*.cu of the port (ten sources) with nvcc
   for sm_90a, one nvcc process each, all started together;
2b. the uniform draws (rng.cu, threefry-2x32, one launch per draw of 1-4
   streams) against their plain version (torch ops) bit for bit at
   R = 480,000 and 1,048,576 for 1-3 streams, and against the CPU's plain
   draws; timed, with its bound (bytes, and its integer operations at
   the H100's INT32 rate);
2c. the same kernel drawing under a key staged on the card (ops/rng.py's
   DeviceKey, the words a CUDA graph's draws read at replay), with 0-3
   host words folded in on the card, 2-4 streams at R = 480,000 (the
   segment loop's R): bit-equal to the plain draws of the host key, one
   launch a call, counters zeroed just before;
3. the segment kernel against its plain-torch version on the card, on
   64x48 camera rays and a full 800x600 wavefront of first-bounce rays,
   in fixed mode (final gather off and on) and RR mode (roulette, hard
   kill), with the tolerances of montecarlopathtracer_tpu_torch.testing;
   and B1's winners (idx, and t recomputed from them) bit-equal to those
   of B4 (nearest_shade.cu, the same selection loop without the
   epilogue) on the same rays, and B4's with the |d'_z| test to those of
   the control (nearest_triangle.cu's one-ray-per-thread loop without the
   sphere rejection);
4. one 800x600 segment timed, kernel and plain (median of CUDA events),
   and the kernel's device time per launch beside the previous design's;
   its bound counts the sphere test on every live pair and the exact
   test on the pairs inside the spheres (counted on the same inputs);
5. the main path: Renderer at 800x600, fixed depth 7, 4 spp/pass, one
   warm-up and three timed passes, with the launch counts of B1 and of
   the RNG (one per sample's jitter pair, one per segment's u1, u2) and
   checks on the film, a profile of one pass; then a per-segment time
   breakdown of one sample (B1 against its one RNG launch);
6. a 160x120 frame at 1 spp, kernel against plain path, same key;
7. the gradient path's kernels (segment_backward.cu, scatter_rows.cu):
   their builds and ptxas reports (B2's registers and spills);
8. the segment vjp kernel (B2), reading each lane's row through the
   winner index (segment_backward_rows), against its plain version on
   the 800x600 first-bounce wavefront of phase 3, seeded random
   cotangents on all four outputs, in fixed mode (final gather off and
   on), RR mode (roulette on tied grey throughput, hard kill) and classic
   Phong; and bit-equal there to segment_backward on the gathered rows
   (JAX's contract, the same kernel over the gathered copy);
9. the row scatter kernel (B3) against its plain version, 652 triangles,
   480,000 rays, on phase 8's row cotangents and on N(0,1) ones, each
   entry held to its own rounding bound, and two calls bit-equal;
10. one 800x600 segment's B2 and B3 timed against their plain versions,
    with their device times and index_add_'s (zero-fill included); then
    B3 at the inverse cell's shape (the published box's T = 32 rows,
    R = 480,000, the cotangents of one eager step of the cell, 4 spp,
    caught at each of its 32 calls): its small-table path against its
    sort path on the same inputs, each within its rounding bound of the
    exact sums and bit-equal across two calls, the step's 32 calls timed
    through both beside their 28-us byte floor a call, and both paths
    timed on the same cotangents spread over T = 64 and 128 rows (the
    times that set T_SMALL); the B3s launches counted;
11. the gradient main path (bench.py's fwd+bwd): value and gradient of
    an L2 pixel loss at 800x600, 2 spp, fixed depth 7, params
    {mat_kd, mat_ka, vertices}; one warm-up and three timed iterations,
    launch counts of all three kernels, checks on the gradients, and a
    profile of one iteration;
12. five SGD steps at 800x600, 1 spp, Kd started at 0.6x: the loss falls
    (the steps replay the loss's CUDA graphs);
12b. the inverse cell's step: make_adam_step at 800x600, 4 spp, fixed
    depth 7, over the red row of Kd, its loss captured as CUDA graphs at
    the first step; a later step's loss bit-equal to value_and_grad of the
    eager loss under the same key, Adam's moments and the moved row to
    the update from the eager gradient (rtol 1e-6), the other rows
    untouched, and B1, B2, B3 and RNG counted as the replay's launches;
13. a 64x48 gradient render, kernel path against plain path, same key;
14. the regen and traversal paths' kernels (traverse_select.cu,
    rows_segment.cu, regen_pass.cu): their builds and ptxas reports;
15. the segment kernel with per-lane flags (B1l) against its plain
    version on phase 3's 800x600 first-bounce wavefront, flags drawn per
    lane from a seed (final gather, roulette and hard kill mixed), fixed
    and RR mode, with the segment gate and its winners bit-equal to B4's;
    B1l timed against plain, with its device time;
16. the regen main path: Renderer on the Cornell box, RR (rr_depth 5,
    illum 1), 800x600, 32 spp per pass, regen; one warm-up and two timed
    passes, each exactly one launch of the regen pass kernel B1r (no B1l,
    no draw), the film mean held against a 32-spp scan render within 5
    standard errors, a profile; then regen against the scan's time at 16
    and 32 spp/pass;
16b. B1r (regen_pass.cu: one launch, a persistent grid whose slots pull
    lanes from a work list) against the host loop with B1l
    (ops/regen_pass.py::regen_pass_ref on the card) at 800x600: the
    Cornell box RR (rr_depth 5) at 32 spp, fixed depth 7 at 16 spp, and
    the glossy stage with chunk_cull (B1r's culled instance, B1rc) at 16
    spp. The kernel's camera formula in torch ops bit-equal to
    Camera.generate_rays_soa on the card under the card's division rule;
    per configuration: render_regen_planar launches B1r (or B1rc) once and
    nothing else, every lane's accum and lane_steps bit-equal to the host
    loop's, the kernel's counters (blocks, block-steps, slot-steps, live
    lane-steps, the card's clock at list spent and end), its live share
    beside that of pinned blocks (lane i held by block i // 256 until its
    last lane is done, the earlier design) from the same lane_steps, the
    live lane-steps equal to the lanes' steps, no lane-step over the
    staged spheres' origin bound (overflow 0); the launch again with its
    list handed out longest first by its own lane_steps (the Renderer's
    order from its second pass on; more lanes than slots, so slots take
    lanes from the ordered list after their first), every lane's accum
    and lane_steps bit-equal to the host loop's; bit-equal to the scan at 1
    spp, the film mean within 5 standard errors of the scan's, the pass in
    turns with the host loop (and, for RR, a profile of each: the host
    loop's B1l and draws against B1r), its device time per pass (queued
    events), and its bound (the pairs that the host loop's steps must
    test, counted on each step's wavefront as phases 10 and 15 count B1c's
    and B1l's: every live ray x T, or with culling the chunks each ray's
    segment reaches, at 17 operations, and 40 more for each pair inside a
    sphere; with culling also the vote's chunks per live lane-step, this
    kernel's against the pinned groups'); the plain version's pass (every
    kernel plain) timed and held to the kernel's frame, for both
    instances; then the glossy stage unculled (1332 rows, above kWholeMax:
    select_two's ring inside the pass) at 4 spp, every lane bit-equal to
    the host loop, with its device time;
17. the traversal walk (B5) on the 81,932-triangle bunny: its tables
    (tree and triangle records, built by traverse_select.cu's
    traverse_tables_launch in one launch of a warp per leaf, B5t) against
    their plain version, bit-equal to the earlier two-kernel build (and on
    the hard soups at T = 1, 20, 70, 1500) with the tree equal to tree_ref
    over its own leaves, and their build time beside the earlier build's
    two kernels timed apart; then a 1024x1024 camera wavefront and its sorted bounce
    wavefront with dead lanes: B5's winners (idx, and t recomputed)
    bit-equal to B4's (every triangle) on every lane, and against the
    plain brute selection on a seeded subset of 65,536 rays (winners on
    >= 99.9% of live lanes, mismatches near-ties on which the brute CUDA
    kernel B1 sides with B5); nodes and leaves per ray (mean, p99);
18. the segment from known winners (B6, and B6l with per-lane flags)
    against its plain version on the bunny's bounce wavefront;
19. B5, B6 and the brute B1 timed on that 1024x1024 wavefront (median of
    10 CUDA events, and device times), with their plain versions (B5's
    and B1's on the subset); B5's bound counts the sphere and exact tests
    of the leaves each ray reaches on the subset, scaled by live rays,
    beside the old count (every pair of the reached 128-triangle chunks);
    then B5 with leaves of 16, 32 and 64 triangles, and on its 1,024
    longest walks alone;
20. the bunny main path: Renderer 1024x1024, fixed depth 7 + final
    gather, 1 spp per pass, traverse + ray sort; one warm-up and two
    timed passes, launch counts (the Renderer's tables build included),
    and a per-step breakdown of one sample (sort + gather, RNG,
    traverse_select, B6; a profile splits B5's kernel from the wrapper's
    host work); then a regen pass on the same path at 512x512, RR, 4 spp
    (B5 + B6l);
21. the bunny gradient: value and grad at 512x512, 1 spp, params
    {mat_kd, mat_ka, vertices}, launch counts of B5, its tables, B6, B2
    and B3;
    21b: the row scatter (B3) of that gradient's segment with the most
    hits, 81,932 triangles x 262,144 rays (two passes of its sort),
    against its plain version on those cotangents and on N(0,1) ones,
    two calls bit-equal, and timed with its device time and
    index_add_'s;
22. a 64x48 bunny gradient render (subdiv 3), kernel path against plain
    path;
23. the split path's kernels (nearest_shade.cu: B4 and its cull instance
    B4c; nearest_triangle.cu: B7, on the same selection loop, and its
    control) and B1c (segment_fused.cu's cull instance): ptxas reports;
24. B1c against its plain version (brute selection on the Morton-ordered
    table) on the glossy stage's 800x600 camera wavefront and its sorted
    first bounce with dead lanes, fixed and RR, scalar and per-lane
    flags (the segment gate), and against B1 on the same table (the same
    outputs); B1c's winners and chunks tested per group of 128 rays equal
    to B4c's, B1's winners to B4's; the chunk boxes are widened by their
    slack (ops/cull.py, ROADMAP C15); B1c and B4c run the culled loop
    (`sphere_select.cuh::select_culled`: a vote per warp, nearest chunk
    first, the records of B4r, leaf boxes of 16 triangles);
25. B4, B4c and B7 against their plain versions on phase 3's Cornell
    800x600 first bounce and the glossy wavefronts: winners with the
    near-tie allowance, shading rows equal, t, beta, gamma to 1e-5 or
    within 16 x eps32 x their rounding scale of the float64 values; B7's
    and B4's with the |d'_z| test bit-equal to the control loop's;
26. B1c, B4, B4c, B7 and the control timed (median of 10 CUDA events, and
    device times) beside their plain versions, B1 on the same wavefront
    and the earlier run's figures; B4's, B4c's and B7's bounds count their
    sphere and exact tests as B1's do; B1c's and B4c's chunks tested per
    group of 128 rays beside the earlier run's;
    26b: the culled loop's records (B4r) against their plain version
    (geometry equal, NaN and inf where plain has them, the rest within
    1e-4 x (1 + |plain|)), timed;
    26c: the culled loop's visits (ops.cull.cull_visits, each leaf's
    winners from B4): chunks tested per live ray under seven rules, from
    a vote per block of 256 rays to each lane alone and the floor, and
    the leaves tested under the kernels' rule, on the glossy camera and
    sorted bounce over the 1,332-row table and the entries' 1,408-row
    one, with B4c's tested counts equal to the emulation of its rule;
    B4c and B1c bit-equal to B4 (and B4c's tested and the emulation's
    winners to the emulation's and B4's) on the twelve hard soups in
    Morton order at T = 700 and 1500 and on the tie soup;
27. the cull main path: Renderer on the glossy stage, 800x600, fixed
    depth 7 + gather, 4 spp/pass, chunk_cull + ray_sort, one warm-up and
    two timed passes, B1c launches (and one records build B4r), a profile
    of one pass (device-busy share); one sample against the render
    without culling; then one pass of the same path split (B4c);
28. the split path against the whole segment (tools/wseg_check.py::forward,
    the check of the wseg_check twin): Renderer on the Cornell box,
    800x600, 4 spp/pass, whole_segment=False then True over the same
    passes, B4 and B1 launches, the two films compared; one pass of the
    fused intersector (B7);
29. the split-path gradient (tools/wseg_check.py::gradient): value and
    grad at 800x600, 2 spp, {mat_kd, mat_ka, vertices}, through the split
    path and the whole segment on the same keys, B4, B1, B2 and B3
    launches, the gradients compared;
30. the geometry step (BASELINE config 5): make_translation_problem on
    the Cornell lamp at 800x600, fixed depth 2, 2 spp, 4096 edge samples,
    split path: loss and gradient finite, the gradient against a central
    difference of the same-key loss (0.35 x max(|fd|, 0.05)), time per
    step;
31. the selection microkernels (selection_micro.cu: B12, B13, B14): their
    ptxas report, and B12's tensor-core instructions (HMMA), global
    stores and local-memory traffic counted in cuobjdump's SASS; the g++
    build of the native host library
    (native/mcpt_native.cpp) and the Cornell box's KD tree, native build
    bit-equal to the Python one;
32. B4 on phase 3's Cornell 800x600 first bounce over the table padded
    with the JAX package's all-zero rows (652 + 116 = 768, which the tile
    ring takes), over as many of its rows as the loop stages whole
    (nearest_shade_whole_max) and unpadded: bit-equal outputs, device times side by side, and the
    exact tests on the padding rows under the earlier rule and now (none:
    they fail the sphere test); then the superseded selection entries
    B8-B11 (thin entries over B4 and B4c) against their plain versions on
    that bounce and, for the culling forms, the glossy sorted bounce with
    dead lanes (the phase 25 gate), and B10c and B11 bit-equal to B4 (B11
    with the |d'_z| test) over the same rows; timed beside their plain versions,
    with their device times beside the earlier run's and the device time
    of B8-B10's own torch ops (their layouts unpacked into B4's table);
    B8-B10's device times once more, three interleaved rounds;
33. the intersector gate of tools/tpu_check.py: B8, B10, B10 with cull,
    B11, the fused index and the KD walk against the brute oracle on its
    4,096 camera and 4,096 random rays (compare_winners, t within 1e-4);
34. the tool twins, the main path of B8-B10 and B12-B14:
    tools.kernel_bench (Cornell and the bunny, 480,000 rays, each entry
    timed) and tools.kernel_micro (R = 491,520, T = 768; B13's p_all is
    9.06 GB), with their launch counts; then each tool's own outputs
    against the plain versions on the same inputs: B8-B10 on 16,384 of
    kernel_bench's rays per scene (compare_shade), B12-B14 on all
    491,520 rays (B12 by testing.compare_micro's rounding rule, with its
    near-tie and boundary counts; B13 and B14 bit for bit), the plain
    versions timed at that size; B14's floor in shared memory (24 B a
    pair at 128 B/clk/SM) beside its 12-operation bound and the L2 rate
    of the earlier run's loop; and cuBLAS's bf16 product (torch.mm, in
    slices of rays, f32 out and bf16 out) with a column min beside B12's
    matmul_only and matmul_bf16;
35. the KD-tree main path: one walk of the Cornell 800x600 first bounce
    timed, then Renderer at 800x600, fixed depth 7 + gather, 1 spp per
    pass, intersector="kdtree": one warm-up and one timed pass, the film
    against the whole-segment film of the same passes;
36. the sharded paths (montecarlopathtracer_tpu_torch.parallel), each on
    phase 5's scene at 800x600, fixed depth 7 + gather, megakernel whole
    segment, with the card's name and power limit on every line: world
    size 1 under NCCL in this process (36a-e), then two gloo ranks
    spawned on cuda:0 (36f; NCCL refuses two ranks on one device).
    36a: sharded_sample_pass at 4 spp bit-equal to the mean of
    render_rows_planar over fold_in(fold_in(key, 0), s), 32 B1 and 36 RNG
    launches, timed in turns with phase 5's Renderer pass (the SPMD
    overhead at world size 1); 36b: make_progressive_step twice, weight
    8, the film bit-equal to two film_updates of those passes; 36c:
    make_train_step at 2 spp on {mat_kd, mat_ka, vertices} against one
    process's value_and_grad + SGD on the same sample keys
    (compare_param_grads at 1e-6, the loss to 1e-6), B1, B2, B3 launches;
    36d: sharded_regen_pass, RR, 32 spp, bit-equal to
    render_regen_planar(y0=0, n_rows=600) under fold_in(key, 0), one
    B1r launch; 36e: make_geom_train_step at phase 30's settings against
    its single-process emulation (testing.emulate_geom_step) with the
    same probe key, B4 launches; 36f: sharded_sample_pass at meshes (2,1)
    and (1,2) and make_train_step at (2,1) on the two ranks, the gathered
    frames, loss and parameters bit-equal to the parent's emulation of
    the two ranks. One card cannot measure scaling.

37. the bench twin (python -m montecarlopathtracer_tpu_torch.bench) at full
    size in this process: its one JSON line printed beside the card's
    name and power limit, every key of bench.py's line present and
    finite, the launches of B1, B2, B3 (forward and fwd+bwd), RNG and B1r
    (regen: one a pass, phase 16's three passes on the same keys) exactly
    as counted; then under BENCH_INTERSECTOR=brute at 160x120, which must
    run to its end without rr_regen_msamples_s (ROADMAP C1);
38. the suite twin (tools/bench_suite.py --quick), every row, in a
    temporary directory: every row OK, each path's kernel launched, the
    rows printed; the kernels' JSON line
    carries each kernel's launches summed over the rows
    (``launches_suite``) and in phase 37 (``launches_bench``);
39. the CLI's automatic choices: cli.main with the defaults on
    cornell-full, glossy and bunny at 64x48, its printed choices equal to
    cli.resolve_choices of the scene's triangle count, and the chosen
    kernel launched; then the bunny's 1024x1024 traverse pass with and
    without the wavefront sort, in turns (the rows behind the
    ``--ray-sort auto`` rule for the walk);
40. the NaN guard: every output of every segment finite on the Cornell
    800x600 camera wavefront in fixed and RR mode (B1 and the draws), the
    160x120 value and gradient under torch.autograd.detect_anomaly, and
    one 1024x1024 traverse pass of bunny_scene(glossy=True) with a
    finite, non-black film.

A kernel's device time per launch comes from CUDA events around 20
back-to-back calls queued behind a torch.cuda._sleep, so that the card,
not the host, sets their pace (median of three such spans, over 20); the
event pair around one call, which includes the wrapper's host work, is
kept beside it, and beside both the figures of this script's earlier run
on the same phase. Every kernel line carries its bound: the least time for its bytes (each
input read once, each output written once, 3.35 TB/s) and its
operations at the rate of their type, the H100 SXM's published rates:
f32 (67 TFLOP/s), and for B12's contraction of bf16 inputs the bf16
tensor cores (989 TFLOP/s), where the kernel runs it.

Prints one JSON line of per-kernel numbers, then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

import contextlib
import io
import json
import math
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
# B5's tables take the place of the TPU walk's per-tile chunk lists.
TABLES_REPLACES = "montecarlopathtracer_tpu/ops/traverse_pallas.py:87"
# B4r, the culled loop's triangle records, take the place of the TPU culled
# kernels' per-table streamed packing (pack_transforms_stream).
RECORDS_REPLACES = "montecarlopathtracer_tpu/ops/intersect_pallas.py:673"
ROWS_SOURCE = f"{PKG}/csrc/rows_segment.cu"
ROWS_REPLACES = "montecarlopathtracer_tpu/ops/segment_fused.py:911"
ROWS_LANE_REPLACES = "montecarlopathtracer_tpu/ops/segment_fused.py:991"
CULL_REPLACES = "montecarlopathtracer_tpu/ops/segment_fused.py:570"
SHADE_SOURCE = f"{PKG}/csrc/nearest_shade.cu"
SHADE_REPLACES = "montecarlopathtracer_tpu/ops/intersect_pallas.py:1006"
SHADE_CULL_REPLACES = "montecarlopathtracer_tpu/ops/intersect_pallas.py:1297"
TRIANGLE_SOURCE = f"{PKG}/csrc/nearest_triangle.cu"
TRIANGLE_REPLACES = "montecarlopathtracer_tpu/ops/intersect_pallas.py:173"
# B8-B11: the superseded selection entries, over nearest_shade.cu (B4, B4c).
VARIANT_REPLACES = {
    "B8": "montecarlopathtracer_tpu/ops/intersect_pallas.py:319",
    "B9": "montecarlopathtracer_tpu/ops/intersect_pallas.py:605",
    "B10": "montecarlopathtracer_tpu/ops/intersect_pallas.py:775",
    "B10c": "montecarlopathtracer_tpu/ops/intersect_pallas.py:950",
    "B11": "montecarlopathtracer_tpu/ops/intersect_pallas.py:1766",
}
MICRO_SOURCE = f"{PKG}/csrc/selection_micro.cu"
MICRO_REPLACES = {
    "full": "tools/kernel_micro.py:167", "matmul_only": "tools/kernel_micro.py:105",
    "matmul_bf16": "tools/kernel_micro.py:124", "B13": "tools/kernel_micro.py:214",
    "B14": "tools/kernel_micro.py:281",
}
KERNEL_NAMES = ("segment_fused", "segment_backward", "scatter_rows", "traverse_select",
                "rows_segment", "nearest_shade", "nearest_triangle", "selection_micro", "rng",
                "regen_pass")
PASS_SOURCE = f"{PKG}/csrc/regen_pass.cu"
# B1r: the JAX package's regen pass is one device program, a lax.while_loop
# (PASS_LOOP) over the per-lane-flag segment kernel (its pallas_call).
PASS_REPLACES = LANE_REPLACES
PASS_LOOP = "montecarlopathtracer_tpu/render/regen.py:165"
RNG_SOURCE = f"{PKG}/csrc/rng.cu"
# Not a TPU kernel: the counterpart of the JAX package's draws,
# jax.random.uniform(jax.random.fold_in(key, stream), shape).
RNG_REPLACES = "montecarlopathtracer_tpu/ops/rng.py:24"
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
            if "registers" in line or "spill" in line or "entry function" in line:
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


# Integer operations of one threefry-2x32 draw (rng.cu, per lane and
# stream): 20 rounds of add, rotate, xor (60), the key schedule and five
# injections (~10), the xor of the two words, shift, or and the subtract
# that make the float (~6).
RNG_OPS = 76


def rng_vs_plain(torch):
    phase("2b. uniform draws (rng.cu) vs plain: bits at R = 480,000 and 1,048,576, "
          "k = 1-3 streams, one launch a call")
    from montecarlopathtracer_tpu_torch.ops import rng as RNG

    key = RNG.fold_in(RNG.fold_in(RNG.make_key(0), 0), 0)
    ids = (4, 5, 7, (1 << 30) + 673)
    for R in (W * H, BW * BH):
        for k in (1, 2, 3):
            before = read_all_counts()
            got = RNG.stream_uniforms(key, ids[:k], R, "cuda")
            torch.cuda.synchronize()
            n = (read_all_counts() - before)["RNG"]
            want = RNG.stream_uniforms_ref(key, ids[:k], R, "cuda")
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            print(f"R {R:9d} k {k}: bit-equal to plain {same}, launches {n}, rows "
                  f"contiguous {all(row.is_contiguous() for row in got)}")
            check(same and n == 1 and tuple(got.shape) == (k, R),
                  f"rng.cu at R {R}, k {k}: equal {same}, {n} launches")
    cpu = RNG.stream_uniforms_ref(key, ids, 1000, "cpu")
    check(torch.equal(RNG.stream_uniforms(key, ids, 1000, "cuda").cpu().view(torch.int32),
                      cpu.view(torch.int32)), "rng.cu differs from the CPU's plain draws")
    print("k 4, n 1000: bit-equal to the CPU's plain draws")
    sids = (0, 1, 3)
    ms = time_pair(torch, lambda: RNG.stream_uniforms(key, sids, W * H, "cuda"),
                   lambda: RNG.stream_uniforms_ref(key, sids, W * H, "cuda"), label="RNG")
    bound = bound_of(4 * 3 * W * H, RNG_OPS * 3 * W * H, INT32_OPS_PER_S)
    big = record_device(torch, "RNG 1M", lambda: RNG.stream_uniforms(key, sids[:2], BW * BH,
                                                                      "cuda"))[0]
    print(f"u1, u2, urr of an {W}x{H} segment: kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms "
          f"(event pairs, median of 10); u1, u2 of a {BW}x{BH} segment: device {big:.4f} ms")
    device_line("RNG", ms[0], bound)
    return (*ms, bound)


def keyed_draws(torch):
    phase("2c. uniform draws under a key on the card (DeviceKey) vs plain: bits at R = 480,000, "
          "0-3 folds, 2-4 streams")
    from montecarlopathtracer_tpu_torch.ops import rng as RNG

    key = RNG.fold_in(RNG.make_key(3_900_000_001), 17)
    staged = RNG.DeviceKey.stage(key, torch.zeros(2, dtype=torch.int32, device="cuda"))
    calls = 0
    reset_counts()
    for folds in ((), (2,), (2, (1 << 29) + 1), (2, (1 << 29) + 1, 5)):
        host, dev = key, staged
        for d in folds:
            host, dev = RNG.fold_in(host, d), RNG.fold_in(dev, d)
        for ids in ((4, 5), (28, 29, 31), ((1 << 30), (1 << 30) + 1, 8, 9)):
            got = RNG.stream_uniforms(dev, ids, W * H, "cuda")
            calls += 1
            want = RNG.stream_uniforms_ref(host, ids, W * H, "cuda")
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            check(same, f"keyed draws differ from the plain ones: folds {folds}, streams {ids}")
    n = read_all_counts()["RNG"]
    print(f"{calls} keyed draws (folds 0-3 x streams 2-4) at R {W * H}: bit-equal to the plain "
          f"draws of the host key; launches {n}")
    check(n == calls, f"keyed draws launched {n} times, expected {calls}")
    return {"keyed_bit_equal_calls": calls, "launches_keyed": n}


def seg_args(torch, rows, pos, dir_, tput, res, live, key, flags):
    from montecarlopathtracer_tpu_torch.ops.rng import stream_uniforms

    R = pos.shape[1]
    dev = pos.device
    u1, u2, urr = stream_uniforms(key, (0, 1, 3), R, dev)
    fl = torch.tensor(flags, dtype=torch.float32, device=dev).reshape(3, 1)
    return (rows, pos.contiguous(), dir_.contiguous(), tput.contiguous(),
            res.contiguous(), live.contiguous(), u1, u2, urr, fl)


def camera_wavefront(torch, camera, width, height, key):
    from montecarlopathtracer_tpu_torch.ops.rng import stream_uniforms

    dev = camera.device
    R = width * height
    pix = torch.arange(R, device=dev)
    jx, jy = stream_uniforms(key, (1 << 30, (1 << 30) + 1), R, dev) * 2.0 - 1.0
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
    worst, identical = 0.0, True
    for wname, wave in (("64x48 camera", small), ("800x600 bounce", bounce)):
        check(all(versus_control(torch, rows, wave[0], wave[1], wave[4])),
              f"B7 or B4 with the d'z test differs from the control loop on {wname}")
        for cname, (mode, flags) in CASES.items():
            args = seg_args(torch, rows, *wave, make_key(5), flags)
            got = F.mega_segment(*args, mode=mode)
            torch.cuda.synchronize()
            vs = versus_split(torch, rows, got[0], args[1], args[2], args[5])
            check(vs[0] and vs[1], f"B1's winners differ from B4's on {wname} {cname}")
            identical &= vs[0] and vs[1]
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
    print(f"B1's idx and the t recomputed from its winners bit-equal to B4's (nearest_shade.cu, "
          f"the same selection loop) on every case: {identical}; B7's and B4's with the d'z "
          "test bit-equal to the control's (the one-ray-per-thread loop) on both wavefronts: "
          "True")
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
    pairs = sphere_pairs(torch, rows, bounce[0], bounce[1], bounce[4])
    bound = segment_bound(rows.shape[0], W * H, pairs)
    print(f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  (median of 10, "
          f"{int(bounce[4].sum())} live rays of {W * H}, {rows.shape[0]} triangles); bound "
          f"{bound[0]:.4f} ms ({bound[1]}: the sphere test on {pairs[0]} pairs, the exact "
          f"test on the {pairs[1]} that pass it; all {pairs[0]} at {PAIR_OPS} operations "
          f"would give {bound_of(0, pairs[0] * PAIR_OPS)[0]:.4f} ms)")
    record_device(torch, "B1", lambda: F.mega_segment(*args, mode="fixed"))
    device_line("B1", ms, bound)
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
    want_rng = (1 + config.num_segments) * SPP * (WARMUP_PASSES + TIMED_PASSES)
    print(f"launches in the main path: mega_segment {launches} (expected {want}), rng.cu "
          f"{counts['RNG']} (expected {want_rng}: the jitter pair and each segment's u1, u2, "
          "one launch each)")
    check(launches == want and counts["B1l"] == 0, f"launches {counts}, expected {want} B1")
    check(counts["RNG"] == want_rng, f"launches {counts}, expected {want_rng} RNG")

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
    profile_device(torch, "forward pass", lambda: r.render(1),
                   {"B1 mega_segment": "mega_segment_kernel", "RNG uniform": "uniform_kernel"},
                   per_pass * 1e3)
    return counts, per_pass, msps


def breakdown(torch, scene, camera, per_pass):
    """Device time of one main-path sample, split by segment: the
    kernel launch against the segment's random draws (one launch of
    rng.cu), each span between CUDA events around the one call."""
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key, stream_uniforms
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
        u1, u2 = stream_uniforms(key, (4 * seg, 4 * seg + 1), W * H, "cuda")
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
    print("per-segment rng ms:    " + " ".join(f"{x:.3f}" for x in rng_ms)
          + f" (the event span around one rng.cu launch; its device time for three streams "
          f"{DEVICE_MS['RNG'][0]:.4f} ms, phase 2b)")
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
    from montecarlopathtracer_tpu_torch.utils.profiling import reset_launches

    reset_launches()


def read_all_counts():
    """Launches of every kernel (utils/profiling.py::launches)."""
    from montecarlopathtracer_tpu_torch.utils.profiling import launches

    return launches()


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
    """Segment-vjp inputs on a wavefront, as :func:`segment_backward_rows`
    takes them (the table and the winner index, seeded random cotangents
    on the four outputs)."""
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.rng import make_key

    pos, dir_, tput0, res, live = bounce
    tput = tput0 if tput is None else tput
    args = seg_args(torch, rows, pos, dir_, tput, res, live, make_key(5), flags)
    idx = F.mega_segment(*args, mode=mode, **kw)[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    cts = [torch.randn(3, pos.shape[1], device="cuda", generator=g) for _ in range(4)]
    return idx, (*args[1:6], rows, idx, *args[6:10], *cts)


def backward_vs_plain(torch, rows, bounce):
    phase("8. segment vjp kernel (B2, rows through the index) vs plain, 800x600 "
          "first-bounce wavefront")
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.testing import GRAD_TOL, compare_grads

    worst, last = 0.0, None
    reset_counts()
    for i, (cname, (mode, flags, kw)) in enumerate(BWD_CASES.items()):
        # Tied grey throughput: RR's p is a three-way tie on every lane.
        tput = torch.full_like(bounce[2], 0.6) if "tied" in cname else None
        idx, args = backward_args(torch, rows, bounce, mode, flags, kw, tput, seed=i)
        got = F.segment_backward_rows(*args, mode=mode, **kw)
        # JAX's contract (the hit mask and the gathered rows), on the same kernel.
        same = F.segment_backward(*args[:5], idx >= 0, F.gather_rows(rows, idx), *args[7:],
                                  mode=mode, **kw)
        torch.cuda.synchronize()
        want = F.segment_backward_rows_ref(*args, mode=mode, **kw)
        torch.cuda.synchronize()
        rep = compare_grads(want, got, lanes=args[4])
        errs = rep["max_abs_err"]
        worst = max([worst, *errs.values()])
        equal = all(torch.equal(a, b) for a, b in zip(got, same))
        print(f"{cname:18s} {rep['n_lanes']} live lanes, {int((idx >= 0).sum())} hit; share "
              f"within tol " + " ".join(f"{k} {v:.6f}" for k, v in rep["share_within"].items()))
        print(f"{'':18s} max |err| (scale) "
              + " ".join(f"{k} {errs[k]:.2e} ({rep['scale'][k]:.2e})" for k in errs)
              + f"; segment_backward on the gathered rows bit-equal: {equal}")
        check(rep["ok"], f"segment_backward_rows disagrees with plain on {cname}: {rep}")
        check(equal, f"segment_backward_rows differs from segment_backward on {cname}")
        last = (idx, got[4])
    counts = read_all_counts()
    n = len(BWD_CASES)
    print(f"launches: B2 {counts['B2']} (expected {2 * n}: segment_backward_rows and "
          f"segment_backward, one each a case)")
    check(counts["B2"] == 2 * n, f"B2 launches {counts}")
    print(f"tolerance: per output |err| <= {GRAD_TOL:g} * (|ref| + max |ref|) on at "
          f"least 99.9% of live lanes, 1e-2 on all; worst |err| {worst:.3e}")
    return worst, last


def scatter_vs_plain(torch, idx, d_full, T, source):
    """B3 against its plain version on the row cotangents ``d_full`` of
    one segment (``source`` names it) and on N(0,1) ones of the same
    shape, each entry held to its own rounding bound, and two calls held
    bit-equal to each other; returns the worst |err|.

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
        again = S.scatter_rows(idx, dvals, T)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, again))
        exact = S.scatter_rows_ref(idx, dvals.double(), T)
        bound = S.scatter_rows_ref(idx, dvals.double().abs(), T)
        rep = compare_scatter(exact, got, bound)
        plain = compare_scatter(exact, S.scatter_rows_ref(idx, dvals, T), bound)
        worst = max(worst, rep["max_abs_err"])
        print(f"{name:34s} {int(hit.sum())} rays hit, at most {most} into one row; "
              f"max |err| {rep['max_abs_err']:.3e} of a table max "
              f"{float(exact.abs().max()):.3e}; worst |err| / (eps32 x sum |dvals|) "
              f"{rep['worst_ulps']:.3f} (plain in f32: {plain['worst_ulps']:.3f}); two calls "
              f"bit-equal: {same}")
        check(rep["ok"], f"scatter_rows disagrees with plain on {name}: {rep}")
        check(same, f"two scatter_rows calls on {name} differ")
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


def device_ms(torch, fn, n=20):
    """Device time per call of ``fn()``: CUDA events around ``n``
    back-to-back calls queued behind a ``torch.cuda._sleep`` that outlasts
    their enqueueing, so the events see the card's work and not the
    host's (the wrappers do not synchronize); the median of three such
    spans, divided by n. Returns (ms, source, host_ms): host_ms is the
    host's time to enqueue one call. (torch.profiler's kernel times,
    tried first, lost kernels after a few profiles in one process: a
    kernel came out faster than its bound.)"""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    spans = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(3 * host * 2e9) + 1_000_000)  # cycles, ~2 GHz
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        spans.append(a.elapsed_time(b) / n)
    return statistics.median(spans), "queued events", host * 1e3 / n


# Device time per call by kernel label (B1, B3 T652, ...; index_add_ T652,
# ...), filled by time_pair / time_one / record_device; read into the
# kernels' JSON line.
DEVICE_MS = {}


def record_device(torch, label, fn):
    DEVICE_MS[label] = device_ms(torch, fn)
    return DEVICE_MS[label]


# This script's earlier run on an NVIDIA H100 80GB HBM3 at 700.00 W, on
# the same phases' inputs and by the same methods (the run on the final
# tree before the culled loop made the warp its unit): (device ms per
# launch, event pair ms). Since then B1c and B4c (and the entries B10c and
# B11 over B4c) run `select_culled`: per-warp votes, nearest chunk first,
# records built once per table (B4r), leaf boxes of 16 triangles.
EARLIER_MS = {
    "B1": (0.3424, 0.5661), "B1c": (0.3196, 0.6185), "B1l": (0.3470, 0.5393),
    "B3 T652": (0.1419, 0.1864), "B3 T81932": (0.0999, 0.1618),
    "B4": (0.3146, 0.4692), "B4c": (0.3218, 0.6011), "B5": (1.5650, 1.8375),
    "B5t": (0.0927, 0.2501), "B6": (0.0521, 0.2948), "B6l": (0.0527, 0.3102),
    "B7": (0.3329, 0.4519), "B8": (0.3696, 0.7785), "B9": (0.3699, 0.7470),
    "B10": (0.3778, 0.7955), "B10c": (0.3514, 1.1284), "B11": (0.3426, 0.9677),
    "B12 full": (0.9628, 1.0422), "B12 matmul_only": (0.6399, 0.6926),
    "B12 matmul_bf16": (0.6417, 0.6797), "B13": (3.1355, 3.1947), "B14": (0.4348, 0.4660),
}
# The earlier run's chunks tested per group of 128 rays by B1c on the
# glossy wavefronts (phase 24, boxes widened by the chunk slack).
EARLIER_TESTED = {"camera": 1.44, "sorted bounce": 3.72}


def device_line(label, event_pair, bound, library=None):
    """One line of a kernel's device time beside its event pair, bound and
    the earlier run's figures."""
    dev, src, host = DEVICE_MS[label]
    old = EARLIER_MS.get(label)
    line = (f"{label}: device {dev:.4f} ms per launch ({src}, 20 back-to-back calls; the "
            f"host enqueues one in {host:.4f} ms), event pair {event_pair:.4f} ms; bound "
            f"{bound[0]:.4f} ms ({bound[1]}), device time at {bound[0] / dev:.3f} of it")
    if library is not None:
        ldev = DEVICE_MS[library][0]
        line += f"; {library} device {ldev:.4f} ms"
    if old is not None:
        line += f"; earlier run: device {old[0]:.4f} ms, event pair {old[1]:.4f} ms"
    print(line)


def time_pair(torch, kernel, plain, n=10, label=None):
    """Median CUDA-event ms of `kernel()` and `plain()`, alternating; with
    `label`, also the kernel's device time into DEVICE_MS."""
    event_ms(torch, kernel)
    event_ms(torch, plain)
    ks, ps = [], []
    for i in range(n):
        for fn in ((kernel, plain) if i % 2 == 0 else (plain, kernel)):
            (ks if fn is kernel else ps).append(event_ms(torch, fn))
    if label is not None:
        record_device(torch, label, kernel)
    return statistics.median(ks), statistics.median(ps)


def time_one(torch, fn, n=10, label=None):
    """Median CUDA-event ms of `fn()` after one warm-up call; with `label`,
    also its device time into DEVICE_MS."""
    event_ms(torch, fn)
    ms = statistics.median(event_ms(torch, fn) for _ in range(n))
    if label is not None:
        record_device(torch, label, fn)
    return ms


def time_backward(torch, rows, bounce):
    phase("10. one 800x600 segment's B2 and B3, kernel and plain")
    from montecarlopathtracer_tpu_torch.ops import scatter_rows as S
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F

    idx, args = backward_args(torch, rows, bounce, "fixed", [0.0, 0.0, 0.0], {})
    d_full = F.segment_backward_rows(*args)[4]
    T = rows.shape[0]
    bwd = time_pair(torch, lambda: F.segment_backward_rows(*args),
                    lambda: F.segment_backward_rows_ref(*args), label="B2")
    sc = time_pair(torch, lambda: S.scatter_rows(idx, d_full, T),
                   lambda: S.scatter_rows_ref(idx, d_full, T), label="B3 T652")
    R, hits = W * H, int((idx >= 0).sum())
    # Per lane: state, act, idx, uniforms and cotangents read, d_pos ..
    # d_res and the lane's 48 row cotangents written; the table and the
    # flags once.
    bwd = (*bwd, bound_of(R * (48 + 1 + 4 + 12 + 48) + T * 192 + 12 + R * (48 + 192),
                          hits * 40))
    sc = (*sc, bound_of(R * 196 + T * 192, hits * 48), library_index_add(torch, idx, d_full, T))
    print(f"segment_backward kernel {bwd[0]:.4f} ms  plain {bwd[1]:.4f} ms (bound "
          f"{bwd[2][0]:.4f} ms, {bwd[2][1]}); scatter_rows kernel {sc[0]:.4f} ms  plain "
          f"{sc[1]:.4f} ms (bound {sc[2][0]:.4f} ms, {sc[2][1]}; one index_add_ {sc[3]:.4f} ms) "
          f"(median of 10, {int(bounce[4].sum())} live rays of {W * H}, {T} triangles)")
    device_line("B2", bwd[0], bwd[2])
    device_line("B3 T652", sc[0], sc[2], library="index_add_ T652")
    return bwd, sc, time_small_scatter(torch)


INVERSE_CELL = "cornell_box_inverse.adam_red_wall"


def inverse_scatter_calls(torch):
    """The (idx, d_full, T) of every B3 call of one eager gradient step of
    the benchmark's inverse cell at its full size (800x600, 4 spp, depth
    7 + the gather, the published box's 32 rows), and the launches the
    step counted."""
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from perfbench import harness
    from perfbench.drivers import progressive as P

    ctx = harness.load_context(INVERSE_CELL, 2_300_000_111, 0.0, False, "cuda")
    scene, camera = P.program_scene(ctx)
    scene, camera = scene.to("cuda"), camera.to("cuda")
    loss_fn = G.make_loss_fn(scene, camera, torch.zeros(ctx.height, ctx.width, 3, device="cuda"),
                             width=ctx.width, height=ctx.height,
                             spp=int(ctx.traffic["spp_per_pass"]), config=P.trace_config(ctx))
    caught = []

    def catch(idx, d_full, T):
        caught.append((idx, d_full, T))
        return scatter(idx, d_full, T)

    scatter = F.scatter_rows
    F.scatter_rows = catch
    reset_counts()
    try:
        G.value_and_grad(loss_fn, {"mat_kd": scene.mat_kd.clone()}, make_key(3))
        torch.cuda.synchronize()
    finally:
        F.scatter_rows = scatter
    return caught, read_all_counts()


def time_small_scatter(torch):
    """Phase 10's B3 at the inverse cell's shape (see the module
    docstring): returns the small path's timing tuple, its worst |err|,
    its launches and the figures of the comparison."""
    from montecarlopathtracer_tpu_torch.ops import scatter_rows as S
    from montecarlopathtracer_tpu_torch.testing import SCATTER_ULPS, compare_scatter

    calls, counts = inverse_scatter_calls(torch)
    T = calls[0][2]
    print(f"the inverse cell's eager step: {len(calls)} B3 calls at T = {T}, R = "
          f"{calls[0][0].shape[0]}; launches B3 {counts['B3']}, B3s {counts['B3s']}")
    check(T == 32 and len(calls) == 32 and counts["B3"] == counts["B3s"] == 32,
          f"inverse step: T {T}, {len(calls)} calls, launches {counts}")
    paths = {"small": lambda i, d, t: S._scatter_rows_cuda(i, d, t, True),
             "sort": lambda i, d, t: S._scatter_rows_cuda(i, d, t, False)}
    worst = 0.0
    for n, (idx, d_full, _) in enumerate(calls):
        exact = S.scatter_rows_ref(idx, d_full.double(), T)
        bound = S.scatter_rows_ref(idx, d_full.double().abs(), T)
        for name, fn in paths.items():
            got, again = fn(idx, d_full, T), fn(idx, d_full, T)
            rep = compare_scatter(exact, got, bound)
            worst = max(worst, rep["max_abs_err"])
            check(rep["ok"], f"B3 {name} path disagrees with the exact sums on call {n}: {rep}")
            check(bool(torch.equal(got, again)), f"two B3 {name} calls differ on call {n}")
    print(f"every call on both paths within {SCATTER_ULPS} x eps32 x sum |dvals| of the exact "
          f"sums, two calls of each bit-equal; worst |err| {worst:.3e}")
    hits = [int((c[0] >= 0).sum()) for c in calls]
    idx, d_full, _ = calls[max(range(len(calls)), key=hits.__getitem__)]
    R, most = idx.shape[0], max(hits)
    ms = time_pair(torch, lambda: paths["small"](idx, d_full, T),
                   lambda: S.scatter_rows_ref(idx, d_full, T), label="B3 T32")
    record_device(torch, "B3 T32 sort", lambda: paths["sort"](idx, d_full, T))
    timing = (*ms, bound_of(R * 196 + T * 192, most * 48))
    device_line("B3 T32", ms[0], timing[2])
    print(f"the same call on the sort path: device {DEVICE_MS['B3 T32 sort'][0]:.4f} ms "
          f"(the segment with the most hits, {most} of {R})")
    step = {name: record_device(torch, f"B3 step {name}",
                                lambda fn=fn: [fn(i, d, t) for i, d, t in calls])[0]
            for name, fn in paths.items()}
    print(f"the step's {len(calls)} calls: small path {step['small']:.4f} ms, sort path "
          f"{step['sort']:.4f} ms on the device; floor {len(calls) * timing[2][0]:.4f} ms "
          f"({timing[2][0] * 1e3:.2f} us a call, every ray's 196 bytes)")
    rows = torch.arange(R, device="cuda", dtype=torch.int32)
    spread = {}
    for t in (64, S.T_SMALL):
        wide = torch.where(idx >= 0, idx + 32 * (rows % (t // 32)), -1).to(torch.int32)
        spread[t] = [record_device(torch, f"B3 T{t} {name}",
                                   lambda fn=fn: fn(wide, d_full, t))[0]
                     for name, fn in paths.items()]
        print(f"T = {t} (the rows spread {t // 32}-fold by ray): small path "
              f"{spread[t][0]:.4f} ms, sort path {spread[t][1]:.4f} ms on the device")
    check(all(a < b for a, b in spread.values()) and DEVICE_MS["B3 T32"][0]
          < DEVICE_MS["B3 T32 sort"][0], f"the small path is not the faster below T_SMALL: "
          f"{spread}")
    return {"timing": timing, "err": worst, "launches": counts["B3s"],
            "sort_device_ms": DEVICE_MS["B3 T32 sort"][0], "step_device_ms": step,
            "t_small_device_ms_small_sort": spread}


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
    all_counts = read_all_counts()
    counts = {k: v for k, v in all_counts.items() if k in ("B1", "B2", "B3")}
    msps = W * H * GRAD_SPP * GRAD_ITERS / dt / 1e6
    print(f"warm-up iteration {warm:.3f} s; {GRAD_ITERS} timed iterations {dt:.3f} s = "
          f"{dt / GRAD_ITERS:.4f} s/iteration, fwd+bwd {msps:.4f} Msamples/s "
          f"(loss {float(loss):.6f})")
    want = config.num_segments * GRAD_SPP * (1 + GRAD_ITERS)
    print(f"launches in the gradient path: {counts} (expected {want} each)")
    for name, n in counts.items():
        check(n == want, f"{name} launched {n} times, expected {want}")
    want_rng = (1 + config.num_segments) * GRAD_SPP * (1 + GRAD_ITERS)
    print(f"rng.cu launches: {all_counts['RNG']} (expected {want_rng})")
    check(all_counts["RNG"] == want_rng, f"RNG launched {all_counts['RNG']} times")
    counts["RNG"] = all_counts["RNG"]
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
    print(f"  ({n_other} other kernel launches: sorts, gathers, elementwise and "
          f"reductions)")
    return {name: us / 1e3 for name, us in groups.items()}


def grad_profile(torch, loss_fn, params, per_iter):
    """Device time of one gradient iteration by kernel; then the
    iteration's uniform draws alone on the host clock."""
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops.rng import make_key, stream_uniforms

    profile_device(torch, "iteration", lambda: G.value_and_grad(loss_fn, params, make_key(20)),
                   {"B1 mega_segment": "mega_segment_kernel",
                    "B2 segment_backward": "segment_backward_kernel",
                    "B3 scatter_rows": "scatter_rows", "RNG uniform": "uniform_kernel"},
                   per_iter * 1e3)
    # The iteration's uniform draws alone (the jitter pair and u1, u2 per
    # segment, per sample: one rng.cu launch each) on the host clock.
    sids = ((1 << 30, (1 << 30) + 1), *((4 * seg, 4 * seg + 1) for seg in range(DEPTH + 1)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRAD_SPP):
        for pair in sids:
            stream_uniforms(make_key(21), pair, W * H, "cuda")
    torch.cuda.synchronize()
    print(f"  the iteration's {GRAD_SPP * len(sids)} draws (rng.cu launches) alone: "
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


def adam_graphed(torch, scene, camera):
    phase(f"12b. the inverse cell's step: make_adam_step (CUDA graphs) at {W}x{H}, {SPP} spp, "
          f"fixed depth {DEPTH}, vs value_and_grad of the eager loss")
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig

    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0)
    base = make_key(3_900_000_021)
    kd = scene.mat_kd
    red = int((kd[:, 0] - kd[:, 1] - kd[:, 2]).argmax())
    with torch.no_grad():
        target = G.render_image({}, scene, camera, fold_in(base, 99), width=W, height=H,
                                spp=SPP, config=config)
    loss_fn = G.make_loss_fn(scene, camera, target, width=W, height=H, spp=SPP, config=config)
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, 0.05
    step = G.make_adam_step(loss_fn, lr=lr, betas=(b1, b2), eps=eps, bounds=(0.0, 1.0),
                            rows=[red])
    start = kd.clone()
    start[red] = torch.tensor([0.01, 0.2, 0.9], device="cuda")
    params, _, state = step({"mat_kd": start}, fold_in(base, 0))  # captures the graphs
    torch.cuda.synchronize()
    key = fold_in(base, 1)
    want_loss, want = G.value_and_grad(loss_fn, params, key)
    g = want["mat_kd"][red:red + 1]
    m = state.m["mat_kd"].lerp(g, 1.0 - b1)
    v = (state.v["mat_kd"] * b2).addcmul_(g, g, value=1.0 - b2)
    denom = (v.sqrt() / math.sqrt(1.0 - b2**2)).add_(eps)
    row = params["mat_kd"][red:red + 1].addcdiv(m, denom, value=-lr / (1.0 - b1**2))
    row = row.clamp_(0.0, 1.0)
    torch.cuda.synchronize()
    reset_counts()
    new, loss, state = step(params, key, state)
    torch.cuda.synchronize()
    counts = read_all_counts()
    same_loss = torch.equal(loss, want_loss)
    errs = {name: float(((got - ref).abs() / ref.abs().clamp_min(1e-30)).max())
            for name, got, ref in (("m", state.m["mat_kd"], m), ("v", state.v["mat_kd"], v),
                                   ("row", new["mat_kd"][red:red + 1], row))}
    others = torch.ones(kd.shape[0], dtype=torch.bool, device="cuda")
    others[red] = False
    untouched = torch.equal(new["mat_kd"][others], params["mat_kd"][others])
    print(f"loss {float(loss):.9e} vs eager {float(want_loss):.9e} (bit-equal {same_loss}); "
          f"largest relative gap to the eager update: "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f"; other rows untouched {untouched}; red row {new['mat_kd'][red].tolist()}")
    check(same_loss, "the graphed step's loss differs from the eager loss")
    check(all(e <= 1e-6 for e in errs.values()), f"the graphed step's update differs: {errs}")
    check(untouched, "the graphed step moved a row outside `rows`")
    segments = config.num_segments * SPP
    want_counts = {"B1": segments, "B2": segments, "B3": segments, "RNG": segments + SPP}
    got_counts = {k: counts[k] for k in want_counts}
    print(f"launches of the replayed step: {got_counts} (expected {want_counts})")
    check(got_counts == want_counts, f"replay launches {got_counts}, expected {want_counts}")
    return {"launches_adam_graphed": got_counts, "adam_graphed_max_rel_gap": max(errs.values())}


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
    phase("14. build: the regen and traversal paths' kernels (B1r, B5, B6)")
    from montecarlopathtracer_tpu_torch.ops import cuda_build

    for name, src in (("traverse_select", TRAVERSE_SOURCE), ("rows_segment", ROWS_SOURCE),
                      ("regen_pass", PASS_SOURCE)):
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
        vs = versus_split(torch, rows, got[0], args[1], args[2], args[5])
        check(vs[0] and vs[1], f"B1l's winners differ from B4's in {mode} mode")
        ref = F.mega_segment_ref(*args, mode=mode)
        rep = compare_segment(ref, got, live=args[5], rows=rows, pos=args[1], dir_=args[2])
        errs = rep["max_abs_err"]
        worst = max([worst, *errs.values()])
        print(f"{mode:6s} lane flags: idx agree {rep['idx_agree']:.6f} "
              f"({rep['n_idx_mismatch']} near-tie mismatches of {rep['n_live']} live) "
              "max |err| " + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; lanes beyond 1e-5: {rep['n_outliers']}; idx and t bit-equal to B4's: "
              f"{vs[0] and vs[1]}")
        check(rep["ok"], f"B1l disagrees with plain in {mode} mode: {rep}")
    ms = time_pair(torch, lambda: F.mega_segment(*args, mode="rr"),
                   lambda: F.mega_segment_ref(*args, mode="rr"), label="B1l")
    pairs = sphere_pairs(torch, rows, bounce[0], bounce[1], bounce[4])
    bound = segment_bound(rows.shape[0], W * H, pairs, lane=True)
    print(f"B1l kernel {ms[0]:.4f} ms  plain {ms[1]:.4f} ms (median of 10, RR, "
          f"{int(bounce[4].sum())} live rays of {W * H}; bound {bound[0]:.4f} ms, {bound[1]}: "
          f"{pairs[0]} pairs sphere-tested, {pairs[1]} exact); "
          f"tolerance as phase 3; worst |err| {worst:.3e}")
    device_line("B1l", ms[0], bound)
    return worst, (*ms, bound)


def regen_main_path(torch, scene, camera):
    phase(f"16. regen main path: Renderer {W}x{H}, RR, {REGEN_SPP} spp/pass, "
          "regenerating wavefront")
    import dataclasses

    import numpy as np

    from montecarlopathtracer_tpu_torch.ops import regen_pass as RP
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key
    from montecarlopathtracer_tpu_torch.render.integrator import (
        TraceConfig,
        render_rows_planar,
    )
    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings

    config = TraceConfig(mode="rr", rr_depth=5, illum=1.0)
    settings = RenderSettings(width=W, height=H, spp_per_pass=REGEN_SPP, seed=0, regen=True)
    r = Renderer(scene, camera, config, settings, device="cuda")
    # A regen pass is one launch of B1r and nothing else: no B1l and no
    # draw, the steps run inside the kernel (phase 16b reports them).
    reset_counts()
    t0 = time.perf_counter()
    r.render(1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    passes = [read_all_counts()["B1r"]]
    t0 = time.perf_counter()
    for _ in range(REGEN_TIMED):
        r.render(1)
        passes.append(read_all_counts()["B1r"] - sum(passes))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_all_counts()
    msps = W * H * REGEN_SPP * REGEN_TIMED / dt / 1e6
    print(f"warm-up pass {warm:.3f} s; {REGEN_TIMED} timed passes {dt:.3f} s = "
          f"{dt / REGEN_TIMED:.4f} s/pass, RR regen {msps:.4f} Msamples/s")
    print(f"B1r launches per pass {passes}; launches {counts} (expected one B1r a pass, and "
          "no B1, B1l or draw)")
    others = {k: v for k, v in counts.items() if v and k != "B1r"}
    check(passes == [1] * (1 + REGEN_TIMED) and not others,
          f"regen launched {counts}, expected one B1r a pass and nothing else")

    img = r.film.color.cpu().numpy()
    check(img.shape == (H, W, 3) and np.isfinite(img).all(), "regen film not finite")
    check(float(r.film.weight) == REGEN_SPP * len(passes), f"film weight {float(r.film.weight)}")
    # The scan integrator's estimate of the same image from 32 samples:
    # the frame means of its samples give the standard error. Timed too
    # (with one sync per sample for its mean), beside regen's pass.
    key = make_key(99)
    t0 = time.perf_counter()
    means = []
    with torch.no_grad():
        for i in range(REGEN_SPP):
            means.append(float(render_rows_planar(scene, camera, fold_in(key, i), W, H, 0, H,
                                                  config, r.tables).mean()))
            if i + 1 == REGEN_SPP // 2:
                scan_half_s = time.perf_counter() - t0
    scan_s = time.perf_counter() - t0
    print(f"scan integrator, same config, {REGEN_SPP} spp: {scan_s:.4f} s, "
          f"{W * H * REGEN_SPP / scan_s / 1e6:.4f} Msamples/s, "
          f"{REGEN_SPP * config.num_segments} B1 launches")
    scan, sd = statistics.mean(means), statistics.stdev(means)
    se = sd * (1.0 / REGEN_SPP + 1.0 / (REGEN_SPP * len(passes))) ** 0.5
    film = float(img.mean())
    print(f"film mean {film:.6f} ({REGEN_SPP * len(passes)} spp) vs scan {scan:.6f} "
          f"({REGEN_SPP} spp): |diff| {abs(film - scan):.2e}, {abs(film - scan) / se:.2f} "
          f"standard errors ({se:.2e}); bound 5")
    check(abs(film - scan) <= 5.0 * se, "regen film mean is off the scan's")
    png = os.path.join(HERE, "build", "chip_smoke_regen_800x600.png")
    r.save_png(png)
    print(f"wrote {os.path.relpath(png, HERE)}")
    profile_device(torch, "regen pass", lambda: r.render(1),
                   {"B1r regen_pass": "regen_pass_kernel"}, dt / REGEN_TIMED * 1e3)
    # Regen against the scan at half the samples per pass, the same way.
    half = REGEN_SPP // 2
    rh = Renderer(scene, camera, config, dataclasses.replace(settings, spp_per_pass=half),
                  device="cuda")
    rh.render(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rh.render(REGEN_TIMED)
    torch.cuda.synchronize()
    half_s = (time.perf_counter() - t0) / REGEN_TIMED
    check(np.isfinite(rh.film.color.cpu().numpy()).all(), "regen film not finite")
    print(f"regen against the scan, {W}x{H} RR: {REGEN_SPP} spp/pass {dt / REGEN_TIMED:.4f} s "
          f"against {scan_s:.4f} s ({scan_s / (dt / REGEN_TIMED):.3f}x); {half} spp/pass "
          f"{half_s:.4f} s against {scan_half_s:.4f} s ({scan_half_s / half_s:.3f}x)")
    return counts, msps


# Phase 16b's configurations: (label, scene, TraceConfig keywords, spp per pass).
PASS_CASES = (
    ("Cornell RR", "cornell", dict(mode="rr", rr_depth=5, illum=1.0), REGEN_SPP),
    ("Cornell fixed", "cornell", dict(mode="fixed", max_depth=DEPTH, illum=10.0), 16),
    ("glossy fixed cull", "glossy", dict(mode="fixed", max_depth=DEPTH, illum=10.0,
                                         chunk_cull=True), 16),
)


def pass_pairs(torch, tables, config, pairs):
    """An ``on_step`` for regen_pass_ref that adds each step's
    sphere_pairs (tested, exact) to ``pairs`` (a list of four ints), the
    count of phase 15's B1l and phase 10's B1c bounds: every live ray x T,
    or with chunk_cull the triangles of the chunks each live ray's segment
    reaches up to its winner (B4c's winners, bit-equal to B1c's); of
    those, the pairs inside the triangles' spheres. With chunk_cull it also
    adds the chunks B4c's vote tests for each group of 128 consecutive
    lanes (the pinned blocks of B1rc's earlier design) times the group's
    live lanes, and the live lanes (pairs[2], pairs[3])."""
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS

    rows = tables.rows

    def on_step(pos, dir_, live):
        kw = {}
        if config.chunk_cull:
            boxes = tables.cull_boxes
            R = live.shape[0]
            tested = torch.zeros(-(-R // 128), dtype=torch.int32, device=live.device)
            idx = NS.nearest_shade_full(rows, pos, dir_, live, **boxes, tested=tested)[0]
            group = torch.nn.functional.pad(live, (0, -R % 128)).reshape(-1, 128).sum(1)
            pairs[2] += int((tested.long() * group).sum())
            pairs[3] += int(live.sum())
            kw = dict(boxes=boxes, t_best=winner_t(torch, rows, idx, pos, dir_),
                      widen=tuple(tables.cslack.T))
        tested, exact = sphere_pairs(torch, rows, pos, dir_, live, step=1 << 14, **kw)
        pairs[0] += tested
        pairs[1] += exact

    return on_step


def pass_bound(T, R, pairs, crec_rows=0):
    """B1r's bound: ``pairs`` = (tested, exact) summed over the pass's
    steps by pass_pairs, SPHERE_OPS for each pair tested and PAIR_OPS more
    for each inside a sphere, as segment_bound counts one segment's,
    against its bytes: the table (and records) read once, accum written
    once."""
    return bound_of(T * 192 + crec_rows * 64 + R * 12,
                    pairs[0] * SPHERE_OPS + pairs[1] * PAIR_OPS)


def pinned_share(torch, lane_steps, block):
    """The live share of pinned blocks (the kernel's earlier design):
    lane i in block i // block until the block's longest lane was done, so
    its slot-steps were the longest lane's steps x block; the live
    lane-steps are the lanes'."""
    ls = lane_steps.long()
    b = torch.nn.functional.pad(ls, (0, -ls.numel() % block)).reshape(-1, block)
    return float(ls.sum()) / float(b.amax(1).sum() * block)


def pass_lines(RP, stats):
    """The counters of a pass (RP.STATS), printed, and the pass's live
    share (live lane-steps over slot-steps) and overflow."""
    col = {name: int(v) for name, v in zip(RP.STATS, stats["counters"].cpu())}
    spent, end = RP.pass_times(stats["counters"])
    print(f"    blocks {col['blocks']}, block-steps {col['block_steps']}, slot-steps "
          f"{col['slot_steps']}, live lane-steps {col['live_steps']}; list spent "
          f"{'-' if spent is None else f'{spent:.3f}'} ms, end {end:.3f} ms")
    return {"live": col["live_steps"], "slot_steps": col["slot_steps"],
            "share": col["live_steps"] / max(col["slot_steps"], 1),
            "overflow": col["overflow"], "vote_chunks": col["vote_chunks"],
            "tail_ms": 0.0 if spent is None else end - spent}


# A table above kWholeMax (csrc/sphere_select.cuh) runs select_two's ring
# in B1r: the glossy stage unculled, held to the host loop in phase 16b.
RING_CASE = ("glossy fixed ring", "glossy", dict(mode="fixed", max_depth=DEPTH, illum=10.0), 4)


def regen_pass_vs_host(torch, scene, camera, smi):
    phase(f"16b. the regen pass kernel (B1r) vs the host loop with B1l on the card, {W}x{H}: "
          f"Cornell RR (rr_depth 5) {REGEN_SPP} spp, fixed depth {DEPTH} 16 spp, the glossy "
          "stage with chunk_cull 16 spp")
    from montecarlopathtracer_tpu_torch.models import glossy
    from montecarlopathtracer_tpu_torch.ops import regen_pass as RP
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key, stream_uniforms
    from montecarlopathtracer_tpu_torch.render.integrator import (
        TraceConfig,
        render_rows_planar,
        scene_tables,
    )
    from montecarlopathtracer_tpu_torch.render.regen import render_regen_planar
    from montecarlopathtracer_tpu_torch.testing import compare_images, plain_kernels

    # The kernel's camera formula against Camera.generate_rays_soa on the
    # card, both in torch ops: torch divides by the image size as a
    # multiply by its f32 reciprocal there, and so does the kernel.
    lanes = torch.arange(W * H, device="cuda")
    u = stream_uniforms(make_key(161), ((1 << 30) + 14, (1 << 30) + 15), W * H, "cuda")
    want = camera.generate_rays_soa(lanes % W, lanes // W, u[0] * 2.0 - 1.0, u[1] * 2.0 - 1.0,
                                    W, H)
    got = RP.camera_rays_ref(camera, lanes % W, lanes // W, u[0], u[1], W, H, scalar_div="card")
    diff = int((torch.cat(got) != torch.cat(want)).any(0).sum())
    lc, uc = lanes.cpu(), u.cpu()
    on_cpu = camera.to("cpu").generate_rays_soa(lc % W, lc // W, uc[0] * 2.0 - 1.0,
                                                uc[1] * 2.0 - 1.0, W, H)
    moved = int((torch.cat(on_cpu) != torch.cat(want).cpu()).any(0).sum())
    print(f"camera rays ({W * H} lanes): the kernel's formula under the card's division "
          f"rule differs from Camera.generate_rays_soa on the card on {diff} lanes; torch's "
          f"own rays differ between the CPU and the card on {moved} lanes")
    check(diff == 0, f"the kernel's camera formula differs from torch's on {diff} lanes")
    gscene, gcam = glossy.glossy_steps(width=W, height=H, device="cuda")
    scenes = {"cornell": (scene, camera), "glossy": (gscene, gcam)}
    out = {"err": 0.0, "launches": {}}
    for label, which, kw, spp in PASS_CASES:
        sc, cam = scenes[which]
        config = TraceConfig(**kw)
        tables = scene_tables(sc, config)
        key = fold_in(make_key(16), spp)
        kernel_id = "B1rc" if config.chunk_cull else "B1r"
        # The entry point: one launch of B1r, nothing else.
        reset_counts()
        img = render_regen_planar(sc, cam, key, W, H, spp, config, tables)
        torch.cuda.synchronize()
        counts = read_all_counts()
        others = {k: v for k, v in counts.items() if v and k != kernel_id}
        check(counts[kernel_id] == 1 and not others,
              f"{label}: render_regen_planar launched {counts}, expected one {kernel_id}")
        out["launches"][kernel_id] = out["launches"].get(kernel_id, 0) + counts[kernel_id]
        stats = {}
        accum, lane_steps = RP.regen_pass(tables, config, cam, key, W, H, spp, stats=stats)
        reset_counts()
        want, host_steps = RP.regen_pass_ref(tables, config, cam, key, W, H, spp)
        torch.cuda.synchronize()
        hc = read_all_counts()
        n_same = int((accum == want).all(0).sum())
        steps_same = bool(torch.equal(lane_steps, host_steps))
        err = float((accum - want).abs().max()) / spp
        out["err"] = max(out["err"], err)
        check(torch.equal(img, (accum / float(spp)).reshape(3, H, W)),
              f"{label}: the entry point's frame differs from the kernel's")
        ls = lane_steps.long()
        print(f"{label}, {spp} spp: lanes bit-equal {n_same} of {W * H}, lane_steps equal to "
              f"the host loop's {steps_same}; host loop launches {hc}")
        rl = pass_lines(RP, stats)
        block = RP.slots_per_block(config)
        pinned = pinned_share(torch, lane_steps, block)
        omax = "none staged" if stats["omax"] is None else f"{float(stats['omax'][0]):.6f}"
        print(f"  lane steps min / median / max {int(ls.min())} / {int(ls.median())} / "
              f"{int(ls.max())} (host loop {int(host_steps.max())}, backstop "
              f"{RP.max_steps(spp, config)}); live share {rl['share']:.4f} ({rl['live']} live "
              f"lane-steps of {rl['slot_steps']} slot-steps, grid {stats['grid']} blocks of "
              f"{block} slots); pinned blocks of {block} on the same lane_steps "
              f"{pinned:.4f}; list spent to the end {rl['tail_ms']:.3f} ms; origin bound "
              f"{omax}, overflow lane-steps {rl['overflow']}")
        check(n_same == W * H and steps_same,
              f"{label}: B1r differs from the host loop on {W * H - n_same} lanes, "
              f"lane_steps equal {steps_same}")
        check(rl["live"] == int(ls.sum()), f"{label}: live lane-steps {rl['live']} against the "
              f"lanes' steps {int(ls.sum())}")
        check(rl["overflow"] == 0, f"{label}: {rl['overflow']} lane-steps over the origin bound")
        # The list handed out longest first, as the Renderer orders its
        # passes from the second on: with more lanes than slots, each slot
        # takes lanes from the ordered list after its first, and every
        # lane must still be the host loop's, bit for bit.
        check(W * H > stats["grid"] * block, f"{label}: {stats['grid']} blocks of {block} "
              f"slots hold all {W * H} lanes at once, so no slot takes a second lane")
        ostats = {}
        ordered, ordered_steps = RP.regen_pass(tables, config, cam, key, W, H, spp,
                                               stats=ostats, order=RP.longest_first(lane_steps))
        n_ord = int((ordered == want).all(0).sum())
        ord_steps_same = bool(torch.equal(ordered_steps, host_steps))
        print(f"  longest first: lanes bit-equal {n_ord} of {W * H}, lane_steps equal to the "
              f"host loop's {ord_steps_same}")
        ro = pass_lines(RP, ostats)
        print(f"  longest first: live share {ro['share']:.4f} (row order {rl['share']:.4f}); "
              f"list spent to the end {ro['tail_ms']:.3f} ms (row order {rl['tail_ms']:.3f})")
        check(n_ord == W * H and ord_steps_same,
              f"{label}: B1r longest first differs from the host loop on {W * H - n_ord} "
              f"lanes, lane_steps equal {ord_steps_same}")
        check(ro["live"] == int(ls.sum()), f"{label}: longest first, live lane-steps "
              f"{ro['live']} against the lanes' steps {int(ls.sum())}")
        # At 1 spp no lane regenerates: the scan's frame, bit for bit.
        one, _ = RP.regen_pass(tables, config, cam, key, W, H, 1)
        scan1 = render_rows_planar(sc, cam, key, W, H, 0, H, config, tables)
        check(torch.equal(one.reshape(3, H, W), scan1), f"{label}: B1r at 1 spp differs "
              "from the scan")
        # The film mean against the scan's estimate from spp samples.
        means = [float(render_rows_planar(sc, cam, fold_in(key, i), W, H, 0, H, config,
                                          tables).mean()) for i in range(spp)]
        scan, sd = statistics.mean(means), statistics.stdev(means)
        se = sd * (2.0 / spp) ** 0.5
        film = float(accum.mean()) / spp
        print(f"  1 spp bit-equal to the scan: True; film mean {film:.6f} vs scan {scan:.6f} "
              f"({spp} spp each): {abs(film - scan) / se:.2f} standard errors ({se:.2e}); "
              "bound 5")
        check(abs(film - scan) <= 5.0 * se, f"{label}: the film mean is off the scan's")
        # The pass in turns: kernel, host loop, host loop, kernel (host clock).
        turns = {"kernel": [], "host": []}
        for name in ("kernel", "host", "host", "kernel"):
            fn = RP.regen_pass if name == "kernel" else RP.regen_pass_ref
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(tables, config, cam, key, W, H, spp)
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t0) * 1e3)
        if label == PASS_CASES[0][0]:
            # What the host loop's pass spends on the card, by kernel: B1l's
            # sum is what a pass costs the card in segments run in lockstep.
            profile_device(torch, f"host loop pass ({label})",
                           lambda: RP.regen_pass_ref(tables, config, cam, key, W, H, spp),
                           {"B1l mega_segment": "mega_segment_kernel",
                            "RNG uniform": "uniform_kernel"}, statistics.mean(turns["host"]))
            profile_device(torch, f"B1r pass ({label})",
                           lambda: RP.regen_pass(tables, config, cam, key, W, H, spp),
                           {"B1r regen_pass": "regen_pass_kernel"},
                           statistics.mean(turns["kernel"]))
        dev_label = f"{kernel_id} {label}"
        DEVICE_MS[dev_label] = device_ms(torch, lambda: RP.regen_pass(tables, config, cam, key,
                                                                      W, H, spp), n=10)
        pair = event_ms(torch, lambda: RP.regen_pass(tables, config, cam, key, W, H, spp))
        # The bound's work: the host loop once more, each step's pairs
        # counted on its wavefront.
        pairs = [0, 0, 0, 0]
        t0 = time.perf_counter()
        again, _ = RP.regen_pass_ref(tables, config, cam, key, W, H, spp,
                                     on_step=pass_pairs(torch, tables, config, pairs))
        count_s = time.perf_counter() - t0
        check(torch.equal(again, want), f"{label}: the host loop's pass differs between runs")
        crec = tables.crec.shape[0] if config.chunk_cull else 0
        bound = pass_bound(tables.rows.shape[0], W * H, pairs, crec)
        dms = DEVICE_MS[dev_label][0]
        print(f"  pass in turns: kernel {[round(t, 2) for t in turns['kernel']]} ms, host loop "
              f"{[round(t, 2) for t in turns['host']]} ms "
              f"({statistics.mean(turns['host']) / statistics.mean(turns['kernel']):.2f}x); "
              f"{W * H * spp / statistics.mean(turns['kernel']) / 1e3:.3f} Msamples/s")
        print(f"  {dev_label}: device {dms:.4f} ms per pass (queued events, 10 passes), event "
              f"pair {pair:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}: {pairs[0]} pairs "
              f"tested over the host loop's steps, {pairs[1]} of them inside a sphere; "
              f"{tables.rows.shape[0]} triangles; counted in {count_s:.1f} s), device time "
              f"at {bound[0] / dms:.3f} of it")
        vote = None
        if config.chunk_cull:
            # The culled vote's chunks per live lane-step: this kernel's
            # blocks, pinned groups of 128 lanes (B4c's vote on the
            # host loop's steps), and each ray's own need.
            vote = (rl["vote_chunks"] / rl["live"], pairs[2] / pairs[3],
                    pairs[0] / 128 / pairs[3])
            print(f"  the culled vote's chunks tested per live lane-step: this kernel "
                  f"{vote[0]:.4f}, pinned groups {vote[1]:.4f}, each ray's own reach "
                  f"{vote[2]:.4f} ({vote[0] / vote[2]:.2f}x and {vote[1] / vote[2]:.2f}x it)")
        out[label] = {"pair": pair, "bound": bound,
                      "lane_steps": (int(ls.min()), int(ls.median()), int(ls.max())),
                      "live_share": rl["share"], "pinned_share": pinned,
                      "vote": vote,
                      "turns": turns, "pairs": pairs[:2], "host_launches": hc,
                      "dev": dev_label}
    # The plain version on the card (every kernel plain) of each instance:
    # its time, and its frame against the kernel's.
    for label, which, kw, spp in (PASS_CASES[0], PASS_CASES[2]):
        sc, cam = scenes[which]
        config = TraceConfig(**kw)
        tables = scene_tables(sc, config)
        key = fold_in(make_key(16), spp)
        accum, _ = RP.regen_pass(tables, config, cam, key, W, H, spp)
        with plain_kernels():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain, _ = RP.regen_pass(tables, config, cam, key, W, H, spp)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        rep = compare_images((accum / spp).reshape(3, H, W).permute(1, 2, 0),
                             (plain / spp).reshape(3, H, W).permute(1, 2, 0))
        print(f"plain version ({label}, every kernel plain): {plain_ms:.1f} ms a pass; frame "
              f"against B1r's {rep}; lanes bit-equal {int((accum == plain).all(0).sum())}")
        check(rep["ok"], f"{label}: B1r's frame is off the plain version's: {rep}")
        out[label]["plain_ms"] = plain_ms
    # select_two's ring inside the pass (a table above kWholeMax): every
    # lane's accum and lane_steps against the host loop's, and its time.
    label, which, kw, spp = RING_CASE
    sc, cam = scenes[which]
    config = TraceConfig(**kw)
    tables = scene_tables(sc, config)
    key = fold_in(make_key(16), spp)
    stats = {}
    reset_counts()
    accum, lane_steps = RP.regen_pass(tables, config, cam, key, W, H, spp, stats=stats)
    torch.cuda.synchronize()
    counts = read_all_counts()
    want, host_steps = RP.regen_pass_ref(tables, config, cam, key, W, H, spp)
    n_same = int((accum == want).all(0).sum())
    steps_same = bool(torch.equal(lane_steps, host_steps))
    out["err"] = max(out["err"], float((accum - want).abs().max()) / spp)
    T = tables.rows.shape[0]
    print(f"{label} ({T} triangles, above kWholeMax), {spp} spp: launches {counts}; lanes "
          f"bit-equal {n_same} of {W * H}, lane_steps equal to the host loop's {steps_same}")
    rl = pass_lines(RP, stats)
    ms = device_ms(torch, lambda: RP.regen_pass(tables, config, cam, key, W, H, spp), n=3)[0]
    print(f"  live share {rl['share']:.4f}; device {ms:.4f} ms a pass")
    check(T > 760 and stats["omax"] is None, f"{label}: {T} rows, origin bound {stats['omax']}")
    check(counts["B1r"] == 1 and n_same == W * H and steps_same,
          f"{label}: B1r differs from the host loop on {W * H - n_same} lanes, lane_steps "
          f"equal {steps_same}, launches {counts}")
    check(rl["live"] == int(lane_steps.long().sum()) and rl["overflow"] == 0,
          f"{label}: counters {rl}")
    out[label] = {"ms": ms, "live_share": rl["share"]}
    print(f"on {smi}")
    return out


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
    from montecarlopathtracer_tpu_torch.ops.rng import make_key, stream_uniforms

    key = make_key(13)
    cam = camera_wavefront(torch, camera, BW, BH, key)
    pos, dir_, tput, res, live = cam
    cam = (pos, dir_.contiguous(), tput, res, live)
    R = BW * BH
    idx = TW.traverse_select(tables.rows, tables.clo, tables.chi, *cam[:2], live,
                             tables=tables.walk)
    u1, u2 = stream_uniforms(key, (0, 1), R, "cuda")
    out = F.rows_segment(tables.rows, idx, *cam, u1, u2, torch.zeros(R, device="cuda"),
                         config.segment_flags("cuda")[0])
    alive = out[4] > 0.0
    keys = torch.where(alive, ray_sort_keys(out[0], out[1], tables.lo, tables.hi), DEAD_KEY)
    order = torch.argsort(keys, stable=True)
    bounce = (*(x[:, order].contiguous() for x in out[:4]), alive[order].contiguous())
    return cam, bounce


def subset_of(torch, wave, sub):
    return tuple((x[:, sub] if x.dim() == 2 else x[sub]).contiguous() for x in wave)


def same_bits(torch, a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def tables_vs_earlier(torch, TW, rows, lo, hi, leaf, big):
    """B5t's one launch against the earlier two-kernel build of the same
    tables (bit for bit) and its tree against tree_ref over its own
    leaves (bit for bit: the climb); one launch counted."""
    before = read_all_counts()
    got = TW.walk_tables(rows, lo, hi, leaf, big)
    torch.cuda.synchronize()
    n = (read_all_counts() - before)["B5t"]
    old, _ = TW.walk_tables_split(rows, lo, hi, leaf, big)
    P, nc = got.leaves, lo.shape[0]
    ref = TW.tree_ref(lo, hi, got.tree[P:P + nc, 3], got.tree[P:P + nc, 7])
    return (n == 1 and same_bits(torch, got.tree, old.tree) and same_bits(torch, got.tri, old.tri)
            and same_bits(torch, got.tree, ref))


def walk_tables_vs_plain(torch, scene, tables):
    """B5's tables (tree and triangle records, as scene_tables built them
    with the kernel) against their plain version and against the earlier
    two-kernel build; their build timed, and the earlier build's two
    kernels apart. Returns (the leaf boxes (lo, hi), max |err| of the
    float fields, (event ms, plain ms, bound))."""
    from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW
    from montecarlopathtracer_tpu_torch.ops.morton import chunk_aabbs_padded, morton_order
    from montecarlopathtracer_tpu_torch.testing import HARD_SOUPS, hard_soup

    walk = tables.walk
    lo, hi, big = TW.walk_boxes(*scene.triangle_vertices(), scene.tri_valid, tables.perm)
    rows = tables.rows.detach()
    want = TW.walk_tables_ref(rows, lo, hi, TW.LEAF, big)
    box = [0, 1, 2, 4, 5, 6]
    check(torch.equal(walk.tree[:, box], want.tree[:, box]) and torch.equal(walk.big, big)
          and torch.equal(walk.tri[:, 4:], want.tri[:, 4:]),
          "B5's tree boxes, large triangles or record geometry differ from the plain version")
    fin = torch.isfinite(want.tri[:, 3])
    check(torch.equal(fin, torch.isfinite(walk.tri[:, 3])), "B5's infinite spheres differ")
    # The kernel contracts FMAs where the plain version rounds each step.
    # Centers and radii are held to 1e-5 of |c| + K0, grow to 1e-5 of
    # itself; ext, a slack K0 - rho computed by cancellation, to 1e-5 of
    # the largest K0 (it only widens the boxes).
    d_sph = (walk.tri[fin, :4] - want.tri[fin, :4]).abs()
    scale = want.tri[fin, :3].norm(dim=1, keepdim=True) + want.tri[fin, 3:4]
    d_ext = (walk.tree[:, 3] - want.tree[:, 3]).abs()
    d_grow = (walk.tree[:, 7] - want.tree[:, 7]).abs()
    rel = max(float((d_sph / scale).max()), float((d_ext / want.tri[fin, 3].max()).max()),
              float((d_grow / want.tree[:, 7].abs().clamp_min(1e-30)).max()))
    err = max(float(d_sph.max()), float(d_ext.max()), float(d_grow.max()))
    check(rel < 1e-5, f"B5's spheres, ext or grow differ from plain by {rel:.3e} of their "
          "scale")
    T, nb, P = rows.shape[0], lo.shape[0], walk.leaves
    check(tables_vs_earlier(torch, TW, rows, lo, hi, TW.LEAF, big)
          and tables_vs_earlier(torch, TW, rows, tables.clo, tables.chi, TW.CHUNK, None),
          "B5t differs from the earlier build, or its tree from tree_ref over its leaves")
    n_soups = 0
    for case in HARD_SOUPS:
        for n in (1, 20, 70, 1500):
            verts, srows, _, _ = hard_soup(case, n, 8, seed=n, device="cuda")
            valid = torch.ones(n, dtype=torch.bool, device="cuda")
            perm = morton_order(*verts, valid)
            for leaf in (TW.LEAF, TW.CHUNK):
                slo, shi = chunk_aabbs_padded(*verts, valid, perm, leaf)
                check(tables_vs_earlier(torch, TW, srows[perm].contiguous(), slo, shi, leaf,
                                        None), f"B5t on the {case} soup, T {n}, leaf {leaf}")
                n_soups += 1
    print(f"B5t (one launch) bit-equal to the earlier two-kernel build and its tree to tree_ref "
          f"over its own leaves: the bunny's leaves of {TW.LEAF} and chunks of {TW.CHUNK}, and "
          f"{n_soups} hard-soup tables (T = 1, 20, 70, 1500 in Morton order)")
    ms = time_pair(torch, lambda: TW.walk_tables(rows, lo, hi, TW.LEAF, big),
                   lambda: TW.walk_tables_ref(rows, lo, hi, TW.LEAF, big), label="B5t")
    out = TW.walk_tables_split(rows, lo, hi, TW.LEAF, big)
    split = {name: record_device(torch, f"B5t earlier {name}", lambda p=parts:
                                 TW.walk_tables_split(rows, lo, hi, TW.LEAF, big, parts=p,
                                                      out=out))[0]
             for name, parts in (("both", 3), ("records", 1), ("tree", 2))}
    print(f"the earlier two-kernel build: device {split['both']:.4f} ms per build, of which "
          f"triangle_records_kernel {split['records']:.4f} ms and tree_kernel (one block of "
          f"1,024 threads) {split['tree']:.4f} ms, timed apart; B5t, one launch of {P} warps: "
          f"{DEVICE_MS['B5t'][0]:.4f} ms")
    # Bytes: the rows' geometry and the boxes read, the records and the tree
    # written; operations: about 120 per triangle record (sphere_parts).
    bound = bound_of(T * 48 + nb * 24 + T * 64 + 2 * P * 32, T * 120)
    print(f"B5's tables: {nb} leaves of {TW.LEAF} triangles (P = {P}), {big.shape[0]} large "
          f"triangles listed apart; tree boxes, large list and record geometry bit-equal to "
          f"plain, spheres, ext and grow within {rel:.2e} of their scale ({err:.2e} "
          f"absolute); "
          f"build {ms[0]:.4f} ms (plain {ms[1]:.4f} ms)")
    device_line("B5t", ms[0], bound)
    return (lo, hi), err, (*ms, bound)


def traverse_vs_plain(torch, scene, tables, waves, sub):
    phase(f"17. traversal walk (B5): its tables vs plain, then B5 vs B4 on every lane and vs "
          f"plain brute selection on a subset, bunny {BW}x{BH}")
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW
    from montecarlopathtracer_tpu_torch.testing import compare_winners

    b5t = walk_tables_vs_plain(torch, scene, tables)
    R = BW * BH
    worst = 0.0
    zeros = torch.zeros(SUBSET, device="cuda")
    for name, wave in zip(("camera", "sorted bounce"), waves):
        pos, dir_, _, _, live = wave
        visits = torch.full((2, R), -1, dtype=torch.int32, device="cuda")
        got = TW.traverse_select(tables.rows, tables.clo, tables.chi, pos, dir_, live,
                                 tables=tables.walk, visits=visits)
        b4 = NS.nearest_shade_full(tables.rows, pos, dir_, live)[0]
        torch.cuda.synchronize()
        same = bool(torch.equal(got, b4))
        t_same = bool(torch.equal(winner_t(torch, tables.rows, got, pos, dir_),
                                  winner_t(torch, tables.rows, b4, pos, dir_)))
        p, d, tp, rs, lv = subset_of(torch, wave, sub)
        want = TW.traverse_select_ref(tables.rows, tables.clo, tables.chi, p, d, lv)
        rep = compare_winners(got[sub], want, live=lv, rows=tables.rows, pos=p, dir_=d)
        worst = max(worst, rep["max_t_gap"])
        # The brute CUDA kernel B1 runs B5's pair test in the same f32
        # arithmetic (FMA contraction included) over every triangle: where
        # B5 parts from the plain version, B1 must side with B5.
        brute = F.mega_segment(tables.rows, p, d, tp, rs, lv, zeros, zeros, zeros,
                               torch.zeros(3, 1, device="cuda"))[0]
        diff = lv & (got[sub] != want)
        n_b1 = int((brute[diff] == got[sub][diff]).sum())
        v = visits[:, live].float()
        n_live = int(live.sum())
        print(f"{name:13s}: {n_live} live of {R} rays; B5's idx equal to B4's on every lane: "
              f"{same}, t recomputed from the winners equal: {t_same}")
        print(f"{'':15s}on the subset of {SUBSET} ({rep['n_live']} live) winners agree with "
              f"plain {rep['idx_agree']:.6f} ({rep['n_idx_mismatch']} mismatches, all "
              f"near-ties: {rep['mismatches_all_near_ties']}, max t gap "
              f"{rep['max_t_gap']:.2e}); B1 sides with B5 on {n_b1} of them")
        print(f"{'':15s}per live ray: interior nodes mean {float(v[0].mean()):.2f} p99 "
              f"{float(v[0].quantile(0.99)):.0f} max {int(v[0].max())}, leaves of "
              f"{tables.walk.leaf} mean {float(v[1].mean()):.2f} p99 "
              f"{float(v[1].quantile(0.99)):.0f} max {int(v[1].max())}; dead lanes 0: "
              f"{bool((visits[:, ~live] == 0).all())}")
        check(same and t_same, f"B5's winners differ from B4's on the {name} wavefront on "
              f"{int((got != b4).sum())} lanes")
        check(rep["ok"], f"B5 disagrees with brute selection on the {name} wavefront: {rep}")
        check(n_b1 == rep["n_idx_mismatch"],
              f"B5 parts from the brute kernel B1 on {rep['n_idx_mismatch'] - n_b1} lanes "
              f"where it parts from plain ({name} wavefront)")
        check(bool((visits[:, ~live] == 0).all()) and bool((visits >= 0).all()),
              "visit counts of dead lanes")
    print("gate: B5's idx and t bit-equal to B4's on every lane; against plain, winners equal "
          "on >= 99.9% of live lanes, every mismatch a near-tie on which B1 agrees with B5")
    return worst, b5t


def rows_vs_plain(torch, tables, bounce):
    phase(f"18. segment from known winners (B6, B6l) vs plain, bunny {BW}x{BH} bounce")
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW
    from montecarlopathtracer_tpu_torch.ops.rng import make_key, stream_uniforms
    from montecarlopathtracer_tpu_torch.testing import compare_segment

    pos, dir_, tput, res, live = bounce
    R = pos.shape[1]
    idx = TW.traverse_select(tables.rows, tables.clo, tables.chi, pos, dir_, live,
                             tables=tables.walk)
    key = make_key(18)
    u1, u2, urr = stream_uniforms(key, (0, 1, 3), R, "cuda")
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


def time_bunny(torch, scene, tables, boxes, bounce, sub, idx, draws, cases):
    phase(f"19. bunny {BW}x{BH} bounce wavefront: B5, B6 and brute B1 timed")
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW

    pos, dir_, tput, res, live = bounce
    p, d, _, _, lv = subset_of(torch, bounce, sub)
    rows, clo, chi, walk = tables.rows, tables.clo, tables.chi, tables.walk
    b5 = time_pair(torch, lambda: TW.traverse_select(rows, clo, chi, pos, dir_, live,
                                                     tables=walk),
                   lambda: TW.traverse_select_ref(rows, clo, chi, p, d, lv), label="B5")
    u1, u2, urr = draws
    b6 = {name: time_pair(torch, lambda f=flags: F.rows_segment(
        rows, idx, pos, dir_, tput, res, live, u1, u2, urr, f),
        lambda f=flags: F.rows_segment_ref(rows, idx, pos, dir_, tput, res, live, u1, u2,
                                           urr, f), label=name) for name, flags in cases}
    fl = cases[0][1]
    sub_args = (*subset_of(torch, bounce, sub), u1[sub], u2[sub], urr[sub], fl)
    b1 = time_pair(torch, lambda: F.mega_segment(rows, pos, dir_, tput, res, live, u1, u2,
                                                 urr, fl),
                   lambda: F.mega_segment_ref(rows, *sub_args), label="B1 bunny")
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
    t_best = winner_t(torch, rows, idx, pos, dir_)
    # B5's bound: the sphere test of every triangle of the leaves each ray
    # reaches at its winner's t (and of the large triangles), the exact
    # test of those inside their spheres, counted on the subset and scaled
    # by live rays; its bytes are the tables, the rays and the winners.
    P, nb = walk.leaves, boxes[0].shape[0]
    ext, grow = walk.tree[P:P + nb, 3], walk.tree[P:P + nb, 7]
    sp = sphere_pairs(torch, rows, p, d, lv, boxes=dict(clo=boxes[0], chi=boxes[1]),
                      t_best=t_best[sub], step=256, box=walk.leaf, widen=(ext, grow),
                      always=walk.big, per_ray=True)
    scale = n_live / max(1, int(lv.sum()))
    tested, exact = sp[0] * scale, sp[1] * scale
    b5 = (*b5, bound_of(T * 64 + 2 * P * 32 + R * 29, tested * B5_SPHERE_OPS
                        + exact * PAIR_OPS))
    pairs = reached_pairs(torch, clo, chi, T, pos, dir_, live, t_best)
    old = bound_of(T * 192 + nc * 24 + R * 25 + R * 4, pairs * PAIR_OPS)
    for name, lane in (("B6", False), ("B6l", True)):
        nbytes = T * 192 + R * 4 + R * STATE_BYTES + (12 * R if lane else 12) + R * 52
        b6[name] = (*b6[name], bound_of(nbytes, hits * 40))
    print(f"bounds: B5 {b5[2][0]:.4f} ms ({b5[2][1]}; on the subset {sp[0]} pairs in the "
          f"leaves of {walk.leaf} reached at the winners' t and the {walk.big.shape[0]} large "
          f"triangles, {sp[1]} of them inside their spheres, x {scale:.3f} for all live rays: "
          f"{tested:.4g} sphere tests at {B5_SPHERE_OPS} operations, {exact:.4g} exact at "
          f"{PAIR_OPS}); old count {old[0]:.4f} ms ({old[1]}; {pairs:.4g} pairs of the "
          f"reached 128-triangle chunks at {PAIR_OPS} operations, of {n_live * T} live pairs); "
          f"B6 {b6['B6'][2][0]:.4f} ms ({b6['B6'][2][1]}), B6l {b6['B6l'][2][0]:.4f} ms "
          f"({b6['B6l'][2][1]})")
    for name, timing in (("B5", b5), ("B6", b6["B6"]), ("B6l", b6["B6l"])):
        device_line(name, timing[0], timing[2])
    print(f"B1 bunny (brute, every live pair): device {DEVICE_MS['B1 bunny'][0]:.4f} ms per "
          f"launch ({DEVICE_MS['B1 bunny'][1]})")
    walk_sweep(torch, scene, tables, bounce)
    return b5, b6, b1, old


def walk_sweep(torch, scene, tables, bounce):
    """B5 on the bounce wavefront with the tree's leaves at 16, 32 (the
    render path's) and 64 triangles, then on its 1,024 longest walks
    alone: the time of those few walks' chains of dependent loads is a
    floor under the whole launch's."""
    from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW

    pos, dir_, _, _, live = bounce
    rows, clo, chi = tables.rows, tables.clo, tables.chi
    verts = scene.triangle_vertices()
    for leaf in (16, TW.LEAF, 64):
        lo, hi, big = TW.walk_boxes(*verts, scene.tri_valid, tables.perm, leaf)
        walk = TW.walk_tables(rows, lo, hi, leaf, big)
        vis = torch.zeros(2, pos.shape[1], dtype=torch.int32, device="cuda")
        TW.traverse_select(rows, clo, chi, pos, dir_, live, tables=walk, visits=vis)
        v = vis[:, live].float()
        ms = device_ms(torch, lambda: TW.traverse_select(rows, clo, chi, pos, dir_, live,
                                                         tables=walk))[0]
        print(f"B5 with leaves of {leaf:2d}: device {ms:.4f} ms; per live ray interior nodes "
              f"mean {float(v[0].mean()):.2f} p99 {float(v[0].quantile(0.99)):.0f}, leaves "
              f"mean {float(v[1].mean()):.2f} p99 {float(v[1].quantile(0.99)):.0f}, "
              f"triangles in them {float(v[1].mean()) * leaf:.1f}")
    vis = torch.zeros(2, pos.shape[1], dtype=torch.int32, device="cuda")
    TW.traverse_select(rows, clo, chi, pos, dir_, live, tables=tables.walk, visits=vis)
    slow = torch.argsort(vis[0] + vis[1], descending=True)[:1024].sort().values
    p, d, lv = pos[:, slow].contiguous(), dir_[:, slow].contiguous(), live[slow].contiguous()
    ms = device_ms(torch, lambda: TW.traverse_select(rows, clo, chi, p, d, lv,
                                                     tables=tables.walk))[0]
    print(f"B5 on the 1024 longest walks alone (nodes mean "
          f"{float(vis[0][slow].float().mean()):.1f}, leaves mean "
          f"{float(vis[1][slow].float().mean()):.1f}): device {ms:.4f} ms")


def bunny_main_path(torch, scene, camera, config):
    phase(f"20. bunny main path: Renderer {BW}x{BH}, fixed depth {DEPTH} + gather, "
          "1 spp/pass, traverse + ray sort")
    import numpy as np

    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings

    settings = RenderSettings(width=BW, height=BH, spp_per_pass=1, seed=0)
    reset_counts()  # the Renderer builds B5's tables once
    r = Renderer(scene, camera, config, settings, device="cuda")
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
    print(f"launches: {counts} (expected {want} each of B5 and B6, one tables build B5t, "
          f"{want + 1 + BUNNY_TIMED} RNG)")
    check(counts["B5"] == want and counts["B6"] == want and counts["B5t"] == 1
          and counts["RNG"] == want + 1 + BUNNY_TIMED, f"launches {counts}")
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
    time splits the traverse_select span into the walk and the rest (the
    wrapper's host work and launch waits; the tree was built once, with
    the Renderer's tables)."""
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops import traverse_walk as TW
    from montecarlopathtracer_tpu_torch.ops.morton import DEAD_KEY, ray_sort_keys
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key, stream_uniforms

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
        u1, u2 = stream_uniforms(key, (4 * seg, 4 * seg + 1), R, "cuda")[:, rid]
        ev[2].record()
        idx = TW.traverse_select(tables.rows, tables.clo, tables.chi, pos, dir_, live,
                                 tables=tables.walk)
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
                           "B6 rows_segment": "rows_segment_kernel",
                           "RNG uniform": "uniform_kernel"}, per_pass * 1e3)
    if prof is not None:
        walk = prof["B5 traverse_select"]
        span = sum(ms["traverse_select"])
        print(f"traverse_select spans {span:.2f} ms per sample: B5 kernel {walk:.2f} ms "
              f"(profiled pass), the wrapper's host work and launch waits "
              f"{span - walk:.2f} ms; the tables build, once per Renderer: device "
              f"{DEVICE_MS['B5t'][0]:.4f} ms (phase 17)")


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
          and counts["B6"] == counts["B1"] == counts["B1l"] == 0
          and counts["RNG"] == 2 * steps + 1,
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
    print(f"launches: {counts} (expected {want} each of B5, B6, B2 and B3, and "
          f"{1 + BUNNY_GRAD_ITERS} tables builds B5t, one per iteration)")
    for name in ("B5", "B6", "B2", "B3"):
        check(counts[name] == want, f"{name} launched {counts[name]} times, expected {want}")
    check(counts["B3s"] == 0, f"the bunny's B3 took the small path {counts['B3s']} times")
    check(counts["B5t"] == 1 + BUNNY_GRAD_ITERS, f"B5t launched {counts['B5t']} times")
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
          f"{T:,} triangles x {idx.shape[0]:,} rays (two sort passes)")
    from montecarlopathtracer_tpu_torch.ops import scatter_rows as S

    worst = scatter_vs_plain(torch, idx, d_full, T,
                             f"{BUNNY_GRAD_W}x{BUNNY_GRAD_W} bunny vjp d_full")
    ms = time_pair(torch, lambda: S.scatter_rows(idx, d_full, T),
                   lambda: S.scatter_rows_ref(idx, d_full, T), label="B3 T81932")
    hits, R = int((idx >= 0).sum()), idx.shape[0]
    ms = (*ms, bound_of(R * 196 + T * 192, hits * 48), library_index_add(torch, idx, d_full, T))
    print(f"scatter_rows kernel {ms[0]:.4f} ms  plain {ms[1]:.4f} ms (median of 10, "
          f"{hits} rays hit of {R}, {T} triangles); bound {ms[2][0]:.4f} ms ({ms[2][1]}); "
          f"one index_add_ {ms[3]:.4f} ms")
    device_line("B3 T81932", ms[0], ms[2], library="index_add_ T81932")
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
# H100 SXM 32-bit integer instructions: 64 INT32 lanes per SM x 132 SMs x
# 1.98 GHz boost (the Hopper white paper's 33.5 TOPS counts a multiply-add
# as two; the threefry's adds, xors and funnel shifts are one each).
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# f32 operations of one ray-triangle pair test: o' (3 x 6), d' (3 x 5),
# one division, beta and gamma (2 x 2), 1 - (beta + gamma) (2).
PAIR_OPS = 40
# f32 operations of segment_fused.cu's `sphere_pass`, which B1/B1l/B1c
# run on every pair in front of the pair test: v = c - o (3), v.d (5),
# v.v (5), v.v d.d' - (v.d)^2 (3), r^2 d.d (1).
SPHERE_OPS = 17
# B5's sphere test: the same, after the radius K0 + grow |o| (2).
B5_SPHERE_OPS = SPHERE_OPS + 2
STATE_BYTES = 48 + 1 + 12  # pos, dir, tput, res f32[3]; live; u1, u2, urr
SEG_OUT_BYTES = 4 + 48 + 4  # idx, npos/ndir/ntput/nres f32[3], still


def bound_of(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """(bound_ms, bound_by): the least time for ``nbytes`` of device
    memory traffic (each input read once, each output written once) and
    ``ops`` operations of one type at the H100's published rates (f32
    outside the tensor cores unless ``ops_per_s`` says else). Operations
    count the ray-triangle arithmetic only (PAIR_OPS per tested pair,
    SPHERE_OPS per pair that B1's sphere test sees, 40 per recomputed
    winner, 48 adds per scattered row); the samplers' and vjps'
    arithmetic is left out, so an elementwise kernel's bound is a lower
    bound."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def segment_bound(T, R, pairs, lane=False, nc=0):
    """Bound of a whole segment (B1, B1l, B1c) on R rays over T triangles,
    from ``pairs`` = sphere_pairs(...): SPHERE_OPS for every pair its
    selection must test, PAIR_OPS more for each that passes the sphere
    test."""
    nbytes = T * 192 + R * STATE_BYTES + (12 * R if lane else 12) + nc * 32 + R * SEG_OUT_BYTES
    return bound_of(nbytes, pairs[0] * SPHERE_OPS + pairs[1] * PAIR_OPS)


def chunk_reach(torch, clo, chi, o, d, t_best, live, widen=None):
    """bool[s, nc]: the segment [0, t_best] of each of the rays o, d
    f32[s, 3] reaches the box of chunk j (widened as the kernels widen it:
    the box margin, and with ``widen`` = (ext, grow) f32[nc] also ext +
    grow |o|, as B1c's and B4c's chunk slack and B5's tree do), for the
    live rays: ops.cull.chunk_reach."""
    from montecarlopathtracer_tpu_torch.ops.cull import chunk_reach as reach

    slack = None if widen is None else torch.stack(widen, dim=1)
    return reach(clo, chi, o, d, t_best, slack) & live[:, None]


def reached_pairs(torch, clo, chi, T, pos, dir_, live, t_best, step=1 << 14, box=128,
                  widen=None):
    """Ray-triangle pairs that culling must test on these rays: for each
    live ray, the triangles of every chunk (of ``box`` triangles) whose
    box (widened as the kernels widen it, ``widen`` as chunk_reach takes
    it) its segment [0, t_best] reaches. The minimum work of a culling selection on this data (B4c;
    B5's old count)."""
    nc = clo.shape[0]
    sizes = torch.full((nc,), float(box), device=clo.device, dtype=torch.float64)
    sizes[-1] = T - box * (nc - 1)
    total = 0.0
    for s in range(0, pos.shape[1], step):
        reach = chunk_reach(torch, clo, chi, pos[:, s:s + step].T, dir_[:, s:s + step].T,
                            t_best[s:s + step], live[s:s + step], widen)
        total += float((reach.double() @ sizes).sum())
    return total


def sphere_pairs(torch, rows, pos, dir_, live, boxes=None, t_best=None, step=1 << 12, box=128,
                 widen=None, always=None, per_ray=False):
    """(tested, exact): the ray-triangle pairs that B1's selection must
    test on these rays, and those of them whose ray line meets the
    triangle's widened bounding sphere, so that the exact pair test runs.
    Tested pairs are live x T, or with culling (``boxes`` = the boxes of
    runs of ``box`` triangles, ``widen`` their widening as chunk_reach
    takes it, ``t_best`` the winners' t) the pairs of the boxes each ray's
    segment reaches, and the triangles ``always`` (B5's large ones) for
    every live ray. The spheres are sphere_select.cuh's `triangle_sphere`
    and `sphere_pass` computed in float64 on the same f32 rows, with the
    radius of the kernel's block of 256 rays, or with ``per_ray`` that of
    each ray's own |o| (B5); pairs on the rounding edge of the test may
    count on the other side."""
    T, R = rows.shape[0], pos.shape[1]
    g = rows[:, :12].double().reshape(T, 3, 4)
    r0, r1, r2 = g[:, 0, :3], g[:, 1, :3], g[:, 2, :3]
    a = -g[:, :, 3]
    cross = torch.linalg.cross
    c0, c1, c2 = cross(r1, r2), cross(r2, r0), cross(r0, r1)
    inv = 1.0 / (r0 * c0).sum(1)
    ex, ey = c0 * inv[:, None], c1 * inv[:, None]
    A = (a[:, :1] * c0 + a[:, 1:2] * c1 + a[:, 2:] * c2) * inv[:, None]
    mid = (ex + ey) / 3.0
    ctr = A + mid
    rho = torch.stack([(mid * mid).sum(1), ((ex - mid) ** 2).sum(1),
                       ((ey - mid) ** 2).sum(1)]).amax(0).sqrt()
    n_inv = (c0 * c0 + c1 * c1 + c2 * c2).sum(1).sqrt() * inv.abs()
    kappa = (g[:, :, :3] ** 2).sum((1, 2)).sqrt() * n_inv
    E = kappa * 2.0 ** -16
    K0 = rho + E * (ctr.norm(dim=1) + rho + n_inv * (a.norm(dim=1) + 1.0))
    ok = (kappa < 2.0 ** 16) & K0.isfinite()
    on = pos.double().norm(dim=0)
    if not per_ray:  # the block's largest finite |o| of a live ray (blocks of 256 rays)
        on = torch.where(live & (on < 3e38), on, 0.0)
        on = torch.nn.functional.pad(on, (0, -R % 256))
        on = on.reshape(-1, 256).amax(1).repeat_interleave(256)[:R]
    tested = exact = 0
    for s in range(0, R, step):
        o, d = pos[:, s:s + step].T.double(), dir_[:, s:s + step].T.double()
        mask = live[s:s + step, None].expand(-1, T)
        if boxes is not None:
            reach = chunk_reach(torch, boxes["clo"], boxes["chi"], pos[:, s:s + step].T,
                                dir_[:, s:s + step].T, t_best[s:s + step], live[s:s + step],
                                widen)
            mask = reach.repeat_interleave(box, dim=1)[:, :T]
            if always is not None:
                mask[:, always.long()] |= live[s:s + step, None]
        K = (K0[None] + 2.0 * E[None] * on[s:s + step, None]) * (1.0 + 2.0 ** -16)
        K = torch.where(ok[None] & (K < 2.0 ** 60), K, torch.inf)
        v = ctr[None] - o[:, None]
        b = (v * d[:, None]).sum(2)
        dd = (d * d).sum(1)[:, None]
        hit = (v * v).sum(2) * dd * (1.0 - 2.0 ** -18) - b * b <= K * K * dd
        tested += int(mask.sum())
        exact += int((mask & hit).sum())
    return tested, exact


def winner_t(torch, rows, idx, pos, dir_):
    """f32[R] hit distance of the winners ``idx`` (3e38 for a miss)."""
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F

    return F.recompute_rows(F.gather_rows(rows, idx), idx >= 0, pos, dir_)[0]


def versus_split(torch, rows, idx, pos, dir_, live, boxes=None, tested=None):
    """The whole-segment kernel's winners ``idx`` (B1, B1l, or B1c with
    chunk boxes and its ``tested`` counts) against the split path's
    kernel on the same rays and table (B4, or B4c with the same boxes):
    (idx bit-equal, t recomputed from the two kernels' winners bit-equal,
    tested counts equal or None without culling)."""
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS

    want_tested = None if tested is None else torch.full_like(tested, -1)
    b4 = NS.nearest_shade_full(rows, pos, dir_, live, tested=want_tested, **(boxes or {}))
    same = bool(torch.equal(idx, b4[0]))
    t_same = bool(torch.equal(winner_t(torch, rows, idx, pos, dir_),
                              winner_t(torch, rows, b4[0], pos, dir_)))
    return same, t_same, None if tested is None else bool(torch.equal(tested, want_tested))


def versus_control(torch, rows, pos, dir_, live):
    """B7 (on the shared selection loop) and B4 with the |d'_z| test against
    the control (nearest_triangle.cu's one-ray-per-thread loop without the
    sphere rejection) on the same table's geometry columns: (B7's idx
    bit-equal on every lane, B4's on every live lane and -1 on the
    others)."""
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS

    geom = rows[:, :12].contiguous()
    control = NS.nearest_triangle_control(geom, pos, dir_)
    b7 = NS.nearest_triangle(geom, pos, dir_)
    b4 = NS.nearest_shade_full(rows, pos, dir_, live, dz_test=True)[0]
    return (bool(torch.equal(b7, control)),
            bool(torch.equal(b4, torch.where(live, control, -1))))


def library_index_add(torch, idx, dvals, T):
    """Median ms of one ``index_add_`` computing the row scatter on the
    same inputs (the yardstick of B3; never called by the port), its
    zero-fill included; its device time (the fill and the index_add_
    kernels) goes into DEVICE_MS as "index_add_ T<T>"."""
    keep = idx >= 0
    rows = idx[keep].long()
    vals = dvals.T[keep].contiguous()

    def call():
        torch.zeros(T, 48, device="cuda").index_add_(0, rows, vals)

    return time_one(torch, call, label=f"index_add_ T{T}")


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
                vc = versus_split(torch, tables.rows, got[0], args[1], args[2], args[5],
                                  boxes=tables.cull_boxes, tested=tested)
                vb = versus_split(torch, tables.rows, b1[0], args[1], args[2], args[5])
                check(all(vc) and vb[0] and vb[1],
                      f"B1c/B1 winners or tested counts differ from B4c/B4 ({wname} {cname}): "
                      f"{vc} {vb}")
                t = tested.float()
                print(f"{wname:13s} {cname:5s} {'lane' if lane else 'scalar'} flags: idx agree "
                      f"{rep['idx_agree']:.6f} ({rep['n_idx_mismatch']} near-tie mismatches of "
                      f"{rep['n_live']} live), max |err| "
                      + " ".join(f"{k} {v:.2e}" for k, v in rep["max_abs_err"].items())
                      + f"; bit-identical to B1: {same}; idx, t and tested equal to B4c's: "
                      f"{all(vc)}; B1's idx and t equal to B4's: {vb[0] and vb[1]}; chunks "
                      f"tested per group of 128 rays mean {float(t.mean()):.2f} max "
                      f"{int(t.max())} of {nc}")
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
        same = versus_control(torch, table, pos, dir_, live)
        print(f"{wname:21s} B7 : idx agree {rep['idx_agree']:.6f} ({rep['n_idx_mismatch']} "
              f"near-tie mismatches of {rep['n_live']} rays, max t gap {rep['max_t_gap']:.2e}); "
              f"bit-equal to the control loop: {same[0]}; B4 with the d'z test bit-equal to "
              f"the control on the live lanes: {same[1]}")
        check(rep["ok"], f"B7 disagrees with plain on {wname}: {rep}")
        check(all(same), f"B7 or B4 with the d'z test differs from the control on {wname}")
    print("gate: winners as phase 17's; on agreeing lanes the shading rows equal and t, beta, "
          "gamma within rtol = atol = 1e-5, or within 16 x eps32 x their rounding scale of the "
          "float64 values")
    return worst


def time_split_kernels(torch, rows, cornell_bounce, gtables, gbounce):
    phase("26. B4, B7 and its control loop on the Cornell first bounce, B1c and B4c on the "
          "glossy sorted bounce: kernel, plain, and B1 on the same wavefront (median of 10 "
          "CUDA events)")
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.rng import make_key

    out = {}
    pos, dir_, _, _, live = cornell_bounce
    T, R, n_live = rows.shape[0], pos.shape[1], int(live.sum())
    args = seg_args(torch, rows, *cornell_bounce, make_key(26), [0.0, 0.0, 0.0])
    b1 = time_one(torch, lambda: F.mega_segment(*args))
    ms = time_pair(torch, lambda: NS.nearest_shade_full(rows, pos, dir_, live),
                   lambda: NS.nearest_shade_full_ref(rows, pos, dir_, live), label="B4")
    # B4 and B4c are counted as B1 and B1c: the sphere test on every pair
    # they must test, the exact test on those inside a sphere.
    spairs = sphere_pairs(torch, rows, pos, dir_, live)
    out["B4"] = (*ms, bound_of(T * 192 + R * 25 + R * 148,
                               spairs[0] * SPHERE_OPS + spairs[1] * PAIR_OPS))
    geom = rows[:, :12].contiguous()
    ms = time_pair(torch, lambda: NS.nearest_triangle(geom, pos, dir_),
                   lambda: NS.nearest_triangle_ref(geom, pos, dir_), label="B7")
    # B7 has no live mask: every ray is tested, as B4 counts its live ones.
    every = torch.ones_like(live)
    b7_pairs = sphere_pairs(torch, rows, pos, dir_, every)
    out["B7"] = (*ms, bound_of(T * 48 + R * 24 + R * 4,
                               b7_pairs[0] * SPHERE_OPS + b7_pairs[1] * PAIR_OPS))
    control = time_one(torch, lambda: NS.nearest_triangle_control(geom, pos, dir_),
                       label="B7 control")
    print(f"Cornell first bounce ({n_live} live of {R} rays, {T} triangles): B1 {b1:.4f} ms; "
          f"B4 {out['B4'][0]:.4f} ms (plain {out['B4'][1]:.4f}); B7 {out['B7'][0]:.4f} ms "
          f"(plain {out['B7'][1]:.4f}, every ray tested; {b7_pairs[0]} pairs, "
          f"{b7_pairs[1]} inside a sphere); the control loop {control:.4f} ms, device "
          f"{DEVICE_MS['B7 control'][0]:.4f} ms")

    pos, dir_, _, _, live = gbounce
    gr, boxes = gtables.rows, gtables.cull_boxes
    T, R, n_live, nc = gr.shape[0], pos.shape[1], int(live.sum()), gtables.clo.shape[0]
    args = seg_args(torch, gr, *gbounce, make_key(26), [0.0, 0.0, 0.0])
    b1 = time_one(torch, lambda: F.mega_segment(*args))
    ms = time_pair(torch, lambda: F.mega_segment(*args, **boxes),
                   lambda: F.mega_segment_ref(*args), label="B1c")
    tested = {k: torch.zeros(-(-R // 128), dtype=torch.int32, device="cuda")
              for k in ("B1c", "B4c")}
    idx = F.mega_segment(*args, **boxes, tested=tested["B1c"])[0]
    NS.nearest_shade_full(gr, pos, dir_, live, **boxes, tested=tested["B4c"])
    t_best = winner_t(torch, gr, idx, pos, dir_)
    widen = tuple(gtables.cslack.T)
    pairs = reached_pairs(torch, gtables.clo, gtables.chi, T, pos, dir_, live, t_best,
                          widen=widen)
    spairs = sphere_pairs(torch, gr, pos, dir_, live, boxes=boxes, t_best=t_best, widen=widen)
    check(spairs[0] == pairs, f"reached pairs {pairs} but {spairs[0]} counted for B1c")
    out["B1c"] = (*ms, segment_bound(T, R, spairs, nc=nc))
    ms = time_pair(torch, lambda: NS.nearest_shade_full(gr, pos, dir_, live, **boxes),
                   lambda: NS.nearest_shade_full_ref(gr, pos, dir_, live), label="B4c")
    out["B4c"] = (*ms, bound_of(T * 192 + nc * 32 + R * 25 + R * 148,
                                spairs[0] * SPHERE_OPS + spairs[1] * PAIR_OPS))
    print(f"glossy sorted bounce ({n_live} live of {R} rays, {T} triangles, {pairs:.4g} of "
          f"{n_live * T} live pairs reachable, {spairs[1]} of them inside B1c's spheres): "
          f"B1 {b1:.4f} ms; B1c {out['B1c'][0]:.4f} ms "
          f"(plain {out['B1c'][1]:.4f}); B4c {out['B4c'][0]:.4f} ms (plain "
          f"{out['B4c'][1]:.4f})")
    groups = tested["B1c"].float()
    live_groups = torch.nn.functional.pad(live, (0, -R % 128)).reshape(-1, 128).any(1)
    print(f"chunks tested per group of 128 rays with the chunk slack: B1c mean "
          f"{float(groups.mean()):.3f} (over groups with a live ray "
          f"{float(groups[live_groups].mean()):.3f}), max "
          f"{int(groups.max())} of {nc}; B4c's equal to B1c's: "
          f"{bool(torch.equal(tested['B1c'], tested['B4c']))} (the earlier run's phase 24: "
          f"camera {EARLIER_TESTED['camera']}, sorted bounce "
          f"{EARLIER_TESTED['sorted bounce']})")
    check(torch.equal(tested["B1c"], tested["B4c"]), "B1c and B4c tested other chunks")
    for name, (k, p, (bms, by)) in out.items():
        print(f"  {name:3s} bound {bms:.4f} ms ({by}): kernel at {bms / k:.3f} of it")
    for name, (k, p, bound) in out.items():
        device_line(name, k, bound)
    return out


# Operations per record of B4r: the sphere of triangle_sphere_split (three
# cross products, an inverse, the vertex offsets, four norms: ~160), K0, the
# zero test and its share of the leaf box's reduction.
RECORD_OPS = 190


def records_vs_plain(torch, gtables):
    phase("26b. the culled loop's records (B4r, nearest_shade.cu's cull_records_kernel) vs "
          "plain on the glossy table (1,332 rows), timed")
    from montecarlopathtracer_tpu_torch.ops import cull as CU

    rows = gtables.rows.detach()
    T = rows.shape[0]
    got = CU.cull_records(rows)
    torch.cuda.synchronize()
    want = CU.cull_records_ref(rows)
    finite = want.isfinite()
    pattern = bool(torch.equal(got.isnan(), want.isnan()) and
                   torch.equal(got.isinf(), want.isinf()) and
                   torch.equal(got[got.isinf()], want[want.isinf()]))
    geometry = bool(torch.equal(got[:T, 4:], rows[:, :12]))
    err = (got - want)[finite].abs()
    worst = float((err / (want[finite].abs() + 1.0)).max())
    print(f"records {tuple(got.shape)}: geometry rows equal {geometry}; NaN and inf where "
          f"plain has them {pattern}; max |err| {float(err.max()):.3e}, at most "
          f"{worst:.3e} x (1 + |plain|) (tolerance 1e-4: the kernel contracts to FMAs)")
    check(pattern and geometry and worst <= 1e-4, "B4r's records disagree with plain")
    ms = time_pair(torch, lambda: CU.cull_records(rows), lambda: CU.cull_records_ref(rows),
                   label="B4r")
    bound = bound_of(T * 48 + got.numel() * 4, T * RECORD_OPS)
    print(f"B4r {ms[0]:.4f} ms (plain {ms[1]:.4f})")
    device_line("B4r", ms[0], bound)
    return float(err.max()), (*ms, bound)


def _b4_chunk(torch):
    """Each chunk's own winners for ops.cull.chunk_winners, from B4 on the
    card: the bits of the culled kernels' exact tests."""
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS

    def select(rows, pos, dir_):
        every = torch.ones(pos.shape[1], dtype=torch.bool, device=pos.device)
        idx, tbg, _ = NS.nearest_shade_full(rows, pos, dir_, every)
        return tbg[0], idx

    return select


def visits_check(torch, rows, boxes, pos, dir_, live):
    """ops.cull.cull_visits on these rays (each leaf's winners from B4), and
    B4c's tested counts against the emulation of its rule: (the
    emulation's result, equal)."""
    from montecarlopathtracer_tpu_torch.ops import cull as CU
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS

    out = CU.cull_visits(rows, boxes["clo"], boxes["chi"], boxes["cslack"], pos, dir_, live,
                         winners=CU.chunk_winners(rows, pos, dir_, select=_b4_chunk(torch),
                                                  chunk=CU.LEAF))
    tested = torch.full((-(-pos.shape[1] // 128),), -1, dtype=torch.int32, device="cuda")
    NS.nearest_shade_full(rows, pos, dir_, live, tested=tested, **boxes)
    torch.cuda.synchronize()
    return out, bool(torch.equal(tested.long(), out["tested"]))


def cull_visits_phase(torch, gscene, gtables, gwaves):
    phase("26c. the culled loop's visits (ops.cull.cull_visits): chunks tested per live ray "
          "under each rule, glossy camera and sorted bounce over the 1,332-row table and "
          "B10c's and B11's 1,408-row one; B4c's tested counts against the emulation of its "
          "rule; B4c and B1c against B4 on the twelve hard soups in Morton order (T = 700 "
          "and 1500) and the tie soup")
    from montecarlopathtracer_tpu_torch.ops import cull as CU
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.morton import chunk_aabbs_padded, morton_order
    from montecarlopathtracer_tpu_torch.testing import HARD_SOUPS, hard_soup, tie_soup

    for k, rule in CU.RULES.items():
        print(f"  ({k}) {rule}")
    v = variant_setup(torch, gscene)
    rows_p = v["rows_p"]
    boxes_p = dict(clo=v["boxes_c"][0], chi=v["boxes_c"][1], cslack=v["cslack_p"],
                   crec=CU.cull_records(rows_p))
    counts = {}
    for tname, rows, boxes in (("1,332 rows", gtables.rows, gtables.cull_boxes),
                               ("1,408 rows", rows_p, boxes_p)):
        for wname, wave in zip(("camera", "sorted bounce"), gwaves):
            pos, dir_, _, _, live = wave
            visits, same = visits_check(torch, rows, boxes, pos, dir_, live)
            mean = counts[(tname, wname)] = visits["mean"]
            print(f"glossy {wname:13s} {tname}: chunks per live ray " +
                  " ".join(f"({k}) {x:.4f}" for k, x in mean.items()) +
                  f"; leaves of {CU.LEAF} per live ray under (d) {visits['leaves']:.4f}; B4c's "
                  f"tested equal to the emulation of (d): {same}")
            check(same, f"B4c's tested counts differ from the emulation ({wname}, {tname})")
    R = 16384
    soups = [(f"{case} T={T}", *hard_soup(case, T, R, seed=T, device="cuda"))
             for case in HARD_SOUPS for T in (700, 1500)]
    tverts, trows, tclo, tchi, tpos, tdir = tie_soup(device="cuda", R=R, seed=3)
    n_soups = 0
    for name, verts, rows, pos, dir_ in soups + [("tie soup", tverts, trows, tpos, tdir)]:
        T = rows.shape[0]
        live = torch.ones(pos.shape[1], dtype=torch.bool, device="cuda")
        if name == "tie soup":
            clo, chi = tclo, tchi  # its chunks as they are: the copies lie in chunk 2
        else:
            valid = torch.ones(T, dtype=torch.bool, device="cuda")
            perm = morton_order(*verts, valid)
            rows = rows[perm].contiguous()
            clo, chi = chunk_aabbs_padded(*verts, valid, perm, 128)
        boxes = dict(clo=clo, chi=chi, cslack=CU.chunk_slack(rows), crec=CU.cull_records(rows))
        want = NS.nearest_shade_full(rows, pos, dir_, live)
        got = NS.nearest_shade_full(rows, pos, dir_, live, **boxes)
        ones = torch.ones(3, pos.shape[1], device="cuda")
        u = torch.full((pos.shape[1],), 0.5, device="cuda")
        b1c = F.mega_segment(rows, pos, dir_, ones, ones, live, u, u, u,
                             torch.zeros(3, 1, device="cuda"), **boxes)[0]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(b1c, want[0])
        visits, tested_same = visits_check(torch, rows, boxes, pos, dir_, live)
        mean = visits["mean"]
        kept = torch.equal(visits["idx"], want[0].long())
        check(same and tested_same and kept, f"B4c or B1c differ from B4, or tested or the "
              f"winners from the emulation, on {name}")
        n_soups += 1
        if name in ("random T=1500", "tie soup"):
            print(f"{name}: B4c and B1c bit-equal to B4; chunks per live ray " +
                  " ".join(f"({k}) {x:.4f}" for k, x in mean.items()))
    print(f"{n_soups} soups: B4c's idx, tbg and shade and B1c's idx bit-equal to B4's, B4c's "
          f"tested and the winners equal to the emulation of its rule (leaf boxes included)")
    return counts


def cull_main_path(torch, scene, camera, config):
    phase(f"27. cull main path: Renderer glossy {GW}x{GH}, fixed depth {DEPTH} + gather, "
          f"{CULL_SPP} spp/pass, chunk_cull + ray_sort")
    import dataclasses

    import numpy as np

    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.render.integrator import render_sample_batch
    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
    from montecarlopathtracer_tpu_torch.testing import compare_images

    reset_counts()  # from the Renderer's tables on: B4r builds the records once
    r = Renderer(scene, camera, config,
                 RenderSettings(width=GW, height=GH, spp_per_pass=CULL_SPP, seed=0),
                 device="cuda")
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
    print(f"launches: {counts} (expected {want} of B1c and no other segment kernel, one "
          f"records build B4r)")
    check(counts["B1c"] == want and counts["B1"] == counts["B1l"] == 0 and counts["B4r"] == 1,
          f"launches {counts}")
    profile_device(torch, "glossy cull pass", lambda: r.render(1),
                   {"B1c mega_segment": "mega_segment_kernel", "RNG uniform": "uniform_kernel"},
                   dt / CULL_TIMED * 1e3)
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
    phase(f"28. split path against the whole segment (tools/wseg_check.py::forward): Renderer "
          f"Cornell {W}x{H}, {SPP} spp/pass, whole_segment=False then True; then one pass "
          "of the fused intersector")
    import numpy as np

    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
    from montecarlopathtracer_tpu_torch.tools import wseg_check

    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0, whole_segment=False)
    reset_counts()
    rep = wseg_check.forward(scene, camera, width=W, height=H, spp=SPP, passes=SPLIT_TIMED,
                             device="cuda")
    counts = read_all_counts()
    split, whole, film = rep["split"], rep["whole_segment"], rep["film"]
    msps, dt = split["msamples_s"], split["seconds_per_pass"] * SPLIT_TIMED
    want = config.num_segments * SPP * (1 + SPLIT_TIMED)
    print(f"split: warm-up pass {split['warmup_s']:.3f} s; {SPLIT_TIMED} timed passes "
          f"{dt:.3f} s = {split['seconds_per_pass']:.4f} s/pass, split forward {msps:.4f} "
          f"Msamples/s; whole segment {whole['seconds_per_pass']:.4f} s/pass")
    print(f"launches: {counts} (expected {want} of B4 for the split path, {want} of B1 for "
          "the whole segment, no B4c)")
    check(counts["B4"] == want and counts["B1"] == want and counts["B4c"] == 0,
          f"launches {counts}")
    print(f"split film against the whole-segment film of the same passes: pixels within "
          f"1e-4 {film['pixel_share']:.5f}, max |err| {film['max_abs_err']:.3e}, mean rel "
          f"{film['mean_rel']:.2e}, split film mean {split['film_mean']:.5f}")
    check(rep["ok"], f"the split film disagrees with the whole-segment film: {rep}")
    settings = RenderSettings(width=W, height=H, spp_per_pass=SPP, seed=0)
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
    phase(f"29. split-path gradient against the whole segment's (tools/wseg_check.py::"
          f"gradient): value and grad, {W}x{H}, {GRAD_SPP} spp, one warm-up and one timed "
          "iteration each, the same keys")
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
    from montecarlopathtracer_tpu_torch.tools import wseg_check

    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0, whole_segment=False)
    reset_counts()
    rep = wseg_check.gradient(scene, camera, width=W, height=H, spp=GRAD_SPP, iters=1,
                              device="cuda")
    counts = read_all_counts()
    split, whole = rep["grad_split"], rep["grad_whole"]
    dt = split["seconds_per_iteration"]
    want = config.num_segments * GRAD_SPP * 2
    print(f"one iteration {dt:.4f} s, split fwd+bwd {split['msamples_s']:.4f} Msamples/s "
          f"(loss {split['loss']:.6f}); whole segment {whole['seconds_per_iteration']:.4f} s; "
          f"launches {counts} (expected {want} of B4, of B1 and of B2, {2 * want} of B3)")
    check(counts["B4"] == want and counts["B1"] == want and counts["B2"] == want
          and counts["B3"] == 2 * want, f"split gradient launches {counts}")
    g = rep["grads"]
    print(f"loss {split['loss']:.7f} vs whole {whole['loss']:.7f}; "
          + " ".join(f"{k} max |err| {v['max_abs_err']:.3e} of {v['scale']:.3e}"
                     for k, v in g.items() if k != "ok")
          + f" (tolerance {wseg_check.GRAD_TOL:g} x (|ref| + max |ref|), loss "
          f"{wseg_check.LOSS_RTOL:g})")
    check(rep["ok"], f"split-path gradients disagree with the whole segment's: {rep}")
    return counts, dt


def geometry_step(torch):
    phase(f"30. geometry step (BASELINE config 5): lamp translation at {W}x{H}, fixed depth "
          f"{GEOM_DEPTH}, {GEOM_SPP} spp, {GEOM_EDGES} edge samples, split path (B4)")
    from montecarlopathtracer_tpu_torch.diff.boundary import lamp_mask, make_translation_problem
    from montecarlopathtracer_tpu_torch.models import cornell
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key
    from montecarlopathtracer_tpu_torch.render.integrator import (
        TraceConfig,
        render_sample_batch,
    )

    scene, camera = cornell.cornell_box(width=W, height=H, device="cuda")
    config = TraceConfig(mode="fixed", max_depth=GEOM_DEPTH, whole_segment=False)
    tri_mask = lamp_mask(scene)
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


# ------------------------- the selection entries, the microkernels, the KD tree

GATE_RAYS = 8192  # tpu_check's rays: 4,096 camera rays of a 64x64 frame, 4,096 random
BENCH_SUBSET = 16_384  # kernel_bench rays per scene on which B8-B10 are compared with plain
BENCH_KERNELS = {"v1": "B8", "v2": "B9", "v3": "B10", "v3_cull_tc128": "B10c"}
CHAIN_OPS = 12  # f32 operations of one accept chain: reciprocal, t, beta, gamma,
# 1 - (beta + gamma), four comparisons and the select
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
SMEM_BYTES_PER_CLK = 128  # shared memory per SM and clock (32 banks of 4 bytes)
SM_CLOCK_HZ = 1.98e9  # H100 SXM's highest SM clock (NVIDIA data sheet)
KD_SPP = 1


def selection_builds(libs):
    phase("31. build: the selection microkernels (selection_micro.cu), the native host "
          "library (g++) and the Cornell box's KD tree, native against Python")
    import numpy as np

    from montecarlopathtracer_tpu_torch import native
    from montecarlopathtracer_tpu_torch.accel import kdtree as K
    from montecarlopathtracer_tpu_torch.models import cornell
    from montecarlopathtracer_tpu_torch.ops import cuda_build

    print(f"built {libs['selection_micro'].relative_to(HERE)} from {MICRO_SOURCE} (sm_90a)")
    ptxas_report(libs["selection_micro"])
    cuda_build.load("selection_micro")
    micro_sass(libs["selection_micro"])
    t0 = time.perf_counter()
    lib = native.build()
    check(native.available(), f"native library: {native.build_error()}")
    print(f"g++ built {lib.relative_to(HERE)} from native/mcpt_native.cpp in "
          f"{time.perf_counter() - t0:.2f} s")
    scene, _ = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True)
    a, b, c = (x.numpy() for x in scene.triangle_vertices())
    valid = scene.tri_valid.numpy()
    t0 = time.perf_counter()
    nat = K.build_flat_kdtree(a, b, c, valid, backend="native")
    t1 = time.perf_counter()
    py = K.build_flat_kdtree(a, b, c, valid, backend="python")
    t2 = time.perf_counter()
    same = all(np.array_equal(getattr(nat, f), getattr(py, f)) for f in
               ("node_lo", "node_hi", "node_skip", "leaf_start", "leaf_count", "leaf_tris"))
    print(f"KD tree of {scene.num_triangles} triangles: {nat.num_nodes} nodes, "
          f"{len(nat.leaf_tris)} leaf entries, largest leaf {int(nat.leaf_count.max())}; native "
          f"{(t1 - t0) * 1e3:.1f} ms, Python {(t2 - t1) * 1e3:.1f} ms; bit-equal: {same}")
    check(same, "the native KD tree differs from the Python build's")


def micro_sass(lib):
    """B12's instructions in cuobjdump's SASS of ``lib``, per B12 kernel:
    its tensor-core products (HMMA), ldmatrix loads (LDSM), global stores
    (STG: the source stores out i32[R] only) and local-memory traffic
    (STL/LDL: nothing may spill to device memory)."""
    from montecarlopathtracer_tpu_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    sass = run_tool([cuobjdump, "-sass", str(lib)])
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(("HMMA", "LDSM", "STG", "STL", "LDL"), 0)
        elif fn is not None:
            words = line.replace(";", " ").split()
            for name in counts[fn]:
                if any(w.split(".")[0] == name for w in words):
                    counts[fn][name] += 1
    b12 = {k: v for k, v in counts.items() if "contract_select_kernel" in k}
    for name, c in b12.items():
        print(f"  SASS of {name[-30:]}: {c}")
    check(len(b12) == 3 and all(c["HMMA"] > 0 and c["STL"] == c["LDL"] == 0
                                for c in b12.values()),
          f"B12's kernels lack tensor-core instructions or touch local memory: {b12}")
    print("B12 issues bf16 tensor-core instructions (HMMA) in all three variants; its global "
          "stores (STG) are those of out i32[R], and no register spills to local memory")


def variant_setup(torch, scene):
    """The packings of B8-B11 for ``scene`` padded to a multiple of 128
    triangles (as the JAX scenes are): a dict of tensors on the card."""
    from montecarlopathtracer_tpu_torch.ops import nearest_variants as NV
    from montecarlopathtracer_tpu_torch.ops.cull import chunk_slack
    from montecarlopathtracer_tpu_torch.ops.intersect import triangle_transforms
    from montecarlopathtracer_tpu_torch.ops.morton import chunk_aabbs, chunk_aabbs_padded
    from montecarlopathtracer_tpu_torch.ops.morton import morton_order
    from montecarlopathtracer_tpu_torch.tools.kernel_bench import pad_scene

    s = pad_scene(scene)  # B9's and B11's packings need the JAX padding
    a, b, c = s.triangle_vertices()
    m, m_a = triangle_transforms(a, b, c)
    valid, T = s.tri_valid, s.num_triangles
    perm = morton_order(a, b, c, valid)
    table = NV.pack_shading_table(s)
    w = NV.pack_transforms(m, m_a, valid)
    tc = NV.divisor_chunk(T, NV.T_CHUNK)
    wp = NV.pack_transforms(m[perm], m_a[perm], valid[perm])
    box = 256 if T % 256 == 0 else 128  # JAX nearest_shade_culled's chunk, min(256, T)
    rows_p = NV._rows(NV._geometry(wp), table[perm])
    return dict(
        T=T, perm=perm, table=table, w=w, geom=NV._geometry(w).contiguous(), tc=tc,
        wf=NV.pack_transforms_fused(m, m_a, valid, tc),
        ws=NV.pack_transforms_stream(m, m_a, valid, 256),
        wp=wp, tp=table[perm].contiguous(), gp=NV._geometry(wp).contiguous(),
        ws_c=NV.pack_transforms_stream(m[perm], m_a[perm], valid[perm], 128),
        boxes_c=chunk_aabbs_padded(a, b, c, valid, perm, 128),
        box=box, boxes_11=chunk_aabbs(a, b, c, valid, perm, box),
        rows=NV._rows(NV._geometry(w), table), rows_p=rows_p,
        cslack_p=chunk_slack(rows_p),  # B4c's tiles' slack, once per table
    )


def variant_calls(torch, v, pos, dir_, live):
    """``{name: (call, row table of its indices, whether it takes the live
    mask)}`` of B8-B11 on rays ``pos``, ``dir_``."""
    from montecarlopathtracer_tpu_torch.ops import nearest_variants as NV

    return {
        "B8": (lambda: NV.nearest_shade(v["w"], v["table"], pos, dir_), v["rows"], False),
        "B9": (lambda: NV.nearest_shade2(v["wf"], v["geom"], v["table"], pos, dir_,
                                         t_chunk=v["tc"]), v["rows"], False),
        "B10": (lambda: NV.nearest_shade_streamed(v["ws"], v["geom"], v["table"], pos, dir_,
                                                  live, t_chunk=256), v["rows"], True),
        "B10c": (lambda: NV.nearest_shade_streamed(v["ws_c"], v["gp"], v["tp"], pos, dir_, live,
                                                   *v["boxes_c"], t_chunk=128, cull=True,
                                                   cslack=v["cslack_p"]),
                 v["rows_p"], True),
        "B11": (lambda: NV.nearest_shade_culled(v["wp"], v["tp"], *v["boxes_11"], pos, dir_,
                                                live, v["cslack_p"]), v["rows_p"], True),
    }


# The torch ops of B8-B10 ahead of their B4 launch: the unpacking that each
# entry of ops/nearest_variants.py calls, on the inputs of variant_calls.
ENTRY_OPS = {
    "B8": lambda NV, v: NV.rows_from_w(v["w"], v["table"]),
    "B9": lambda NV, v: NV.rows_from_fused(v["wf"], v["table"], v["tc"]),
    "B10": lambda NV, v: NV.rows_from_streamed(v["ws"], v["table"], 256),
}


def variant_bound(v, name, R, spairs):
    """Bound of one entry: its packed inputs, the rays (and mask) and its
    outputs (idx, tbg, the shading row) once; B4's work on the rays it
    tests (all R for B8 and B9, which take no mask): ``spairs`` =
    sphere_pairs(...), SPHERE_OPS on each pair it must test, PAIR_OPS
    more on each inside a sphere."""
    T = v["T"]
    layout = {"B8": 192 * T, "B9": 192 * T + 48 * T, "B10": 192 * T + 48 * T,
              "B10c": 192 * T + 48 * T, "B11": 192 * T}[name]
    nbytes = layout + 128 * T + (24 if name in ("B8", "B9") else 25) * R + 148 * R
    return bound_of(nbytes, spairs[0] * SPHERE_OPS + spairs[1] * PAIR_OPS)


def padded_b4(torch, rows, bounce):
    """B4 on the Cornell bounce over the table padded as the JAX package
    pads it (652 rows + 116 all-zero rows = 768, the table that B8-B10
    run on), over its first rows up to the largest table the loop stages
    whole (nearest_shade.cu's nearest_shade_whole_max) and unpadded:
    winners, t, beta, gamma and shading rows bit-equal, device times side
    by side. The exact tests that the padding rows cost: under the earlier
    rule (an infinite sphere: every live ray with a direction tests each
    of them) and now (sphere_pairs on the padding rows: the NaN center
    that triangle_sphere gives them)."""
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS

    pos, dir_, _, _, live = bounce
    T = rows.shape[0]
    padded = torch.cat([rows, torch.zeros(-T % 128, 48, device="cuda")]).contiguous()
    whole_max = NS._shade_lib().nearest_shade_whole_max()
    check(T <= whole_max < padded.shape[0],
          f"the whole-table limit {whole_max} no longer lies between {T} and {padded.shape[0]}")
    names = (f"{T} rows", f"{whole_max} rows (whole)", f"{padded.shape[0]} rows (ring)")
    tables = dict(zip(names, (rows, padded[:whole_max].contiguous(), padded)))
    want = NS.nearest_shade_full(rows, pos, dir_, live)
    aimed = int((live & ((dir_ * dir_).sum(0) > 0)).sum())
    before = aimed * (padded.shape[0] - T)
    after = sphere_pairs(torch, padded[T:], pos, dir_, live)[1]
    times = {}
    for name, table in tables.items():
        got = NS.nearest_shade_full(table, pos, dir_, live)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        check(same, f"B4 over the {name} table differs from B4 over the unpadded one")
        times[name] = device_ms(torch, lambda table=table: NS.nearest_shade_full(
            table, pos, dir_, live))[0]
    print(f"B4 on the Cornell bounce over the padded table: idx, tbg and shade bit-equal to "
          f"the unpadded table's; device " + ", ".join(f"{k} {v:.4f} ms"
                                                      for k, v in times.items()))
    unpadded, whole, ring = (times[k] for k in names)
    print(f"  exact tests on the {padded.shape[0] - T} padding rows: {before} under the earlier "
          f"rule (an infinite sphere), {after} now (a NaN center); the ring at "
          f"{padded.shape[0]} rows over the unpadded table: {ring / unpadded:.3f}, over the "
          f"whole table at {whole_max}: {ring / whole:.3f}")
    check(after == 0, f"{after} exact tests counted on all-zero rows")


def variants_vs_plain(torch, cscene, cornell_bounce, gscene, gbounce):
    phase(f"32. the selection entries B8-B11 (thin over B4 / B4c) vs their plain versions: "
          f"Cornell {W}x{H} first bounce (768 triangles with the JAX padding) and the glossy "
          "sorted bounce (1,408) for the culling forms; timed (median of 10 CUDA events), "
          "B8-B10 on the Cornell bounce, the culling forms on the glossy one")
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
    from montecarlopathtracer_tpu_torch.ops import nearest_variants as NV
    from montecarlopathtracer_tpu_torch.ops.segment_fused import pack_rows_full
    from montecarlopathtracer_tpu_torch.testing import compare_shade, plain_kernels

    out, worst = {}, {}
    padded_b4(torch, pack_rows_full(cscene), cornell_bounce)
    cv = variant_setup(torch, cscene)
    gv = variant_setup(torch, gscene)
    cases = [("Cornell bounce", cv, cornell_bounce, ("B8", "B9", "B10", "B10c", "B11")),
             ("glossy bounce", gv, gbounce, ("B10c", "B11"))]
    for wname, v, wave, names in cases:
        pos, dir_, _, _, live = wave
        R, n_live = pos.shape[1], int(live.sum())
        calls = variant_calls(torch, v, pos, dir_, live)
        if wname == "Cornell bounce":
            cornell_calls = calls
        for name in names:
            call, rows, masked = calls[name]
            got = call()
            torch.cuda.synchronize()
            with plain_kernels():
                want = call()
            lanes = live if masked else torch.ones_like(live)
            rep = compare_shade(got, want, live=lanes, rows=rows, pos=pos, dir_=dir_)
            worst[name] = max(worst.get(name, 0.0), rep["tbg_max_abs_err"])
            print(f"{wname:14s} {name:4s}: idx agree {rep['idx_agree']:.6f} "
                  f"({rep['n_idx_mismatch']} near-tie mismatches of {rep['n_live']} lanes); tbg "
                  f"max |err| {rep['tbg_max_abs_err']:.2e} ({rep['tbg_n_beyond_tol']} beyond "
                  f"1e-5); shade equal {rep['shade_equal']}")
            check(rep["ok"], f"{name} disagrees with plain on {wname}: {rep}")
            if name in ("B10c", "B11"):  # B4c's bits: B4's over the same rows
                b4 = NS.nearest_shade_full(rows, pos, dir_, live, dz_test=name == "B11")
                same = all(torch.equal(a, b) for a, b in zip(got, b4))
                print(f"{'':14s} {name:4s}: idx, tbg and shade bit-equal to B4's over the same "
                      f"{rows.shape[0]} rows{' (with the dz test)' if name == 'B11' else ''} on "
                      f"every lane: {same}")
                check(same, f"{name} differs from B4 on {wname}")
            if (name in ("B10c", "B11")) != (wname == "glossy bounce"):
                continue  # the culling forms are timed where culling has work to skip
            def plain_call(call=call):
                with plain_kernels():
                    return call()

            ms = time_pair(torch, call, plain_call, label=name)
            boxes = {}
            if name in ("B10c", "B11"):  # the 128-triangle tile boxes that B4c tests
                b = v["boxes_c"] if name == "B10c" else \
                    NV.tile_boxes(*v["boxes_11"], v["box"], v["T"])
                boxes = dict(boxes=dict(clo=b[0], chi=b[1]),
                             t_best=winner_t(torch, rows, got[0], pos, dir_))
            spairs = sphere_pairs(torch, rows, pos, dir_, lanes, **boxes)
            out[name] = (*ms, variant_bound(v, name, R, spairs))
            print(f"{'':14s} {name:4s}: {ms[0]:.4f} ms (plain {ms[1]:.4f}); bound "
                  f"{out[name][2][0]:.4f} ms ({out[name][2][1]}; {spairs[0]} pairs tested, "
                  f"{spairs[1]} inside their spheres)")
            device_line(name, ms[0], out[name][2])
            if name in ENTRY_OPS:  # the entry's torch ops around B4: its layout unpacked
                unpack = device_ms(torch, lambda v=v, name=name: ENTRY_OPS[name](NV, v))[0]
                print(f"{'':14s} {name:4s}: its own torch ops (the layout unpacked into B4's "
                      f"row table) {unpack:.4f} ms of device time, "
                      f"{unpack / DEVICE_MS[name][0]:.3f} of the entry's")
    # B8-B10 once more, interleaved, three rounds: the spread of this run's
    # device times for the same work.
    again = {n: [] for n in ("B8", "B9", "B10")}
    for _ in range(3):
        for n in again:
            again[n].append(device_ms(torch, cornell_calls[n][0])[0])
    print("B8-B10 device ms again on the Cornell bounce, three interleaved rounds: "
          + "; ".join(f"{n} " + ", ".join(f"{x:.4f}" for x in xs) for n, xs in again.items()))
    print("gate: testing.compare_shade, as phase 25 (B8 and B9 take no live mask: every lane)")
    return out, worst


def intersector_gate(torch, scene):
    phase("33. intersector gate (tools/tpu_check.py's checks 1-4): B8, B10, B10 with cull, "
          "B11, the fused index and the KD walk against the brute oracle, Cornell, 4,096 "
          "camera + 4,096 random rays")
    from montecarlopathtracer_tpu_torch.ops import nearest_shade as NS
    from montecarlopathtracer_tpu_torch.ops.intersect import intersect_brute, triangle_transforms
    from montecarlopathtracer_tpu_torch.ops.traverse import intersect_kdtree
    from montecarlopathtracer_tpu_torch.render.integrator import kd_tree
    from montecarlopathtracer_tpu_torch.scene.camera import camera_for_scene
    from montecarlopathtracer_tpu_torch.testing import compare_winners
    from montecarlopathtracer_tpu_torch.tools.kernel_bench import rays_for

    pos, dir_ = rays_for(scene, camera_for_scene(1, 64, 64, device="cuda"), GATE_RAYS,
                         frame=64)
    R = pos.shape[1]
    live = torch.ones(R, dtype=torch.bool, device="cuda")
    m, m_a = triangle_transforms(*scene.triangle_vertices())
    brute = intersect_brute(m, m_a, scene.tri_valid, pos.T, dir_.T)
    v = variant_setup(torch, scene)
    calls = variant_calls(torch, v, pos, dir_, live)
    kd = kd_tree(scene)
    reset_counts()
    got = {name: calls[name][0]() for name in ("B8", "B10", "B10c", "B11")}
    got["fused"] = NS.intersect_fused(m, m_a, scene.tri_valid, pos.T, dir_.T)
    got["kdtree"] = intersect_kdtree(kd, m, m_a, scene.tri_valid, pos.T, dir_.T)
    torch.cuda.synchronize()
    counts = read_all_counts()
    perm, rows = v["perm"], v["rows"][:scene.num_triangles]
    worst = 0.0
    for name, out in got.items():
        if name in ("fused", "kdtree"):
            idx, t = out.tri_id, out.t
        else:
            idx, t = out[0], out[1][0]
            if name in ("B10c", "B11"):  # indices in Morton order: back to the scene's
                idx = torch.where(idx >= 0, perm[idx.clamp_min(0).long()].int(), -1)
        rep = compare_winners(idx, brute.tri_id, live=live, rows=rows, pos=pos, dir_=dir_)
        same = (idx == brute.tri_id) & (idx >= 0)
        rel = float(((t[same] - brute.t[same]).abs() / brute.t[same].clamp_min(1e-3)).max())
        worst = max(worst, rep["max_t_gap"])
        print(f"  {name:6s}: agree {rep['idx_agree']:.6f} ({rep['n_idx_mismatch']} near-tie "
              f"mismatches, max t gap {rep['max_t_gap']:.2e}); miss status equal "
              f"{bool(((idx < 0) == (brute.tri_id < 0)).all())}; max rel t err {rel:.2e}")
        check(rep["ok"] and rel < 1e-4, f"{name} fails the intersector gate: {rep}")
    print(f"launches: {counts}; gate: testing.compare_winners (>= 99.9% equal, every "
          "mismatch a near-tie, misses where brute misses), hit distances within 1e-4 "
          "relative (tools/tpu_check.py: 98% agreement, ties within 1e-3, t within 1e-4)")
    check(all(counts[k] == 1 for k in ("B8", "B10", "B10c", "B11")), f"gate launches {counts}")
    return counts, worst


def bench_vs_plain(torch, bench):
    """The kernel_bench run's own outputs against the plain versions on
    BENCH_SUBSET of its rays per scene (testing.compare_shade): B8-B10 at
    the shapes the tool runs them at, the bunny's 82,048 triangles
    included. Returns the worst t/beta/gamma error per kernel."""
    from montecarlopathtracer_tpu_torch.testing import compare_shade, plain_kernels

    worst = {}
    g = torch.Generator(device="cuda").manual_seed(29)
    for sname, k in bench.items():
        v = variant_setup(torch, k["scene"])
        sub = torch.randperm(k["pos3"].shape[1], device="cuda", generator=g)[:BENCH_SUBSET]
        sub = sub.sort().values
        pos, dir_ = k["pos3"][:, sub].contiguous(), k["dir3"][:, sub].contiguous()
        lanes = torch.ones(sub.shape[0], dtype=torch.bool, device="cuda")
        for kernel, call in k["calls"].items():
            got = tuple(x[..., sub] for x in k["out"][kernel])
            t0 = time.perf_counter()
            with plain_kernels():
                want = call(pos, dir_)
            torch.cuda.synchronize()
            rows = v["rows_p"] if kernel == "v3_cull_tc128" else v["rows"]
            rep = compare_shade(got, want, live=lanes, rows=rows, pos=pos, dir_=dir_)
            name = BENCH_KERNELS[kernel]
            worst[name] = max(worst.get(name, 0.0), rep["tbg_max_abs_err"])
            print(f"  {sname:7s} {kernel:14s} ({name:4s}): idx agree {rep['idx_agree']:.6f} "
                  f"({rep['n_idx_mismatch']} near-tie mismatches of {rep['n_live']}); tbg max "
                  f"|err| {rep['tbg_max_abs_err']:.2e}; shade equal {rep['shade_equal']}; "
                  f"plain {time.perf_counter() - t0:.2f} s")
            check(rep["ok"], f"kernel_bench {kernel} on {sname} disagrees with plain: {rep}")
    return worst


def tool_twins(torch):
    phase("34. the tool twins on the card: montecarlopathtracer_tpu_torch.tools.kernel_bench "
          "(B8-B10, Cornell + bunny, 480,000 rays) and .kernel_micro (B12-B14, R = 491,520, "
          "T = 768); then each run's own outputs against the plain versions on the same "
          f"inputs (B8-B10 on {BENCH_SUBSET:,} of the rays per scene, B12-B14 on all of them) "
          "and the plain B12-B14 timed at the tool's size")
    from montecarlopathtracer_tpu_torch.ops import selection_micro as SM
    from montecarlopathtracer_tpu_torch.testing import MICRO_ADDEND_ULPS, compare_micro
    from montecarlopathtracer_tpu_torch.tools import kernel_bench, kernel_micro

    reset_counts()
    t0 = time.perf_counter()
    bench = {}
    bench_rows = kernel_bench.run(rays=480_000, keep=bench)
    torch.cuda.synchronize()
    bench_counts = read_all_counts()
    print(f"kernel_bench: {time.perf_counter() - t0:.1f} s; launches {bench_counts}")
    for row in bench_rows:
        print(f"  {row['scene']:7s} T {row['T']:6d} {row['kernel']:14s} {row['ms']:9.4f} ms  "
              f"{row['mray_segments_s']:9.2f} Mray-segments/s")
    check(all(bench_counts[k] > 0 for k in ("B8", "B9", "B10", "B10c")),
          f"kernel_bench launches {bench_counts}")
    print(f"kernel_bench's outputs against the plain versions ({BENCH_SUBSET:,} rays per scene):")
    bench_err = bench_vs_plain(torch, bench)
    del bench
    reset_counts()
    t0 = time.perf_counter()
    micro = {}
    micro_rows = kernel_micro.run(keep=micro)
    torch.cuda.synchronize()
    micro_counts = read_all_counts()
    print(f"kernel_micro: {time.perf_counter() - t0:.1f} s; launches {micro_counts}")
    for row in micro_rows:
        print(f"  {row['variant']:20s} t_chunk {row['t_chunk']} {row['ms']:9.4f} ms  "
              f"{row['gel_s']:9.2f} G ray-triangle/s")
    check(all(micro_counts[k] > 0 for k in ("B12 full", "B12 matmul_only", "B12 matmul_bf16",
                                            "B13", "B14")),
          f"kernel_micro launches {micro_counts}")
    tool_ms = {r["variant"]: r["ms"] for r in micro_rows}

    ws, x, p_blk, p_all, tc = (micro[k] for k in ("ws", "rays", "p_blk", "p_all", "t_chunk"))
    T, R = ws.shape[1] // 6, x.shape[1]
    cases = {  # name: (kernel_micro's variant, plain version on the tool's own inputs)
        "full": ("v3_full", lambda: SM.selection_micro_ref(ws, x, tc, "full")),
        "matmul_only": ("matmul_only_f32out",
                        lambda: SM.selection_micro_ref(ws, x, tc, "matmul_only")),
        "matmul_bf16": ("matmul_only_bf16out",
                        lambda: SM.selection_micro_ref(ws, x, tc, "matmul_bf16")),
        "B13": ("epilogue_resident", lambda: SM.epilogue_only_ref(p_all, tc)),
        "B14": ("epilogue_only", lambda: SM.epilogue_shared_ref(p_blk, T, R)),
    }
    # B12's contraction multiplies bf16 inputs, so its least time is on the
    # bf16 tensor cores; the accept chain (full) or the running min over the
    # 6T products (matmul forms) is f32 work beside it.
    contract = R * 6 * T * SM.K * 2  # multiply-adds of the contraction, two operations each
    chain = R * T * CHAIN_OPS
    io = SM.K * 6 * T * 2 + SM.K * R * 2 + 4 * R
    tensor = bound_of(io, contract, BF16_OPS_PER_S)
    bounds = {
        "full": max(tensor, bound_of(io, chain)),
        "matmul_only": max(tensor, bound_of(io, R * 6 * T)),
        "matmul_bf16": max(tensor, bound_of(io, R * 6 * T)),
        "B13": bound_of(6 * T * R * 4 + 4 * R, chain),
        "B14": bound_of(p_blk.numel() * 4 + 4 * R, chain),
    }
    kernels = {  # the kernels on the same inputs, for their device time
        "full": lambda: SM.selection_micro(ws, x, tc, "full"),
        "matmul_only": lambda: SM.selection_micro(ws, x, tc, "matmul_only"),
        "matmul_bf16": lambda: SM.selection_micro(ws, x, tc, "matmul_bf16"),
        "B13": lambda: SM.epilogue_only(p_all, tc),
        "B14": lambda: SM.epilogue_shared(p_blk, T, R),
    }
    out, gates = {}, {}
    for name, (row, plain) in cases.items():
        got = micro["out"][row]
        want = plain()
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        hits = float((want >= 0).float().mean()) if name in ("full", "B13", "B14") else None
        plain_ms = time_one(torch, plain)
        out[name] = (tool_ms[row], plain_ms, bounds[name], err)
        (bms, by) = bounds[name]
        if name in ("B13", "B14"):
            gate = f"equal to plain on all {R} rays: {err == 0}"
            check(err == 0, f"{name} disagrees with its plain version")
        else:  # the tensor cores sum in their own order: the rounding rule
            rep = compare_micro(ws, x, tc, name, got, want)
            gates[name] = rep
            gate = (f"compare_micro on all {R} rays: {rep['ok']} ("
                    + (f"{rep['n_idx_mismatch']} winners differ from plain: "
                       f"{rep['n_near_tie']} near-ties, {rep['n_boundary']} at the accept "
                       f"chain's boundary, {rep['n_bad']} beyond the rule"
                       if name == "full" else
                       f"{rep['n_differ_from_plain']} differ from plain, "
                       f"{rep['n_out_of_bound']} beyond min p +- E, E <= "
                       f"{rep['max_slack']:.3g}") + ")")
            check(rep["ok"], f"B12 {name} breaks the rounding rule: {rep}")
        print(f"{name:12s}: the tool's output {gate}, max |diff| {err}"
              + (f", {hits:.4f} hit" if hits is not None else "") + f"; "
              f"{tool_ms[row]:.4f} ms, plain {plain_ms:.4f} ms; bound {bms:.4f} ms ({by}), "
              f"kernel at {bms / tool_ms[row]:.3f} of it")
        label = name if name in ("B13", "B14") else f"B12 {name}"
        record_device(torch, label, kernels[name])
        device_line(label, tool_ms[row], bounds[name])
    print(f"B12's bound is its contraction on the bf16 tensor cores ({BF16_OPS_PER_S / 1e12:.0f} "
          f"TFLOP/s), where it runs. B12's gate (testing.compare_micro): p recomputed in "
          f"float64 from the bf16 operands; matmul forms within trunc(min p +- E), E = 48 x "
          f"{MICRO_ADDEND_ULPS} x 2^-23 x the ray's largest sum of |products| (+ a bf16 ulp for "
          f"matmul_bf16); full: winners equal on >= 99.9% of rays, each other one a near-tie "
          f"or at the accept chain's boundary within that rounding. B13's p_all: "
          f"{p_all.numel() * 4 / 1e9:.2f} GB")
    b14_floor(torch, T, R, bounds["B14"])
    lib = {v: cublas_min(torch, ws, x, micro["out"][row], v)
           for v, row in (("matmul_only", "matmul_only_f32out"),
                          ("matmul_bf16", "matmul_only_bf16out"))}
    del micro, p_all
    return bench_rows, bench_counts, bench_err, micro_counts, out, gates, lib


def b14_floor(torch, T, R, bound):
    """B14's floor in shared memory (its kernel stages every pair's six
    values there: 24 B a pair at 128 B/clk/SM) beside its bound."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pair_bytes = R * T * 24
    floor = pair_bytes / (SMEM_BYTES_PER_CLK * sms * SM_CLOCK_HZ) * 1e3
    print(f"B14's floor in shared memory: {pair_bytes / 1e9:.2f} GB (24 B a pair) at "
          f"{SMEM_BYTES_PER_CLK} B/clk/SM on {sms} SMs at {SM_CLOCK_HZ / 1e9:.2f} GHz: "
          f"{floor:.4f} ms, beside its bound {bound[0]:.4f} ms ({bound[1]}: {CHAIN_OPS} f32 "
          f"operations a pair at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s); device "
          f"{DEVICE_MS['B14'][0]:.4f} ms, at {floor / DEVICE_MS['B14'][0]:.3f} of that floor "
          f"(the earlier run's loop from L2: {EARLIER_MS['B14'][0]:.4f} ms, its "
          f"{pair_bytes / 1e9:.2f} GB of loads at "
          f"{pair_bytes / EARLIER_MS['B14'][0] / 1e9:.2f} TB/s)")


def cublas_min(torch, ws, x, b12, variant):
    """The library yardstick of B12's matmul forms (never called by the
    port): cuBLAS's product of the same bf16 operands (torch.mm, f32 out
    for matmul_only where torch.mm takes out_dtype, bf16 out for
    matmul_bf16), in slices of rays so that each f32 product stays under
    1 GB, then the column min. Returns its median event ms; its device
    time goes into DEVICE_MS as "cuBLAS <variant>"."""
    a = ws.T.contiguous()  # bf16[6T, 48]
    step = (1 << 30) // (4 * a.shape[0])  # rays per slice
    out = "bf16"
    if variant == "matmul_only":
        try:
            torch.mm(a, x[:, :8], out_dtype=torch.float32)
            out = "f32"
        except (TypeError, RuntimeError):
            pass

    def call():
        low = []
        for s in range(0, x.shape[1], step):
            if out == "f32":
                p = torch.mm(a, x[:, s:s + step], out_dtype=torch.float32)
            else:
                p = torch.mm(a, x[:, s:s + step])
            low.append(p.amin(0))
        return torch.cat(low)

    got = call().float().to(torch.int32)
    agree = float((got == b12).float().mean())
    label = f"cuBLAS {variant}"
    ms = time_one(torch, call, label=label)
    print(f"cuBLAS yardstick of B12 {variant}: torch.mm of the bf16 operands ({out} out, "
          f"{-(-x.shape[1] // step)} slices of {step} rays) then amin: {ms:.4f} ms (event "
          f"pair), device {DEVICE_MS[label][0]:.4f} ms against B12's "
          f"{DEVICE_MS[f'B12 {variant}'][0]:.4f}; int32 of its min equals B12's on {agree:.4f} "
          f"of the rays (another summation order)")
    return ms


def kdtree_main_path(torch, scene, camera, bounce):
    phase(f"35. KD-tree main path: the walk on the Cornell {W}x{H} first bounce, then "
          f"Renderer {W}x{H}, fixed depth {DEPTH} + gather, {KD_SPP} spp/pass, "
          "intersector='kdtree', against the whole-segment film of the same key")
    from montecarlopathtracer_tpu_torch.ops.intersect import triangle_transforms
    from montecarlopathtracer_tpu_torch.ops.traverse import intersect_kdtree
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig, kd_tree
    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings
    from montecarlopathtracer_tpu_torch.testing import compare_images

    pos, dir_, _, _, live = bounce
    kd = kd_tree(scene)
    m, m_a = triangle_transforms(*scene.triangle_vertices())
    walk = lambda: intersect_kdtree(kd, m, m_a, scene.tri_valid, pos.T, dir_.T)  # noqa: E731
    walk_ms = time_one(torch, walk, n=3)
    print(f"walk of {pos.shape[1]} rays ({int(live.sum())} live, the walk takes no mask) over "
          f"{kd.num_nodes} nodes: {walk_ms:.2f} ms (median of 3 CUDA events)")
    settings = RenderSettings(width=W, height=H, spp_per_pass=KD_SPP, seed=0)
    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0, intersector="kdtree")
    r = Renderer(scene, camera, config, settings, device="cuda", accel=kd)
    t0 = time.perf_counter()
    r.render(1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    r.render(1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"warm-up pass {warm:.3f} s; timed pass {dt:.4f} s, kdtree forward "
          f"{W * H * KD_SPP / dt / 1e6:.4f} Msamples/s")
    img = r.film.color
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0, "kdtree film")
    whole = Renderer(scene, camera, TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0),
                     settings, device="cuda")
    whole.render(2)
    rep = compare_images(img, whole.film.color)
    print(f"film against the whole-segment film of the same passes: pixels within 1e-4 "
          f"{rep['pixel_share']:.5f}, max |err| {rep['max_abs_err']:.3e}, mean rel "
          f"{rep['mean_rel']:.2e}")
    check(rep["ok"], f"the kdtree film disagrees with the whole-segment film: {rep}")
    return walk_ms, dt


# ------------------------------------------------------------- the sharded paths

SHARD_SPP = 4  # 36a, 36b, 36f: phase 5's samples per pass
SHARD_FIELDS = ("mat_kd", "mat_ka", "vertices")  # 36c, 36f: phase 11's parameters
SHARD_LR = 0.5


def _shard_timed(torch, fn, dev):
    """(result, ms) of one call, ended by a synchronise on the card."""
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def sharded_paths(torch, scene, camera, smi, w=W, h=H, dev="cuda"):
    """Phase 36: the sharded paths (montecarlopathtracer_tpu_torch.parallel)
    on the card: world size 1 under NCCL in this process (36a-e), then two
    gloo ranks on cuda:0 (36f). Returns the launch counts of 36a-e. The
    frame size and device are arguments so that the phase can be
    rehearsed on the CPU at a small size with the plain versions (where
    its launch-count checks fail, as no kernel launches)."""
    phase("36. sharded paths (parallel/): world size 1 under NCCL in this process, then two "
          "gloo ranks on one card")
    import tempfile

    import torch.distributed as dist

    from montecarlopathtracer_tpu_torch.parallel import distributed, make_mesh
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig

    config = TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0)
    kw = dict(width=w, height=h, config=config)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        distributed.ensure_initialized(device=dev, init_method=f"file://{tmp}/store",
                                       world_size=1, rank=0)
        try:
            mesh = make_mesh(1, 1, device=dev)
            counts["36a"] = world_one_pass(torch, scene, camera, smi, mesh, config, kw, dev)
            counts["36b"] = world_one_progressive(torch, scene, camera, smi, mesh, kw, dev)
            counts["36c"] = world_one_train(torch, scene, camera, smi, mesh, kw, dev)
            counts["36d"] = world_one_regen(torch, scene, camera, smi, mesh, w, h, dev)
            counts["36e"] = world_one_geometry(torch, smi, mesh, w, h, dev)
        finally:
            dist.destroy_process_group()
    two_ranks_one_card(torch, scene, camera, smi, config, w, h, dev)
    return counts


def _pass_reference(torch, scene, camera, key, w, h, config, spp):
    """The mean of render_rows_planar over fold_in(fold_in(key, 0), s),
    s < spp, as f32[H, W, 3]: rank (0, 0)'s samples summed from zero."""
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in
    from montecarlopathtracer_tpu_torch.render.integrator import render_rows_planar

    total = torch.zeros(3, h, w, device=camera.device)
    with torch.no_grad():
        for s in range(spp):
            total = total + render_rows_planar(scene, camera, fold_in(fold_in(key, 0), s), w,
                                               h, 0, h, config)
    return (total / spp).permute(1, 2, 0)


def world_one_pass(torch, scene, camera, smi, mesh, config, kw, dev):
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.parallel import sharded as SH
    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings

    w, h = kw["width"], kw["height"]
    spass = SH.sharded_sample_pass(mesh, spp=SHARD_SPP, **kw)
    key = make_key(11)
    with torch.no_grad():
        spass(scene, camera, key)  # warm-up
        reset_counts()
        got, ms = _shard_timed(torch, lambda: spass(scene, camera, key), dev)
        counts = read_all_counts()
    want = _pass_reference(torch, scene, camera, key, w, h, config, SHARD_SPP)
    same = bool(torch.equal(got, want))
    n_seg = config.num_segments
    print(f"36a: backend {mesh.backend}, mesh 1x1, sharded_sample_pass {w}x{h} {SHARD_SPP} "
          f"spp: bit-equal to the mean of render_rows_planar over fold_in(fold_in(key, 0), s): "
          f"{same}; launches {counts} (expected B1 {n_seg * SHARD_SPP}, RNG "
          f"{(1 + n_seg) * SHARD_SPP}); {ms:.3f} ms; {smi}")
    check(mesh.backend == ("nccl" if dev == "cuda" else "gloo"), f"backend {mesh.backend}")
    check(same, "36a: the sharded pass differs from the mean of its samples")
    check(counts["B1"] == n_seg * SHARD_SPP and counts["RNG"] == (1 + n_seg) * SHARD_SPP,
          f"36a launches {counts}")
    # The SPMD overhead at world size 1: the Renderer's pass (phase 5's
    # path, tables built once) and the sharded pass (tables built each
    # call), in turns.
    r = Renderer(scene, camera, kw["config"], RenderSettings(width=w, height=h,
                 spp_per_pass=SHARD_SPP, seed=0), device=dev)
    r.render(1)
    rms, sms = [], []
    with torch.no_grad():
        for _ in range(3):
            rms.append(_shard_timed(torch, lambda: r.render(1), dev)[1])
            sms.append(_shard_timed(torch, lambda: spass(scene, camera, key), dev)[1])
    print(f"36a timing: Renderer pass {statistics.median(rms):.3f} ms, sharded pass (world "
          f"size 1, NCCL) {statistics.median(sms):.3f} ms (medians of 3, in turns: "
          f"{' '.join(f'{a:.2f}/{b:.2f}' for a, b in zip(rms, sms))}); {smi}")
    return counts


def world_one_progressive(torch, scene, camera, smi, mesh, kw, dev):
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.parallel import sharded as SH
    from montecarlopathtracer_tpu_torch.render.film import Film, film_update

    w, h = kw["width"], kw["height"]
    step = SH.make_progressive_step(mesh, spp=SHARD_SPP, **kw)
    film = Film.zeros(SH.film_band(mesh, h)[1], w, camera.device)
    reset_counts()
    t0 = time.perf_counter()
    for seed in (11, 12):
        film = step(scene, camera, film, make_key(seed))
    if dev == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_all_counts()
    want = Film.zeros(h, w, camera.device)
    for seed in (11, 12):
        want = film_update(want, _pass_reference(torch, scene, camera, make_key(seed), w, h,
                                                 kw["config"], SHARD_SPP), SHARD_SPP)
    same = bool(torch.equal(SH.gather_film(mesh, film.color), want.color))
    print(f"36b: make_progressive_step twice: weight {float(film.weight)} (expected "
          f"{2 * SHARD_SPP}), film bit-equal to two film_updates of the 36a passes: {same}; "
          f"launches {counts}; {ms:.3f} ms for both; {smi}")
    check(float(film.weight) == 2 * SHARD_SPP and same, "36b: progressive film differs")
    return counts


def world_one_train(torch, scene, camera, smi, mesh, kw, dev):
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key
    from montecarlopathtracer_tpu_torch.parallel import sharded as SH
    from montecarlopathtracer_tpu_torch.testing import compare_param_grads

    w, h, config = kw["width"], kw["height"], kw["config"]
    target = _pass_reference(torch, scene, camera, make_key(11), w, h, config, SHARD_SPP)
    params = G.split_params(scene, SHARD_FIELDS)
    params["mat_kd"] = params["mat_kd"] * 0.6
    step = SH.make_train_step(mesh, scene, camera, spp=GRAD_SPP, lr=SHARD_LR, **kw)
    key = make_key(14)
    step(params, target, key)  # warm-up
    reset_counts()
    (new, loss), ms = _shard_timed(torch, lambda: step(params, target, key), dev)
    counts = read_all_counts()
    # One process, the same sample keys: render_image draws sample i
    # under fold_in(key', i), and rank (0, 0)'s key is fold_in(key, 0).
    loss_fn = G.make_loss_fn(scene, camera, target, width=w, height=h, spp=GRAD_SPP,
                             config=config)
    rloss, rgrads = G.value_and_grad(loss_fn, params, fold_in(key, 0))
    with torch.no_grad():
        rnew = {k: torch.clamp_min(params[k] - SHARD_LR * rgrads[k], 0.0) for k in params}
    rep = compare_param_grads(rnew, new, 1e-6)
    lrel = abs(float(loss) - float(rloss)) / abs(float(rloss))
    n_seg = config.num_segments
    print(f"36c: make_train_step {w}x{h} {GRAD_SPP} spp {list(SHARD_FIELDS)}: loss "
          f"{float(loss):.9e} vs one process {float(rloss):.9e} (rel {lrel:.2e}); new params "
          f"vs one process's value_and_grad + SGD (compare_param_grads 1e-6): "
          + ", ".join(f"{k} {rep[k]['max_abs_err']:.3e}" for k in SHARD_FIELDS)
          + f" ok {rep['ok']}; launches {counts} (expected B1, B2, B3 {n_seg * GRAD_SPP}); "
          f"{ms:.3f} ms; {smi}")
    check(rep["ok"] and lrel <= 1e-6, f"36c: train step differs from one process: {rep}")
    check(all(counts[k] == n_seg * GRAD_SPP for k in ("B1", "B2", "B3")),
          f"36c launches {counts}")
    return counts


def world_one_regen(torch, scene, camera, smi, mesh, w, h, dev):
    from montecarlopathtracer_tpu_torch.ops import regen_pass as RP
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key
    from montecarlopathtracer_tpu_torch.parallel import sharded as SH
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
    from montecarlopathtracer_tpu_torch.render.regen import render_regen_planar

    config = TraceConfig(mode="rr", rr_depth=5, illum=1.0)
    rpass = SH.sharded_regen_pass(mesh, width=w, height=h, spp=REGEN_SPP, config=config)
    key = make_key(15)
    reset_counts()
    got, ms = _shard_timed(torch, lambda: rpass(scene, camera, key), dev)
    counts = read_all_counts()
    want = render_regen_planar(scene, camera, fold_in(key, 0), w, h, REGEN_SPP, config, y0=0,
                               n_rows=h).permute(1, 2, 0)
    same = bool(torch.equal(got, want))
    print(f"36d: sharded_regen_pass RR (rr_depth 5, illum 1) {w}x{h} {REGEN_SPP} spp: "
          f"bit-equal to render_regen_planar(y0=0, n_rows={h}) under fold_in(key, 0): {same}; "
          f"launches {counts}; {ms:.3f} ms; {smi}")
    check(same, "36d: the sharded regen pass differs from render_regen_planar")
    check(counts["B1r"] == 1 and counts["B1l"] == counts["B1"] == counts["RNG"] == 0,
          f"36d launches {counts}, expected one B1r")
    return counts


def world_one_geometry(torch, smi, mesh, w, h, dev):
    from montecarlopathtracer_tpu_torch import testing as T
    from montecarlopathtracer_tpu_torch.diff.boundary import lamp_mask
    from montecarlopathtracer_tpu_torch.models import cornell
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key
    from montecarlopathtracer_tpu_torch.parallel import sharded as SH
    from montecarlopathtracer_tpu_torch.render.integrator import (
        TraceConfig,
        render_sample_batch,
    )

    scene, camera = cornell.cornell_box(width=w, height=h, device=dev)
    config = TraceConfig(mode="fixed", max_depth=GEOM_DEPTH, whole_segment=False)
    lamp = lamp_mask(scene)
    with torch.no_grad():
        target = sum(render_sample_batch(scene, camera, fold_in(make_key(123), i), w, h,
                                         config) for i in range(GEOM_SPP)) / GEOM_SPP
    step = SH.make_geom_train_step(mesh, scene, camera, lamp, width=w, height=h, spp=GEOM_SPP,
                                   config=config, n_edge_samples=GEOM_EDGES, lr=2.0)
    theta, key = [1.2, 0.0, 0.0], make_key(16)
    step(theta, target, key)  # warm-up
    reset_counts()
    (got, loss), ms = _shard_timed(torch, lambda: step(theta, target, key), dev)
    counts = read_all_counts()
    want, wloss = T.emulate_geom_step(scene, camera, lamp, theta, target, key, (1, 1), width=w,
                                      height=h, spp=GEOM_SPP, config=config,
                                      n_edge_samples=GEOM_EDGES, lr=2.0)
    rep = T.compare_param_grads({"theta": want}, {"theta": got}, 1e-6)
    lrel = abs(float(loss) - float(wloss)) / abs(float(wloss))
    g = (torch.tensor(theta, device=got.device) - got) / 2.0
    print(f"36e: make_geom_train_step {w}x{h}, depth {GEOM_DEPTH}, {GEOM_SPP} spp, "
          f"{GEOM_EDGES} edge samples, split path: loss {float(loss):.9e} vs the emulation "
          f"{float(wloss):.9e} (rel {lrel:.2e}); theta' {got.tolist()} vs {want.tolist()} "
          f"(max |err| {rep['theta']['max_abs_err']:.3e}, compare_param_grads 1e-6 ok "
          f"{rep['ok']}); d loss / d theta {g.tolist()}; launches {counts}; {ms:.3f} ms; {smi}")
    check(rep["ok"] and lrel <= 1e-6, f"36e: geometry step differs from the emulation: {rep}")
    check(counts["B4"] > 0 and counts["B1"] == 0, f"36e launches {counts}")
    return counts


def two_ranks_one_card(torch, scene, camera, smi, config, w, h, dev):
    """36f: two gloo ranks spawned on cuda:0 (NCCL refuses two ranks on
    one device); their gathered films, loss and parameters against the
    parent's emulation of the two ranks, bit for bit."""
    import numpy as np

    from montecarlopathtracer_tpu_torch import testing as T
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.ops.rng import make_key
    from montecarlopathtracer_tpu_torch.parallel.launch import run_ranks

    cfg = dict(mode="fixed", max_depth=DEPTH, illum=10.0)
    target = _pass_reference(torch, scene, camera, make_key(11), w, h, config, SHARD_SPP)
    base = dict(width=w, height=h, config=cfg, seed=17,
                scene=dict(with_mirror_sphere=True, with_glass_sphere=True))
    cases = [dict(base, kind="sample", mesh=(2, 1), spp=SHARD_SPP),
             dict(base, kind="sample", mesh=(1, 2), spp=SHARD_SPP),
             dict(base, kind="train", mesh=(2, 1), spp=GRAD_SPP, fields=SHARD_FIELDS,
                  kd_scale=0.6, target=target.cpu().numpy(), lr=SHARD_LR)]
    t0 = time.perf_counter()
    ranks = run_ranks(T.sharded_cases, 2, (cases, dev), backend="gloo", device=dev,
                      timeout=600)
    wall = time.perf_counter() - t0
    key = make_key(17)
    kw = dict(width=w, height=h, config=config)
    same = {}
    for i, c in enumerate(cases[:2]):
        with torch.no_grad():
            want = T.emulate_sample_pass(scene, camera, key, c["mesh"], spp=SHARD_SPP, **kw)
        same[f"sample {c['mesh']}"] = all(np.array_equal(r[i], want.cpu().numpy())
                                          for r in ranks)
    params = G.split_params(scene, SHARD_FIELDS)
    params["mat_kd"] = params["mat_kd"] * 0.6
    new, loss = T.emulate_train_step(scene, camera, params, target, key, (2, 1), spp=GRAD_SPP,
                                     lr=SHARD_LR, **kw)
    same["train (2, 1)"] = all(
        np.array_equal(r[2]["loss"], loss.cpu().numpy())
        and all(np.array_equal(r[2]["params"][k], new[k].cpu().numpy()) for k in new)
        for r in ranks)
    print(f"36f: two gloo ranks on {dev}:0 (run_ranks, spawn included {wall * 1e3:.1f} ms), "
          f"{w}x{h}: bit-equal to the parent's emulation of the two ranks (per band and key): "
          f"{same}; loss {float(loss):.9e}; {smi}")
    print("36f: one card cannot measure scaling: both ranks share it, so this part checks "
          "the collectives and the bits, not the speed")
    check(all(same.values()), f"36f: two ranks differ from their emulation: {same}")



# ------------------------------------------------ the last slice's entry points (PR 13)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "fwd_msamples_s", "warmup_s",
              "rr_regen_msamples_s", "fwdbwd_msamples_s", "fwdbwd_mray_segments_s")
AUTO_SCENES = ("cornell-full", "glossy", "bunny")
AUTO_W, AUTO_H = 64, 48


@contextlib.contextmanager
def bench_env(**env):
    """os.environ with every BENCH_* variable removed, then ``env`` set."""
    saved = dict(os.environ)
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def run_bench(**env):
    """The bench twin in this process; its one stdout line, parsed."""
    from montecarlopathtracer_tpu_torch import bench

    out = io.StringIO()
    with bench_env(**env), contextlib.redirect_stdout(out):
        rc = bench.main()
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 1, f"bench twin: rc {rc}, stdout {out.getvalue()!r}")
    return json.loads(lines[0])


def bench_twin(torch, smi, regen_counts):
    phase("37. the bench twin (python -m montecarlopathtracer_tpu_torch.bench) at full size: "
          f"Cornell {W}x{H}, fixed depth {DEPTH} + gather, megakernel whole segment; then "
          "under BENCH_INTERSECTOR=brute at 160x120")
    import math

    reset_counts()
    t0 = time.perf_counter()
    rec = run_bench()
    wall = time.perf_counter() - t0
    counts = read_all_counts()
    print(json.dumps(rec))
    print(smi)
    missing = [k for k in BENCH_KEYS if k not in rec]
    check(not missing and set(rec) == set(BENCH_KEYS), f"bench line keys: missing {missing}")
    # warmup_s is 0.0 here: this process built the kernels in phase 2.
    check(rec["metric"] == "cornell_800x600_depth7_brute_samples_throughput"
          and rec["unit"] == "Msamples/s" and math.isfinite(rec["warmup_s"])
          and rec["warmup_s"] >= 0 and all(math.isfinite(rec[k]) and rec[k] > 0
                                           for k in BENCH_KEYS[1:] if k not in ("unit", "warmup_s")),
          f"bench line values: {rec}")
    seg = DEPTH + 1
    want = {"B1": seg * SPP * (1 + 4) + seg * GRAD_SPP * (1 + 3), "B2": seg * GRAD_SPP * 4,
            "B3": seg * GRAD_SPP * 4, "B1r": regen_counts["B1r"], "B1l": 0,
            "RNG": (1 + seg) * SPP * 5 + (1 + seg) * GRAD_SPP * 4}
    print(f"{wall:.1f} s; launches {counts}; expected {want} (B1: {SPP} spp x {seg} segments "
          f"a pass over 1 + 4 passes, then {GRAD_SPP} spp x {seg} over 1 + 3 iterations; "
          "B1r: one a regen pass, phase 16's three passes; no draw or B1l in them)")
    check(all(counts[k] == v for k, v in want.items()), f"bench launches {counts}")
    brute = run_bench(BENCH_INTERSECTOR="brute", BENCH_WIDTH=160, BENCH_HEIGHT=120)
    print(json.dumps(brute))
    check("rr_regen_msamples_s" not in brute and brute["value"] > 0,
          f"BENCH_INTERSECTOR=brute: {brute}")
    print("BENCH_INTERSECTOR=brute ran to its end without rr_regen_msamples_s (C1)")
    return rec, counts


def suite_twin(torch):
    phase("38. the suite twin (tools/bench_suite.py --quick): every row, in a temporary "
          "directory")
    import tempfile

    from montecarlopathtracer_tpu_torch.tools import bench_suite

    t0 = time.perf_counter()
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(out):
                rc = bench_suite.main(["--quick"])
            with open(bench_suite.OUT) as f:
                rows = json.load(f)["results"]
        finally:
            os.chdir(cwd)
    total = {}
    for r in rows:
        print(json.dumps(r))
        for k, v in r.get("launches", {}).items():
            total[k] = total.get(k, 0) + v
    want = [row[0] for row in bench_suite.plan(quick=True, kdtree=True)] + ["bunny_grad_fwdbwd"]
    check(rc == 0 and [r["config"] for r in rows] == want
          and not any("error" in r for r in rows), f"suite rc {rc}, rows {rows}")
    launched = {r["config"]: r["launches"] for r in rows}
    for row, kernel in (("scene1_megakernel", "B1"), ("scene1_split_segment", "B4"),
                        ("glossy_cull", "B1c"), ("bunny_traverse", "B5"),
                        ("bunny_traverse", "B6"), ("scene1_rr_regen", "B1r"),
                        ("glossy_cull_regen_spp16", "B1rc"),
                        ("bunny_grad_fwdbwd", "B2"), ("bunny_grad_fwdbwd", "B3"),
                        ("bunny_grad_fwdbwd", "B5t")):
        check(launched[row].get(kernel, 0) > 0, f"suite row {row} launched no {kernel}")
    print(f"{len(rows)} rows OK in {time.perf_counter() - t0:.1f} s; timed launches summed "
          f"over the rows: {total}")
    return total


def auto_choices(torch, smi):
    phase(f"39. the CLI's automatic choices on the card: cli.main with the defaults on "
          f"{', '.join(AUTO_SCENES)} at {AUTO_W}x{AUTO_H}, 1 spp; then the bunny's walk with "
          "and without the sort, in turns")
    import tempfile

    from montecarlopathtracer_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        for name in AUTO_SCENES:
            err = io.StringIO()
            reset_counts()
            with contextlib.redirect_stderr(err):
                rc = cli.main(["--scene", name, "--width", str(AUTO_W), "--height",
                               str(AUTO_H), "--spp-per-pass", "1", "--passes", "1",
                               "--out", os.path.join(tmp, f"{name}.png")])
            counts = read_all_counts()
            got = [json.loads(line) for line in err.getvalue().splitlines()
                   if line.startswith('{"choices"')]
            check(rc == 0 and len(got) == 1, f"cli {name}: rc {rc}, {err.getvalue()}")
            want = cli.resolve_choices(got[0]["triangles"], mode="fixed", spp_per_pass=1)
            ran = ("B5" if want["intersector"] == "traverse"
                   else "B1c" if want["chunk_cull"] else "B1")
            print(f"{name}: {got[0]['triangles']} triangles -> {got[0]['choices']}; "
                  f"launches {counts}")
            check(got[0]["choices"] == want, f"cli {name} resolved {got[0]}, table {want}")
            check(counts[ran] > 0, f"cli {name}: no {ran} launch ({counts})")
    from montecarlopathtracer_tpu_torch.models import bunny
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings

    scene, camera = bunny.bunny_scene(subdiv=6, width=BW, height=BH, device="cuda")
    settings = RenderSettings(width=BW, height=BH, spp_per_pass=1, seed=0)
    rs = {sort: Renderer(scene, camera, TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0,
                                                    intersector="traverse", ray_sort=sort),
                         settings, device="cuda") for sort in (True, False)}
    times = {True: [], False: []}
    for sort in (True, False, False, True, True, False):
        rs[sort].render(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs[sort].render(1)
        torch.cuda.synchronize()
        times[sort].append(time.perf_counter() - t0)
    print(f"bunny {BW}x{BH} traverse pass, 1 spp: sorted {[round(t * 1e3, 2) for t in times[True]]}"
          f" ms, unsorted {[round(t * 1e3, 2) for t in times[False]]} ms; {smi}")
    return times


def nan_guard(torch):
    phase(f"40. the NaN guard on the card: per-segment outputs finite at {W}x{H}, fixed and "
          f"RR; the 160x120 gradient under detect_anomaly; one {BW}x{BH} traverse pass of "
          "the glossy bunny")
    from montecarlopathtracer_tpu_torch.diff import grad as G
    from montecarlopathtracer_tpu_torch.models import bunny, cornell
    from montecarlopathtracer_tpu_torch.ops import segment_fused as F
    from montecarlopathtracer_tpu_torch.ops.rng import fold_in, make_key, stream_uniforms
    from montecarlopathtracer_tpu_torch.render.integrator import TraceConfig
    from montecarlopathtracer_tpu_torch.render.renderer import Renderer, RenderSettings

    scene, camera = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                        width=W, height=H, device="cuda")
    rows = F.pack_rows_full(scene)
    for config in (TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0),
                   TraceConfig(mode="rr", rr_depth=5, illum=1.0)):
        key = fold_in(fold_in(make_key(40), 0), 0)
        pos, dir_, tput, res, live = camera_wavefront(torch, camera, W, H, key)
        flags = config.segment_flags("cuda")
        for seg in range(config.num_segments):
            u1, u2, urr = stream_uniforms(key, (4 * seg, 4 * seg + 1, 4 * seg + 2), W * H, "cuda")
            out = F.mega_segment(rows, pos, dir_, tput, res, live, u1, u2, urr, flags[seg])
            _, pos, dir_, tput, res, still = out
            bad = [n for n, t in zip(("pos", "dir", "tput", "res", "still"), out[1:])
                   if not bool(torch.isfinite(t).all())]
            check(not bad, f"{config.mode} segment {seg}: non-finite {bad}")
            live = still > 0.0
        print(f"{config.mode}: {config.num_segments} segments, every output finite; "
              f"{int(live.sum())} lanes live at the end, radiance mean {float(res.mean()):.5f}")
    w, h = 160, 120
    small, cam = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                     width=w, height=h, device="cuda")
    loss_fn = G.make_loss_fn(small, cam, torch.zeros(h, w, 3, device="cuda"), width=w,
                             height=h, spp=1, config=TraceConfig(mode="fixed", max_depth=DEPTH))
    with torch.autograd.detect_anomaly(check_nan=True):
        loss, grads = G.value_and_grad(
            loss_fn, G.split_params(small, ("mat_kd", "mat_ka", "vertices")), make_key(41))
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()), "non-finite gradients")
    print(f"gradient at {w}x{h}: loss {float(loss):.6f}, every gradient finite under "
          "detect_anomaly")
    gscene, gcam = bunny.bunny_scene(subdiv=6, width=BW, height=BH, glossy=True, device="cuda")
    r = Renderer(gscene, gcam, TraceConfig(mode="fixed", max_depth=DEPTH, illum=10.0,
                                           intersector="traverse", ray_sort=True),
                 RenderSettings(width=BW, height=BH, spp_per_pass=1, seed=0), device="cuda")
    t0 = time.perf_counter()
    r.render(1)
    torch.cuda.synchronize()
    img = r.film.color
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0, "glossy bunny film")
    print(f"glossy bunny pass {time.perf_counter() - t0:.3f} s (kernels built), film mean "
          f"{float(img.mean()):.5f}, finite")


def main():
    if not os.path.isdir(os.path.join(HERE, PKG, "csrc")):
        print(f"chip_smoke: FAIL: {PKG} is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch

    try:
        name, smi = environment(torch)
        libs = build()
        rng_ms = rng_vs_plain(torch)
        keyed = keyed_draws(torch)
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
        main_counts, per_pass, msps = main_path(torch, scene, camera)
        launches = main_counts["B1"]
        breakdown(torch, scene, camera, per_pass)
        whole_frame(torch, scene)
        grad_builds(libs)
        bwd_err, (idx, d_full) = backward_vs_plain(torch, rows, bounce)
        phase("9. row scatter kernel (B3) vs plain, 652 triangles x 480,000 rays")
        check(rows.shape[0] == 652 and idx.shape[0] == W * H,
              f"T {rows.shape[0]}, R {idx.shape[0]}")
        sc_err = scatter_vs_plain(torch, idx, d_full, rows.shape[0],
                                  "800x600 segment vjp d_full")
        bwd_ms, sc_ms, small_sc = time_backward(torch, rows, bounce)
        counts, per_iter, grad_msps = grad_main_path(torch, scene, camera)
        sgd_steps(torch, scene, camera)
        adam = adam_graphed(torch, scene, camera)
        grad_frame(torch, scene)
        regen_builds(libs)
        lane_err, lane_ms = lane_vs_plain(torch, rows, bounce)
        regen_counts, regen_msps = regen_main_path(torch, scene, camera)
        b1r = regen_pass_vs_host(torch, scene, camera, smi)
        regen_steps = b1r["Cornell RR"]["lane_steps"]
        regen_share = b1r["Cornell RR"]["live_share"]
        del idx, d_full
        bscene, bcam, bconfig, tables = bunny_setup(torch)
        waves = bunny_waves(torch, bcam, bconfig, tables)
        g = torch.Generator(device="cuda").manual_seed(17)
        sub = torch.randperm(BW * BH, device="cuda", generator=g)[:SUBSET].sort().values
        b5_err, b5t = traverse_vs_plain(torch, bscene, tables, waves, sub)
        b6_err, b_idx, b_draws, b6_cases = rows_vs_plain(torch, tables, waves[1])
        b5_ms, b6_ms, b1_ms, b5_old = time_bunny(torch, bscene, tables, b5t[0], waves[1], sub,
                                                 b_idx, b_draws, b6_cases)
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
        rec_err, rec_ms = records_vs_plain(torch, gtables)
        cull_visits_phase(torch, gscene, gtables, gwaves)
        gbounce = gwaves[1]
        del gwaves, ctables
        cull_counts, cull_split_counts, cull_per_pass, cull_msps = cull_main_path(
            torch, gscene, gcam, gconfig)
        split_counts, fused_counts, split_per_pass, split_msps, fused_s = split_main_path(
            torch, scene, camera)
        split_grad_counts, split_grad_s = split_grad(torch, scene, camera)
        geom_counts, geom_s = geometry_step(torch)
        selection_builds(libs)
        var_ms, var_err = variants_vs_plain(torch, scene, bounce, gscene, gbounce)
        del gbounce
        gate_counts, gate_gap = intersector_gate(torch, scene)
        bench_rows, bench_counts, bench_err, micro_counts, micro, micro_gates, cublas_ms = \
            tool_twins(torch)
        walk_ms, kd_pass = kdtree_main_path(torch, scene, camera, bounce)
        shard = sharded_paths(torch, scene, camera, smi)
        bench_rec, twin_counts = bench_twin(torch, smi, regen_counts)
        suite_counts = suite_twin(torch)
        auto_choices(torch, smi)
        nan_guard(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"\nmain path: {per_pass:.4f} s/pass, {msps:.4f} Msamples/s forward; "
          f"gradient path: {per_iter:.4f} s/iteration, {grad_msps:.4f} Msamples/s fwd+bwd")
    print(f"RR regen (Cornell {W}x{H}, {REGEN_SPP} spp/pass): {regen_msps:.4f} Msamples/s, "
          f"lane steps min / median / max {regen_steps}, live share {regen_share:.4f}; "
          f"bunny traverse ({BW}x{BH}, depth {DEPTH} + 1, "
          f"1 spp): {bunny_msps:.4f} Msamples/s; bunny fwd+bwd ({BUNNY_GRAD_W}x"
          f"{BUNNY_GRAD_W}, 1 spp): {bgrad_msps:.4f} Msamples/s; on {smi}")
    print(f"glossy cull ({GW}x{GH}, {CULL_SPP} spp/pass): {cull_msps:.4f} Msamples/s; split "
          f"path (Cornell {W}x{H}, {SPP} spp/pass): {split_msps:.4f} Msamples/s, fused pass "
          f"{fused_s:.4f} s; split fwd+bwd {split_grad_s:.4f} s/iteration "
          f"({split_grad_counts}); geometry step {geom_s:.4f} s ({geom_counts})")

    print(f"selection entries (Cornell {W}x{H} bounce): " + ", ".join(
        f"{k} {v[0]:.4f} ms" for k, v in var_ms.items()) + f"; intersector gate max t gap on "
        f"near-ties {gate_gap:.2e}; KD walk {walk_ms:.2f} ms per {W}x{H} wavefront, kdtree "
        f"pass ({KD_SPP} spp) {kd_pass:.4f} s")

    def entry(name, source, replaces, launches, err, timing, dev, lib_dev=None, **extra):
        """One kernel's numbers; ``ms`` is the CUDA-event pair around one
        call (host work of the wrapper included), ``device_ms`` the device
        time per launch (DEVICE_MS[dev]); ``launches_bench`` and
        ``launches_suite`` its launches in phase 37's bench twin and,
        summed over the rows' timed passes, in phase 38's suite rows."""
        ms, plain_ms, (bound_ms, bound_by), *lib = timing
        dms, src, _ = DEVICE_MS[dev]
        count = dev if dev in twin_counts else dev.split()[0]
        extra.setdefault("launches_bench", twin_counts.get(count, 0))
        extra.setdefault("launches_suite", suite_counts.get(count, 0))
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "device_ms": dms,
                "device_ms_source": src, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib[0] if lib else None,
                **({"library_device_ms": DEVICE_MS[lib_dev][0]} if lib_dev else {}), **extra}

    print(json.dumps({"kernels": [
        entry("mega_segment", KERNEL_SOURCE, REPLACES, launches, max_err, b1_timing, "B1",
              launches_sharded=shard["36a"]["B1"],
              launches_adam_graphed=adam["launches_adam_graphed"]["B1"]),
        entry("mega_segment (lane flags, B1l; its launches: the host loop regen_pass_ref, "
              "phase 16b)", KERNEL_SOURCE, LANE_REPLACES,
              b1r["Cornell RR"]["host_launches"]["B1l"], lane_err, lane_ms, "B1l"),
        *(entry(name, PASS_SOURCE, PASS_REPLACES, n, b1r["err"],
                (b1r[label]["pair"], b1r[label]["plain_ms"], b1r[label]["bound"]),
                b1r[label]["dev"], loop=PASS_LOOP, spp=spp,
                lane_steps_min_median_max=b1r[label]["lane_steps"],
                live_share=b1r[label]["live_share"], pinned_share=b1r[label]["pinned_share"],
                pairs_tested_exact=b1r[label]["pairs"], **extra)
          for name, label, spp, n, extra in (
              ("regen_pass (B1r: a whole regen pass in one launch)", "Cornell RR",
               REGEN_SPP, regen_counts["B1r"], {"launches_sharded": shard["36d"]["B1r"]}),
              ("regen_pass (chunk cull, B1rc)", "glossy fixed cull", 16,
               b1r["launches"]["B1rc"],
               {"vote_chunks_per_live_lane_step_kernel_pinned_own":
                b1r["glossy fixed cull"]["vote"]}))),
        entry("segment_backward", BWD_SOURCE, BWD_REPLACES, counts["B2"], bwd_err, bwd_ms,
              "B2", launches_sharded=shard["36c"]["B2"],
              launches_adam_graphed=adam["launches_adam_graphed"]["B2"],
              adam_graphed_max_rel_gap=adam["adam_graphed_max_rel_gap"]),
        entry("scatter_rows (T = 652)", SCATTER_SOURCE, SCATTER_REPLACES, counts["B3"], sc_err,
              sc_ms, "B3 T652", "index_add_ T652", launches_sharded=shard["36c"]["B3"],
              launches_adam_graphed=adam["launches_adam_graphed"]["B3"],
              launches_suite=0),  # the suite's only gradient row is the bunny's
        entry("scatter_rows (T = 32, small-table path: the inverse cell's calls)",
              SCATTER_SOURCE, SCATTER_REPLACES, small_sc["launches"], small_sc["err"],
              small_sc["timing"], "B3 T32", launches_bench=twin_counts.get("B3s", 0),
              launches_suite=suite_counts.get("B3s", 0),
              **{k: v for k, v in small_sc.items() if k not in ("timing", "err", "launches")}),
        entry("scatter_rows (T = 81,932)", SCATTER_SOURCE, SCATTER_REPLACES,
              bgrad_counts["B3"], bsc_err, bsc_ms, "B3 T81932", "index_add_ T81932",
              launches_bench=0),
        entry("traverse_select (B5)", TRAVERSE_SOURCE, TRAVERSE_REPLACES,
              bunny_counts["B5"], b5_err, b5_ms, "B5", max_t_gap_on_near_ties=b5_err,
              rays=BW * BH, plain_rays=SUBSET, bound_old_count_ms=b5_old[0]),
        entry("traverse tables (B5t: B5's tree and triangle records)", TRAVERSE_SOURCE,
              TABLES_REPLACES, bunny_counts["B5t"], b5t[1], b5t[2], "B5t",
              earlier_device_ms=DEVICE_MS["B5t earlier both"][0],
              earlier_records_kernel_ms=DEVICE_MS["B5t earlier records"][0],
              earlier_tree_kernel_ms=DEVICE_MS["B5t earlier tree"][0]),
        entry("uniform draws (RNG; not a TPU kernel: counterpart of jax.random.uniform)",
              RNG_SOURCE, RNG_REPLACES, main_counts["RNG"], 0.0, rng_ms, "RNG",
              launches_grad=counts["RNG"], launches_regen=regen_counts["RNG"],
              launches_regen_host_loop=b1r["Cornell RR"]["host_launches"]["RNG"],
              launches_bunny=bunny_counts["RNG"], launches_sharded=shard["36a"]["RNG"],
              launches_adam_graphed=adam["launches_adam_graphed"]["RNG"], **keyed,
              rays=W * H, streams=3,
              device_ms_1m_rays_2_streams=DEVICE_MS["RNG 1M"][0]),
        entry("rows_segment (B6)", ROWS_SOURCE, ROWS_REPLACES, bunny_counts["B6"],
              b6_err["B6"], b6_ms["B6"], "B6"),
        entry("rows_segment (lane flags, B6l)", ROWS_SOURCE, ROWS_LANE_REPLACES,
              bregen_counts["B6l"], b6_err["B6l"], b6_ms["B6l"], "B6l"),
        entry("mega_segment (chunk cull, B1c)", KERNEL_SOURCE, CULL_REPLACES,
              cull_counts["B1c"], b1c_err, split_ms["B1c"], "B1c"),
        entry("nearest_shade_full (B4)", SHADE_SOURCE, SHADE_REPLACES, split_counts["B4"],
              shade_err["B4"], split_ms["B4"], "B4", launches_sharded=shard["36e"]["B4"]),
        entry("nearest_shade_full (chunk cull, B4c)", SHADE_SOURCE, SHADE_CULL_REPLACES,
              cull_split_counts["B4c"], shade_err["B4c"], split_ms["B4c"], "B4c"),
        entry("cull records (B4r: the culled loop's triangle records and leaf boxes)",
              SHADE_SOURCE, RECORDS_REPLACES, cull_counts["B4r"], rec_err, rec_ms, "B4r"),
        entry("nearest_triangle (B7)", TRIANGLE_SOURCE, TRIANGLE_REPLACES,
              fused_counts["B7"], shade_err["B7"], split_ms["B7"], "B7",
              max_t_gap_on_near_ties=shade_err["B7"],
              control_device_ms=DEVICE_MS["B7 control"][0]),
        *(entry(label, SHADE_SOURCE, VARIANT_REPLACES[k], n,
                max(var_err[k], bench_err.get(k, 0.0)), var_ms[k], k)
          for k, label, n in (
              ("B8", "nearest_shade (B8, entry over B4)", bench_counts["B8"]),
              ("B9", "nearest_shade2 (B9, entry over B4)", bench_counts["B9"]),
              ("B10", "nearest_shade_streamed (B10, entry over B4)", bench_counts["B10"]),
              ("B10c", "nearest_shade_streamed cull (B10, entry over B4c)",
               bench_counts["B10c"]),
              ("B11", "nearest_shade_culled (B11, entry over B4c with the d'z test)",
               gate_counts["B11"]))),
        *(entry(label, MICRO_SOURCE, MICRO_REPLACES[k], micro_counts[n], micro[k][3],
                (*micro[k][:3], *((cublas_ms[k],) if k in cublas_ms else ())),
                k if k in ("B13", "B14") else f"B12 {k}",
                f"cuBLAS {k}" if k in cublas_ms else None, rays=491_520,
                **({"gate": micro_gates[k]} if k in micro_gates else {}))
          for k, label, n in (
              ("full", "selection_micro full (B12, body_v3)", "B12 full"),
              ("matmul_only", "selection_micro matmul_only (B12)", "B12 matmul_only"),
              ("matmul_bf16", "selection_micro matmul_bf16 (B12)", "B12 matmul_bf16"),
              ("B13", "epilogue_only, resident p_all (B13)", "B13"),
              ("B14", "epilogue_shared, one p block (B14)", "B14"))),
    ]}))
    print(f"bench twin (phase 37): {json.dumps(bench_rec)}")
    print("sharded paths (phase 36) launches: " + "; ".join(f"{k} {v}" for k, v in shard.items()))
    print(f"bunny gradient launches: {bgrad_counts}; brute B1 on the bunny wavefront "
          f"{b1_ms[0]:.4f} ms")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
