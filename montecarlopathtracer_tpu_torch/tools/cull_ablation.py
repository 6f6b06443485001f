"""The culled selection loop's design choices, each taken out in turn and
timed on the card.

The culled loop (``csrc/sphere_select.cuh::select_culled``, under B1c,
B4c and the entries B10c and B11) makes the warp its unit: per-warp votes,
the chunks of a window of 32 visited nearest first, leaf boxes of 16
triangles inside a chunk, each lane's own queue of exact tests, the
spheres of 8 records tested at a time. This tool builds variants of
``csrc/nearest_shade.cu`` (B4c) with one of those choices taken out,
by a textual patch of the sources into ``build/torch_kernels/ablation/``,
and times each beside the loop as it stands and B4 (no culling), on the
glossy stage's 800×600 camera wavefront and its sorted first bounce
(1,332 triangles, 11 chunks of 128) and on the bunny's 1024×1024 ones
(81,932 triangles, 641 chunks). Every variant must return B4's idx, tbg
and shade bit for bit, or the tool fails: none of the choices may drop a
winner. A patch whose anchor is no longer in the source fails too.

Variants:

- ``index order``: each warp visits its chunks in index order (the keys
  are still computed, the sort is not);
- ``no keys``: index order without the key phase (every chunk
  slab-tested only when the warp comes to it);
- ``no leaves``: every leaf of a chunk the warp votes for is tested;
- ``common exact order``: the exact tests of a leaf in one order for the
  whole warp (pair k of ray a, then of ray b, as the unculled loop), so
  that a step serves only the lanes that need that pair;
- ``4 spheres at a time``;
- ``registers <= 80``: ``__launch_bounds__`` with a minimum of blocks;
- ``records in shared memory``: each block stages the table's records
  whole in shared memory (64 bytes a row, up to the opt-in 227 KB of a
  block) instead of reading them through the read-only path; not run on
  a table that does not fit.

Device time per launch: CUDA events around 20 back-to-back calls queued
behind a ``torch.cuda._sleep`` (the median of three such spans), as
``chip_smoke.py`` times kernels. Prints a line per wavefront, then one
JSON line ``{"ablation": {wavefront: {variant: ms}}}``.

Usage::

    python -m montecarlopathtracer_tpu_torch.tools.cull_ablation [--skip-bunny]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import cuda_build
from ..ops import nearest_shade as NS
from ..ops import segment_fused as F

_NO_SORT = [("    key = warp_sort(key, lane);\n", ""),
            ("if (key != ~0u) key = (key & ~31u) | static_cast<unsigned>(lane);",
             "if (key != ~0u) key = static_cast<unsigned>(lane);"),
            ("if (kp == ~0u) break;", "if (kp == ~0u) continue;")]
# Sources patched per variant: {file: [(anchor, replacement)]}.
VARIANTS = {
    "as it stands": {},
    "index order": {"sphere_select.cuh": _NO_SORT},
    "no keys": {"sphere_select.cuh": [
        _NO_SORT[0], _NO_SORT[2],
        ("if (key != ~0u) key = (key & ~31u) | static_cast<unsigned>(lane);",
         "key = lane < nw ? static_cast<unsigned>(lane) : ~0u;"),
        ("    for (int q = 0; q < nw; ++q) {\n      float tn;",
         "    for (int q = 0; q < 0; ++q) {\n      float tn;")]},
    "no leaves": {"sphere_select.cuh": [
        ("const bool la = ta && leaf_reach(leaves, l, sa, ext_a, ra.h.t);", "const bool la = ta;"),
        ("const bool lb = tb && leaf_reach(leaves, l, sb, ext_b, rb.h.t);", "const bool lb = tb;")]},
    "common exact order": {"sphere_select.cuh": [
        ("  while (m != 0u) {\n    const int bit = __ffs(m) - 1;\n    m &= m - 1u;",
         "  for (int bit = 0; bit < 2 * kLeaf; ++bit) {\n    if (!(m & (1u << bit))) continue;")]},
    "4 spheres at a time": {"sphere_select.cuh": [
        ("constexpr int kCullUnroll = 8;", "constexpr int kCullUnroll = 4;")]},
    "registers <= 80": {"nearest_shade.cu": [
        ("__global__ void __launch_bounds__(kSelThreads)\nnearest_shade_kernel",
         "__global__ void __launch_bounds__(kSelThreads, 6)\nnearest_shade_kernel")]},
    "records in shared memory": {
        "sphere_select.cuh": [
            ("s[j] = __ldg(rec + 4 * (k + j));", "s[j] = rec[4 * (k + j)];"),
            ("pair_test(__ldg(g), __ldg(g + 1), __ldg(g + 2),", "pair_test(g[0], g[1], g[2],"),
            ("  if (!__syncthreads_or(act_a || act_b)) return;\n",
             "  if (!__syncthreads_or(act_a || act_b)) return;\n"
             "  float4* staged = smem + cull_vote_float4s(T);\n"
             "  for (int q = threadIdx.x; q < 4 * T; q += kCullThreads) "
             "cp_async16(staged + q, rec + q);\n"
             "  cp_async_commit();\n  cp_async_wait<0>();\n  __syncthreads();\n"),
            ("test_chunk<kDzTest>(rec + 4 * base,", "test_chunk<kDzTest>(staged + 4 * base,"),
            ("return cull_vote_float4s(T) * static_cast<int>(sizeof(float4));",
             "return (cull_vote_float4s(T) + 4 * T) * static_cast<int>(sizeof(float4));")],
        "nearest_shade.cu": [
            ("      const int bytes = seg::cull_smem_bytes(T);\n",
             "      const int bytes = seg::cull_smem_bytes(T);\n"
             "      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, "
             "bytes);\n")]},
}
# The largest table whose records a block can stage (227 KB of shared
# memory, less the vote bits).
SMEM_ROWS = (227 * 1024 - 1024) // 64


def _build(name: str):
    """The variant's nearest_shade library: (name, path)."""
    out = cuda_build.BUILD_DIR / "ablation" / name.replace(" ", "_").replace("<=", "le")
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for src in cuda_build.CSRC.glob("*.cu*"):
        text = src.read_text()
        for anchor, repl in VARIANTS[name].get(src.name, []):
            if anchor not in text:
                raise RuntimeError(f"variant {name!r}: anchor not in {src.name}: {anchor!r}")
            text = text.replace(anchor, repl)
        (out / src.name).write_text(text)
    lib = out / "nearest_shade.so"
    cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
           str(out / "nearest_shade.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name!r}:\n{proc.stderr}")
    return name, lib


def _launcher(path):
    lib = ctypes.CDLL(str(path))
    fn = lib.nearest_shade_launch
    fn.restype = ctypes.c_int
    P = ctypes.c_void_p
    fn.argtypes = [P, ctypes.c_int, P, P, P, ctypes.c_int, P, P, P, P, ctypes.c_int,
                   ctypes.c_int, P, P, P, P, P]

    def call(rows, pos, dir_, live, boxes, out):
        err = fn(rows.data_ptr(), rows.shape[0], pos.data_ptr(), dir_.data_ptr(),
                 live.data_ptr(), pos.shape[1], boxes["clo"].data_ptr(),
                 boxes["chi"].data_ptr(), boxes["cslack"].data_ptr(), boxes["crec"].data_ptr(),
                 1, 0, *(x.data_ptr() for x in out), None,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")

    return call


def device_ms(fn, n: int = 20) -> float:
    """Device ms per call of ``fn()``: CUDA events around ``n`` calls
    queued behind a ``torch.cuda._sleep`` that outlasts their enqueueing;
    the median of three spans."""
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
        torch.cuda._sleep(int(3 * host * 2e9) + 1_000_000)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        spans.append(a.elapsed_time(b) / n)
    return statistics.median(spans)


def _waves(scene, camera, width, height):
    """The culling tables of ``scene`` and its camera wavefront and sorted
    first bounce (dead lanes last), as ``chip_smoke.py`` makes them."""
    from ..ops.morton import DEAD_KEY, ray_sort_keys
    from ..ops.rng import make_key, stream_uniforms
    from ..render.integrator import TraceConfig, scene_tables

    config = TraceConfig(chunk_cull=True, ray_sort=True)
    tables = scene_tables(scene, config)
    R = width * height
    key = make_key(24)
    pix = torch.arange(R, device="cuda")
    jx, jy = stream_uniforms(key, (1 << 30, (1 << 30) + 1), R, "cuda") * 2.0 - 1.0
    pos, dir_ = camera.generate_rays_soa(pix % width, pix // width, jx, jy, width, height)
    pos, dir_ = pos.contiguous(), dir_.contiguous()
    live = torch.ones(R, dtype=torch.bool, device="cuda")
    u = stream_uniforms(key, (0, 1, 3), R, "cuda")
    out = F.mega_segment(tables.rows, pos, dir_, torch.ones(3, R, device="cuda"),
                         torch.zeros(3, R, device="cuda"), live, *u,
                         torch.zeros(3, 1, device="cuda"), **tables.cull_boxes)
    alive = out[5] > 0.0
    keys = torch.where(alive, ray_sort_keys(out[1], out[2], tables.lo, tables.hi), DEAD_KEY)
    order = torch.argsort(keys, stable=True)
    bounce = (out[1][:, order].contiguous(), out[2][:, order].contiguous(),
              alive[order].contiguous())
    return tables, {"camera": (pos, dir_, live), "sorted bounce": bounce}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-bunny", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cull_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    from ..models import bunny, glossy

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(_build, VARIANTS))
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    calls = {name: _launcher(path) for name, path in libs.items()}
    scenes = [("glossy", *glossy.glossy_steps(width=800, height=600, device="cuda"), 800, 600)]
    if not args.skip_bunny:
        scenes.append(("bunny", *bunny.bunny_scene(width=1024, height=1024, device="cuda"),
                       1024, 1024))
    result = {}
    for sname, scene, camera, width, height in scenes:
        tables, waves = _waves(scene, camera, width, height)
        rows, boxes = tables.rows.detach(), tables.cull_boxes
        for wname, (pos, dir_, live) in waves.items():
            R = pos.shape[1]
            want = NS.nearest_shade_full(rows, pos, dir_, live)
            out = (torch.empty(R, dtype=torch.int32, device="cuda"),
                   torch.empty(4, R, device="cuda"), torch.empty(32, R, device="cuda"))
            times = {}
            for name, call in calls.items():
                if name == "records in shared memory" and rows.shape[0] > SMEM_ROWS:
                    continue
                call(rows, pos, dir_, live, boxes, out)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(out, want)):
                    print(f"cull_ablation: variant {name!r} differs from B4 on {sname} {wname}",
                          file=sys.stderr)
                    return 1
                times[name] = device_ms(lambda call=call: call(rows, pos, dir_, live, boxes, out))
            times["B4 (no culling)"] = device_ms(
                lambda: NS.nearest_shade_full(rows, pos, dir_, live))
            label = f"{sname} {wname} ({rows.shape[0]} rows, {int(live.sum())} live rays)"
            result[label] = times
            print(f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
                  + " ms; every variant bit-equal to B4")
    print(json.dumps({"ablation": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
