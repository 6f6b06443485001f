"""Selection-entry benchmark on the card: the twin of the JAX package's
``tools/kernel_bench.py``.

Times one intersection wavefront (R rays × T triangles → winner index,
exact t, β, γ and the shading row) through each superseded selection
entry of :mod:`..ops.nearest_variants`: ``v1`` (``nearest_shade``, B8),
``v2`` (``nearest_shade2``, B9), ``v3`` (``nearest_shade_streamed`` with
its default chunk of 256, B10) and ``v3_cull_tc128`` (the same with
chunk culling over a Morton-ordered table, B10 on B4c), on the Cornell
box with both spheres and on the bunny at subdivision 6 (81,932
triangles), each padded to a multiple of 128 triangles as the JAX scenes
are. Rays, as there: half camera rays of a 512×512 frame, half random
rays from inside the scene box (numpy, seeded). Prints one JSON line per
variant with ``scene``, ``T``, ``kernel``, ``ms`` (median of ``--iters``
calls after one warm-up, a CUDA event pair around each) and
``mray_segments_s``.

What differs from the JAX tool: one precision (the port's selection is
plain f32; the JAX tool's bf16 / bf16x3 axis is a TPU matmul setting);
one ``v3`` row (the JAX tool's sweep of the streamed chunk over 128, 256
and 512 has no counterpart: here the chunk only defines the packing,
which the entry unpacks into the same row table for one kernel); and
``v1``/``v2`` run on the bunny too (the JAX tool's 20k-triangle cap is
a TPU VMEM limit).

Usage::

    python -m montecarlopathtracer_tpu_torch.tools.kernel_bench [--rays N] [--iters K]
        [--skip-large] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..models import bunny, cornell
from ..ops import nearest_variants as NV
from ..ops.intersect import triangle_transforms
from ..ops.morton import chunk_aabbs_padded, morton_order
from ..scene.scene import ScenePack

LANE = 128  # the JAX scenes' triangle padding
STREAM_CHUNK = 256  # JAX nearest_shade_streamed's default chunk


def pad_scene(scene: ScenePack) -> ScenePack:
    """The scene with its triangle axis padded to a multiple of 128 as
    the JAX package pads it: vertex, normal and material index 0,
    ``tri_valid`` False."""
    pad = -scene.num_triangles % LANE
    if not pad:
        return scene

    def grow(x, fill):
        return torch.cat([x, torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype,
                                        device=x.device)])

    return ScenePack(**{**scene.__dict__, "tri_v": grow(scene.tri_v, 0),
                        "tri_n": grow(scene.tri_n, 0), "tri_mat": grow(scene.tri_mat, 0),
                        "tri_valid": grow(scene.tri_valid, False)})


def rays_for(scene, camera, R, seed=0, frame=512):
    """(pos3, dir3) f32[3, R]: R // 2 jittered camera rays of a
    ``frame`` × ``frame`` image, then random unit directions from points
    inside the scene box shrunk by 0.1, from numpy's ``default_rng(seed)``
    in the JAX tools' order (``_rays_for`` here; ``tools/tpu_check.py``'s
    ``_rays`` with ``frame=64``)."""
    dev = camera.device
    rng = np.random.default_rng(seed)
    n1 = R // 2
    pix = rng.integers(0, frame * frame, n1)
    jx = torch.as_tensor(rng.uniform(-1, 1, n1).astype(np.float32), device=dev)
    jy = torch.as_tensor(rng.uniform(-1, 1, n1).astype(np.float32), device=dev)
    pix = torch.as_tensor(pix, device=dev)
    o1, d1 = camera.generate_rays_soa(pix % frame, pix // frame, jx, jy, frame, frame)
    lo, hi = (x.cpu().numpy() for x in scene.aabb())
    n2 = R - n1
    o2 = rng.uniform(lo + 0.1, hi - 0.1, (n2, 3)).astype(np.float32)
    d2 = rng.normal(size=(n2, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = torch.cat([o1, torch.as_tensor(o2.T, device=dev)], dim=1).contiguous()
    d = torch.cat([d1, torch.as_tensor(d2.T, device=dev)], dim=1).contiguous()
    return o, d


def timed(fn, iters: int, device):
    """(median seconds of one ``fn()`` call over ``iters`` ≥ 1 calls
    after one warm-up, the last call's result): a CUDA event pair around
    each call on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def variants(scene):
    """``{kernel: call(pos3, dir3)}`` of the benchmark's entries on one
    padded scene (the packings of the JAX tool), each for rays ``pos3``,
    ``dir3`` f32[3, R], all of them live."""
    a, b, c = scene.triangle_vertices()
    m, m_a = triangle_transforms(a, b, c)
    valid = scene.tri_valid
    T = a.shape[0]
    tc = NV.divisor_chunk(T, NV.T_CHUNK)
    w = NV.pack_transforms(m, m_a, valid)
    wf = NV.pack_transforms_fused(m, m_a, valid, tc)
    geom = w[:3, :4, :].reshape(12, -1).T.contiguous()
    table = NV.pack_shading_table(scene)
    ws = NV.pack_transforms_stream(m, m_a, valid, STREAM_CHUNK)
    perm = morton_order(a, b, c, valid)
    ws_cull = NV.pack_transforms_stream(m[perm], m_a[perm], valid[perm], 128)
    geom_cull, table_cull = geom[perm].contiguous(), table[perm].contiguous()
    clo, chi = chunk_aabbs_padded(a, b, c, valid, perm, 128)

    def cull(pos3, dir3):
        live = torch.ones(pos3.shape[1], dtype=torch.bool, device=pos3.device)
        return NV.nearest_shade_streamed(ws_cull, geom_cull, table_cull, pos3, dir3, live,
                                         clo, chi, t_chunk=128, cull=True)

    return {
        "v1": lambda pos3, dir3: NV.nearest_shade(w, table, pos3, dir3),
        "v2": lambda pos3, dir3: NV.nearest_shade2(wf, geom, table, pos3, dir3, t_chunk=tc),
        "v3": lambda pos3, dir3: NV.nearest_shade_streamed(ws, geom, table, pos3, dir3,
                                                           t_chunk=STREAM_CHUNK),
        "v3_cull_tc128": cull,
    }


def scenes(skip_large: bool, device):
    """The benchmark's scenes, padded: ``[(name, scene, camera)]``."""
    out = [("cornell", *cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                            width=512, height=512, device=device))]
    if not skip_large:
        out.append(("bunny", *bunny.bunny_scene(subdiv=6, width=512, height=512,
                                                device=device)))
    return [(name, pad_scene(s), cam) for name, s, cam in out]


def run(rays: int = 480_000, iters: int = 10, skip_large: bool = False, device="cuda",
        keep=None):
    """Time every variant on every scene; returns the rows that
    :func:`main` prints as JSON lines. Given a dict ``keep``, also stores
    under each scene's name what a caller needs to check the results:
    ``{"scene", "pos3", "dir3", "calls", "out": {kernel: (idx, tbg,
    shade) of its last timed call}}``."""
    device = torch.device(device)
    rows = []
    with torch.no_grad():
        for name, scene, camera in scenes(skip_large, device):
            pos3, dir3 = rays_for(scene, camera, rays)
            calls, outs = variants(scene), {}
            for kernel, call in calls.items():
                dt, out = timed(lambda: call(pos3, dir3), iters, device)
                if keep is not None:
                    outs[kernel] = out
                rows.append({"scene": name, "T": scene.num_triangles, "kernel": kernel,
                             "ms": dt * 1e3, "mray_segments_s": rays / dt / 1e6,
                             "device": device.type})
            if keep is not None:
                keep[name] = dict(scene=scene, pos3=pos3, dir3=dir3, calls=calls, out=outs)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=480_000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--skip-large", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions (small --rays only)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("error: no CUDA device is available (--device cpu runs the plain versions)",
              file=sys.stderr)
        return 2
    if args.iters < 1:
        print(f"error: --iters must be at least 1, got {args.iters}", file=sys.stderr)
        return 2
    if args.device.startswith("cuda"):
        print(f"device: {torch.cuda.get_device_name(0)}", file=sys.stderr)
    for row in run(args.rays, args.iters, args.skip_large, args.device):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
