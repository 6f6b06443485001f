"""Scene × intersector sweep of the port: the twin of the repository's
``tools/bench_suite.py``.

The original's plan, row for row and by name: the Cornell box (scene 1;
scene 2 is the same box when the reference mount is absent), the glossy
stage (1,332 triangles) and the bunny (81,932 triangles at subdivision
6) through the megakernel, the split path, chunk culling with and
without the wavefront sort, the traversal walk, RR with and without the
regenerating wavefront, the KD-tree walk and the bunny's value and
gradient through the traversal walk. Each row renders one warm-up pass
(which builds the kernels at first use) and then its timed passes,
fenced by ``torch.cuda.synchronize()``, and records the kernels it
launched (:func:`..utils.profiling.launches`).

Differences from the original:

- the rows of :data:`DROPPED` tune the TPU kernels' tiles
  (``ray_tile``, ``stream_chunk``), which the port does not have;
- ``scene1_kdtree_lax`` runs on the card at 256×192, 1 spp: the port's
  KD walk runs on the GPU, where the original skips it on the TPU;
- a row keeps its warm-up time as ``warmup_s`` (the original's
  ``compile_s``);
- the results go to ``out/bench_scenes_torch.json`` under the working
  directory, never to the repository's ``BENCH_SCENES.json``, with the
  card's name and power limit under ``device``;
- a failing row is recorded and the sweep goes on, but then the sweep
  exits 1.

The row sizes are module constants. Run on the card::

    python -m montecarlopathtracer_tpu_torch.tools.bench_suite [--quick]
        [--only SUBSTR] [--append] [--no-kdtree] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

OUT = os.path.join("out", "bench_scenes_torch.json")
WIDTH, HEIGHT = 800, 600
BUNNY_RES = 1024
BUNNY_SUBDIV = 6
KD_RES = (256, 192)
GRAD_RES = 512
GRAD_REPS = 3
SPP_PASSES = (4, 4)
QUICK_SPP_PASSES = (2, 2)
BUNNY_SPP_PASSES = (1, 4)
QUICK_BUNNY_SPP_PASSES = (1, 1)
REFERENCE_ANCHOR = {"scene1_gtx1070_msamples_s": 2.4, "scene2_gtx1070_msamples_s": 1.4}
# The original's rows that set the TPU kernels' ray tile and stream
# chunk: the port's kernels have neither knob.
DROPPED = ("bunny_cull_rt1024", "bunny_cull_rt2048", "bunny_traverse_rt1024",
           "bunny_traverse_rt2048", "bunny_traverse_tc256", "bunny_traverse_tc256_rt2048",
           "bunny_traverse_tc512_rt2048")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_config(name, scene, cam, config, width, height, spp, passes, regen, device):
    """One row: a warm-up pass, then ``passes`` timed passes."""
    from ..render.renderer import Renderer, RenderSettings
    from ..utils.profiling import launches, reset_launches

    settings = RenderSettings(width=width, height=height, spp_per_pass=spp, seed=0,
                              regen=regen)
    r = Renderer(scene, cam, config, settings, device=device)
    t0 = time.perf_counter()
    r.render(1)
    _sync(device)
    warmup_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    r.render(passes)
    _sync(device)
    dt = time.perf_counter() - t0
    film = r.film.color
    if not bool(torch.isfinite(film).all()):
        raise RuntimeError(f"{name}: the film holds non-finite values")
    msamples_s = width * height * spp * passes / dt / 1e6
    return {
        "config": name,
        "tris": int(scene.num_triangles),
        "res": f"{width}x{height}",
        "spp_x_passes": f"{spp}x{passes}",
        "warmup_s": round(warmup_s, 3),
        "seconds_per_pass": dt / passes,
        "msamples_s": round(msamples_s, 3),
        "mray_segments_s": round(msamples_s * config.num_segments, 1),
        "launches": {k: v for k, v in launches().items() if v},
    }


def bunny_grad_row(scene, cam, device):
    """Value and gradient of a pixel L2 loss in {Kd, Ka} through the
    traversal walk (with the wavefront sort) on the bunny."""
    from ..diff.grad import make_loss_fn, split_params, value_and_grad
    from ..ops.rng import make_key
    from ..render.integrator import TraceConfig
    from ..utils.profiling import launches, reset_launches

    cfg = TraceConfig(mode="fixed", max_depth=7, illum=10.0, ray_chunk=0,
                      intersector="traverse", ray_sort=True)
    w = h = GRAD_RES
    scene, cam = scene.to(device), cam.to(device)
    loss_fn = make_loss_fn(scene, cam, torch.zeros(h, w, 3, device=device), width=w,
                           height=h, spp=1, config=cfg)
    params = split_params(scene, ("mat_kd", "mat_ka"))
    t0 = time.perf_counter()
    loss, _ = value_and_grad(loss_fn, params, make_key(3))
    _sync(device)
    warmup_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    for i in range(GRAD_REPS):
        loss, grads = value_and_grad(loss_fn, params, make_key(4 + i))
    _sync(device)
    dt = (time.perf_counter() - t0) / GRAD_REPS
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        raise RuntimeError("bunny_grad_fwdbwd: non-finite gradients")
    return {
        "config": "bunny_grad_fwdbwd",
        "tris": int(scene.num_triangles),
        "res": f"{w}x{h}",
        "spp_x_passes": "1x1 (fwd+bwd)",
        "warmup_s": round(warmup_s, 3),
        "seconds_per_pass": dt,
        "msamples_s": round(w * h / dt / 1e6, 3),
        "mray_segments_s": round(w * h / dt / 1e6 * 8, 1),
        "launches": {k: v for k, v in launches().items() if v},
    }


def plan(quick: bool, kdtree: bool):
    """The rows as (name, scene, config keywords, width, height, spp,
    passes, regen); a scene is ``"s1"``, ``"s2"``, ``"glossy"`` or
    ``"bunny"``."""
    spp, passes = QUICK_SPP_PASSES if quick else SPP_PASSES
    bspp, bpasses = QUICK_BUNNY_SPP_PASSES if quick else BUNNY_SPP_PASSES
    W, H, B = WIDTH, HEIGHT, BUNNY_RES
    rr = {"mode": "rr"}
    rows = [
        ("scene1_megakernel", "s1", {}, W, H, spp, passes, False),
        # whole-segment ablation: the split path (B4 + the segment body in torch ops)
        ("scene1_split_segment", "s1", {"whole_segment": False}, W, H, spp, passes, False),
        ("scene1_cull", "s1", {"chunk_cull": True}, W, H, spp, passes, False),
        ("scene2_megakernel", "s2", {}, W, H, spp, passes, False),
        ("scene2_cull", "s2", {"chunk_cull": True}, W, H, spp, passes, False),
        ("glossy_megakernel", "glossy", {}, W, H, spp, passes, False),
        ("glossy_cull", "glossy", {"chunk_cull": True}, W, H, spp, passes, False),
        ("bunny_megakernel", "bunny", {}, B, B, bspp, bpasses, False),
        ("bunny_cull", "bunny", {"chunk_cull": True}, B, B, bspp, bpasses, False),
        ("bunny_cull_sort", "bunny", {"chunk_cull": True, "ray_sort": True}, B, B, bspp,
         bpasses, False),
        ("glossy_cull_sort", "glossy", {"chunk_cull": True, "ray_sort": True}, W, H, spp,
         passes, False),
        ("scene1_traverse", "s1", {"intersector": "traverse", "ray_sort": True}, W, H, spp,
         passes, False),
        ("scene2_traverse", "s2", {"intersector": "traverse", "ray_sort": True}, W, H, spp,
         passes, False),
        ("glossy_traverse", "glossy", {"intersector": "traverse", "ray_sort": True}, W, H,
         spp, passes, False),
        ("bunny_traverse", "bunny", {"intersector": "traverse", "ray_sort": True}, B, B, bspp,
         bpasses, False),
        ("scene1_rr_megakernel", "s1", rr, W, H, spp, passes, False),
        ("scene1_rr_regen", "s1", rr, W, H, spp, passes, True),
        ("scene1_rr_regen_spp32", "s1", rr, W, H, 32, 1, True),
        ("scene1_regen_spp16", "s1", {}, W, H, 16, 1, True),
        ("glossy_cull_regen_spp16", "glossy", {"chunk_cull": True}, W, H, 16, 1, True),
    ]
    if kdtree:
        rows.append(("scene1_kdtree_lax", "s1", {"intersector": "kdtree"}, *KD_RES, 1, 1,
                     False))
    return rows


def _scenes():
    """Builders of the sweep's scenes, each built once at first use."""
    from ..models import bunny, cornell, glossy

    made = {}

    def scene1(w, h):
        if cornell.has_reference_scenes():
            return cornell.load_reference_scene(1, width=w, height=h)
        return cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                   width=w, height=h)

    def scene2(w, h):
        if cornell.has_reference_scenes():
            return cornell.load_reference_scene(2, width=w, height=h)
        return scene1(w, h)

    builders = {
        "s1": scene1, "s2": scene2,
        "glossy": lambda w, h: glossy.glossy_steps(width=w, height=h),
        "bunny": lambda w, h: bunny.bunny_scene(subdiv=BUNNY_SUBDIV, width=w, height=h),
    }

    def get(key, w, h):
        if (key, w, h) not in made:
            made[key, w, h] = builders[key](w, h)
        return made[key, w, h]

    return get


def _write(path, append, results, device_name):
    if append and os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
        by_name = {r.get("config"): i for i, r in enumerate(out["results"])}
        for r in results:
            if r.get("config") in by_name:
                out["results"][by_name[r["config"]]] = r
            else:
                out["results"].append(r)
        out["device"] = device_name
    else:
        out = {"device": device_name, "reference_anchor": REFERENCE_ANCHOR,
               "dropped": list(DROPPED), "results": results}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default="", help="run only the rows whose name holds SUBSTR")
    ap.add_argument("--append", action="store_true",
                    help=f"merge the results into an existing {OUT} by row name")
    ap.add_argument("--kdtree", action="store_true", default=True,
                    help="include the KD-tree row (on by default)")
    ap.add_argument("--no-kdtree", dest="kdtree", action="store_false")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_suite: no CUDA device is available; pass --device cpu")
    from ..render.integrator import TraceConfig
    from ..utils.profiling import card

    device_name = card(device)
    print(f"device: {device_name}", file=sys.stderr)
    scene = _scenes()
    results = []

    def record(name, fn):
        try:
            rec = fn()
        except Exception as e:  # keep sweeping; the row records the failure
            traceback.print_exc()
            rec = {"config": name, "error": f"{type(e).__name__}: {e}"[:300]}
        print(json.dumps(rec), flush=True)
        results.append(rec)
        _write(OUT, args.append, results, device_name)

    for name, key, kw, w, h, spp, passes, regen in plan(args.quick, args.kdtree):
        if args.only and args.only not in name:
            continue
        mode = kw.get("mode", "fixed")
        config = TraceConfig(max_depth=7, illum=10.0 if mode == "fixed" else 1.0, rr_depth=5,
                             ray_chunk=0, **kw)
        record(name, lambda: run_config(name, *scene(key, w, h), config, w, h, spp, passes,
                                        regen, device))
    if not args.only or args.only in "bunny_grad_fwdbwd":
        record("bunny_grad_fwdbwd",
               lambda: bunny_grad_row(*scene("bunny", BUNNY_RES, BUNNY_RES), device))
    _write(OUT, args.append, results, device_name)
    failed = [r["config"] for r in results if "error" in r]
    print(f"wrote {OUT} ({len(results)} rows, {len(failed)} failed"
          + (f": {', '.join(failed)})" if failed else ")"), file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
