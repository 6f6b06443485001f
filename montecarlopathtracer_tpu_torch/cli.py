"""Command-line renderer for the PyTorch port.

Examples:
    # procedural Cornell box with mirror and glass spheres on the GPU
    python -m montecarlopathtracer_tpu_torch.cli --scene cornell-full \
        --width 800 --height 600 --passes 25 --out result.png

    # the same on the CPU with the plain-torch path (small sizes only)
    python -m montecarlopathtracer_tpu_torch.cli --device cpu \
        --scene cornell-full --width 64 --height 48 --passes 2

    # Russian roulette through the regenerating wavefront
    python -m montecarlopathtracer_tpu_torch.cli --mode rr --illum 1 \
        --spp-per-pass 32 --regen on

    # the 81,932-triangle procedural bunny through the traversal walk
    python -m montecarlopathtracer_tpu_torch.cli --scene bunny \
        --intersector traverse --width 1024 --height 1024 --spp-per-pass 1

    # smallpt's scene as smallpt renders it: 1024x768, Russian roulette
    # (auto: the culled regen pass)
    python -m montecarlopathtracer_tpu_torch.cli --scene smallpt --mode rr \
        --illum 1 --width 1024 --height 768 --spp-per-pass 16

    # the open glossy stage with chunk culling and the wavefront sort
    python -m montecarlopathtracer_tpu_torch.cli --scene glossy --chunk-cull on \
        --ray-sort on

    # the split path (intersector call + segment body), or the fused intersector
    python -m montecarlopathtracer_tpu_torch.cli --whole-segment off
    python -m montecarlopathtracer_tpu_torch.cli --intersector fused

    # the KD-tree walk (the tree built on the host, natively if the C++ library builds)
    python -m montecarlopathtracer_tpu_torch.cli --intersector kdtree

    # a camera of one's own, a live preview page and a profiler trace
    python -m montecarlopathtracer_tpu_torch.cli --eye 0 5 20 --lookat 0 4 0 \
        --fov 50 --step-dir steps --preview --profile-dir prof

``--device`` defaults to ``cuda``; without a GPU the run fails rather
than moving to the CPU. ``--device cpu`` runs the plain-torch version of
every kernel. ``--intersector``, ``--chunk-cull``, ``--ray-sort`` and
``--regen`` default to ``auto``, as in the JAX CLI, resolved by
:func:`resolve_choices` from the triangle count, the mode, the samples
per pass and the explicit flags; its thresholds were set again from the
suite twin's rows on the H100 (``tools/bench_suite.py``), not taken from
the JAX CLI's TPU rules, and they do not depend on the device: the CPU
runs the plain versions of the same kernels. An option that cannot take
effect is refused rather than dropped: ``--ray-chunk`` with ``--regen
on`` (one wavefront), ``--chunk-cull on`` with another intersector than
``megakernel``, and ``--regen on`` with ``brute``, ``fused`` or
``kdtree``. ``--lookat`` without ``--eye`` exits with the JAX CLI's
message. The JAX CLI's ``--ray-tile``, ``--stream-chunk`` and
``--kernel-precision`` tune its TPU kernels and have no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .models import bunny, cornell, glossy, smallpt
from .render.integrator import TraceConfig, kd_tree
from .render.renderer import Renderer, RenderSettings
from .scene.camera import camera_for_scene
from .scene.scene import load_obj_scene
from .scene.camera import Camera
from .utils.logging import RenderLog
from .utils.profiling import trace


# The automatic choices (resolve_choices), set from the suite twin's rows
# (tools/bench_suite.py, 800x600 at 4 spp x 4 passes, the bunny 1024x1024 at
# 1 spp x 4) and chip_smoke.py phase 39 on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit, in Msamples/s unless stated; PERF.md section 6
# (PR 13) has every row.
#
# The traversal walk from TRAVERSE_FROM triangles: it loses at 652
# (scene1_traverse 45.5 against scene1_megakernel 135.7) and at 1,332
# (glossy_traverse 48.0 against glossy_cull 233.8) and wins at 81,932
# (bunny_traverse 55.2 against bunny_cull_sort 18.7 and bunny_megakernel
# 2.5). No row lies between. The culled megakernel's time per sample grows
# as T^0.63 (4.28 ns at 1,332, 57.9 ns at 81,932); the walk's stays near
# flat with the sort (20.8 and 18.1 ns) and is 12.3 ns on the bunny without
# it (phase 39), so the two cross near 7,000 triangles.
TRAVERSE_FROM = 7_000
# Chunk culling of the megakernel from CULL_FROM triangles: it loses at 652
# (scene1_cull 124.1 against 135.7, the closed box, where every chunk is
# reached) and wins at 1,332 (glossy_cull 233.8 against glossy_megakernel
# 136.5) and 81,932 (bunny_cull 17.3 against 2.5). No row lies between.
CULL_FROM = 1_000
# Regen on the megakernel, the JAX CLI's rule: in RR mode at any samples
# per pass, in fixed mode from REGEN_FIXED_FROM samples per pass. Since a
# regen pass is one launch of the pass kernel B1r it wins in every regen row
# (the suite twin's full run, H100 80GB HBM3 at 700.00 W): RR
# scene1_rr_regen (4 spp x 4) 153.5 and scene1_rr_regen_spp32 201.7
# against scene1_rr_megakernel 95.8 (1.60x, 2.11x); fixed
# scene1_regen_spp16 179.2 against scene1_megakernel 143.5 (1.25x) and
# glossy_cull_regen_spp16 578.9 against glossy_cull 252.7 (2.29x). The
# threshold of 16 is the JAX CLI's: no fixed-mode row on the card runs
# fewer than 16 spp per pass, so whether regen wins there is unmeasured
# and the scan stays. Before B1r, regen lost in every row (0.31-0.62x).
# Never on the traversal walk, whose regen is still the host loop, and
# never with a ray chunk (regen is one wavefront).
REGEN_FIXED_FROM = 16


def resolve_ray_chunk(requested) -> int:
    """Rays per wavefront tile: an explicit ``--ray-chunk`` always wins;
    by default the whole frame (0) for every intersector, where the JAX
    CLI tiles its ``brute`` and ``kdtree`` paths by 30,000 rays. The
    kernel intersectors never hold a [rays, triangles] intermediate, and
    the plain ``kdtree`` walk ran its suite row untiled on the card. A
    tile folds its own key (ROADMAP C14), so another default would be
    another estimator for the same seed."""
    return 0 if requested is None else requested


def resolve_choices(num_tris: int, *, mode: str, spp_per_pass: int, intersector="auto",
                    chunk_cull="auto", ray_sort="auto", regen="auto",
                    ray_chunk=None) -> dict:
    """The CLI's ``auto`` choices, from the scene's triangle count, the
    mode, the samples per pass and the explicit flags (``"auto"``,
    ``"on"``/``"off"`` or an intersector name; ``ray_chunk`` None when
    not given). Device-independent. Returns the resolved
    ``intersector``, ``chunk_cull``, ``ray_sort``, ``regen`` and
    ``ray_chunk``.

    - intersector: ``megakernel`` under an explicit ``--chunk-cull on``
      (the only intersector that culls); else ``traverse`` from
      :data:`TRAVERSE_FROM` triangles, ``megakernel`` below.
    - chunk cull: on for the megakernel from :data:`CULL_FROM` triangles.
    - ray sort: on under chunk culling from :data:`TRAVERSE_FROM`
      triangles, off otherwise (the traversal walk included).
    - regen: on for the megakernel in RR mode, or in
      fixed mode from :data:`REGEN_FIXED_FROM` samples per pass; never
      with a ray chunk (the regenerating wavefront is one wavefront) and
      never on the traversal walk.
    """
    if intersector == "auto":
        if chunk_cull == "on" or num_tris < TRAVERSE_FROM:
            intersector = "megakernel"
        else:
            intersector = "traverse"
    ray_chunk = resolve_ray_chunk(ray_chunk)
    if chunk_cull == "auto":
        cull = intersector == "megakernel" and num_tris >= CULL_FROM
    else:
        cull = chunk_cull == "on"
    if ray_sort == "auto":
        # Off on the walk, which gains less from coherent rays than the
        # sort costs (chip_smoke.py phase 39: the bunny's 1024x1024 pass
        # 12.81-12.90 ms unsorted against 19.21-19.48 ms sorted, in
        # turns). Under culling only from TRAVERSE_FROM triangles: it
        # loses on the glossy stage (glossy_cull_sort 34.0 against
        # glossy_cull 233.8) and wins a little on the bunny
        # (bunny_cull_sort 18.7 against bunny_cull 17.3).
        sort = cull and num_tris >= TRAVERSE_FROM
    else:
        sort = ray_sort == "on"
    if regen == "auto":
        on = (intersector == "megakernel" and not ray_chunk
              and (mode == "rr" or spp_per_pass >= REGEN_FIXED_FROM))
    else:
        on = regen == "on"
    return {"intersector": intersector, "chunk_cull": cull, "ray_sort": bool(sort),
            "regen": on, "ray_chunk": ray_chunk}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="montecarlopathtracer_tpu_torch",
        description="Monte Carlo path tracer on PyTorch + CUDA",
    )
    p.add_argument(
        "--scene",
        default="cornell-full",
        help="'cornell' = procedural box, 'cornell-full' = procedural box "
        "with mirror + glass spheres, 'glossy' = procedural open stage of "
        "glossy cubes and sphere lamps (1,332 triangles), 'bunny' = "
        "procedural displaced blob of 20*4^subdiv triangles in a room, 'smallpt' = "
        "smallpt's box, mirror and glass spheres and light (2,696 triangles, its "
        "camera; render it with --mode rr --illum 1, as smallpt), 1/2/3 = "
        "reference scene (read-only mount), 'mcrt' = the MCRT backend's scene01 "
        "variant (per-triangle materials, pi/4 camera; read-only mount), or a "
        "path to an .obj file",
    )
    p.add_argument("--subdiv", type=int, default=6,
                   help="icosphere subdivisions of --scene bunny (6: 81,932 triangles)")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp-per-pass", type=int, default=4)
    p.add_argument("--passes", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", choices=["fixed", "rr"], default="fixed")
    p.add_argument("--max-depth", type=int, default=7)
    p.add_argument("--rr-depth", type=int, default=5)
    p.add_argument("--illum", type=float, default=10.0)
    p.add_argument("--eye", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"),
                   help="camera position (overrides the scene's hardcoded camera)")
    p.add_argument("--lookat", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"),
                   help="camera look-at point (requires --eye)")
    p.add_argument("--up", type=float, nargs=3, default=(0.0, 1.0, 0.0),
                   metavar=("X", "Y", "Z"), help="camera up vector (with --eye/--lookat)")
    p.add_argument("--fov", type=float, default=60.0,
                   help="horizontal FOV in degrees (with --eye)")
    p.add_argument("--intersector",
                   choices=["auto", "megakernel", "traverse", "fused", "brute", "kdtree"],
                   default="auto",
                   help=f"'auto' = 'traverse' from {TRAVERSE_FROM:,} triangles, 'megakernel' "
                   "below (resolve_choices); 'megakernel' = brute nearest hit in the "
                   "segment kernel; 'traverse' = per-ray tree walk, for large scenes; "
                   "'fused' = nearest-index kernel + differentiable recompute; 'brute' = "
                   "plain torch; 'kdtree' = KD-tree walk in torch ops, the tree built on "
                   "the host (the last three on the split path; 'auto' picks none of them)")
    p.add_argument("--whole-segment", choices=["on", "off"], default="on",
                   help="'on' = one kernel per path segment (megakernel, traverse); "
                   "'off' = the split path: intersector kernel + segment body in "
                   "torch ops")
    p.add_argument("--chunk-cull", choices=["auto", "on", "off"], default="auto",
                   help="megakernel: Morton-order the triangles and skip the "
                   f"chunks no ray of a block can reach (open scenes). 'auto' = on for "
                   f"the megakernel from {CULL_FROM:,} triangles (resolve_choices)")
    p.add_argument("--ray-sort", choices=["auto", "on", "off"], default="auto",
                   help="sort the wavefront each segment (megakernel, traverse). 'auto' "
                   f"= on with chunk culling from {TRAVERSE_FROM:,} triangles, off "
                   "otherwise (on an H100 the sorted walk took 1.5x as long on the bunny)")
    p.add_argument("--regen", choices=["auto", "on", "off"], default="auto",
                   help="regenerating wavefront: a lane whose path ends starts "
                   "its pixel's next sample. 'auto' = on for the megakernel in RR mode, "
                   f"and in fixed mode from {REGEN_FIXED_FROM} spp/pass, never with "
                   "--ray-chunk: on an H100 its pass kernel ran at 1.25-2.29x the scan's "
                   "Msamples/s in every suite row (RR at 4 and 32 spp/pass, fixed at 16)")
    p.add_argument("--ray-chunk", type=int, default=None,
                   help="rays per wavefront tile (default: 0 = the whole frame, for "
                   "every intersector)")
    p.add_argument("--phong-model", choices=["blinn", "phong"], default="blinn",
                   help="specular sampler: 'blinn' = half-vector, 'phong' = "
                   "classic reflection lobe")
    p.add_argument("--tonemap", choices=["linear", "gamma"], default="linear")
    p.add_argument("--accum", choices=["linear", "gamma"], default="linear",
                   help="film accumulation space: 'linear' (CUDA estimator) "
                   "or 'gamma' (MCRT's gamma-space running mean)")
    p.add_argument("--out", default="result.png")
    p.add_argument("--step-dir", default=None, help="per-pass PNG dump dir")
    p.add_argument("--preview", action="store_true",
                   help="with --step-dir: keep an atomically replaced preview.png and "
                   "a self-refreshing index.html beside it for a live view")
    p.add_argument("--checkpoint", default=None, help="film checkpoint path")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the render here "
                   "(trace.json)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain-torch path")
    return p


def load_scene(name: str, width: int, height: int, subdiv: int = 6):
    if name == "bunny":
        return bunny.bunny_scene(subdiv=subdiv, width=width, height=height)
    if name in ("1", "2", "3"):
        return cornell.load_reference_scene(int(name), width=width, height=height)
    if name == "mcrt":
        return cornell.load_mcrt_scene(width=width, height=height)
    if name == "cornell":
        return cornell.cornell_box(width=width, height=height)
    if name == "glossy":
        return glossy.glossy_steps(width=width, height=height)
    if name == "smallpt":
        return smallpt.smallpt_scene(width=width, height=height)
    if name == "cornell-full":
        return cornell.cornell_box(
            with_mirror_sphere=True, with_glass_sphere=True,
            width=width, height=height,
        )
    return load_obj_scene(name), camera_for_scene(1, width, height)


def look_camera(args, camera: Camera) -> Camera:
    """The camera of ``--eye`` (looking at ``--lookat``, or down -z
    without it), ``--up`` and ``--fov``, with the scene camera's jitter;
    the scene's own camera without ``--eye``. ``--lookat`` without
    ``--eye`` exits, as in the JAX CLI."""
    if args.eye is None:
        if args.lookat is not None:
            raise SystemExit("--lookat requires --eye")
        return camera
    eye = [float(x) for x in args.eye]
    lookat = args.lookat if args.lookat is not None else (eye[0], eye[1], eye[2] - 1.0)
    forward = [float(a) - b for a, b in zip(lookat, eye)]
    return Camera.look(eye, forward, args.up, width=args.width, height=args.height,
                       fov_x_deg=args.fov, jitter=camera.jitter)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device} but no CUDA device is available "
              "(pass --device cpu for the plain-torch path)", file=sys.stderr)
        return 2
    scene, camera = load_scene(args.scene, args.width, args.height, args.subdiv)
    camera = look_camera(args, camera)
    choice = resolve_choices(
        scene.num_triangles, mode=args.mode, spp_per_pass=args.spp_per_pass,
        intersector=args.intersector, chunk_cull=args.chunk_cull, ray_sort=args.ray_sort,
        regen=args.regen, ray_chunk=args.ray_chunk)
    intersector, regen, ray_chunk = choice["intersector"], choice["regen"], choice["ray_chunk"]
    if regen and ray_chunk:
        print(f"error: --regen on renders the frame as one wavefront; it cannot "
              f"honour --ray-chunk {ray_chunk} (drop one of the two)", file=sys.stderr)
        return 2
    if choice["chunk_cull"] and intersector != "megakernel":
        print(f"error: --chunk-cull on applies to --intersector megakernel only, not "
              f"{intersector!r}", file=sys.stderr)
        return 2
    if regen and intersector in ("fused", "brute", "kdtree"):
        print(f"error: --regen on needs --intersector megakernel or traverse, not "
              f"{intersector!r}", file=sys.stderr)
        return 2
    if not args.quiet:
        print(json.dumps({"choices": choice, "triangles": scene.num_triangles}),
              file=sys.stderr)
    accel = None
    if intersector == "kdtree":
        accel = kd_tree(scene.to(device))
    config = TraceConfig(
        mode=args.mode,
        max_depth=args.max_depth,
        rr_depth=args.rr_depth,
        illum=args.illum,
        phong_model=args.phong_model,
        intersector=intersector,
        whole_segment=args.whole_segment == "on",
        ray_sort=choice["ray_sort"],
        chunk_cull=choice["chunk_cull"],
        ray_chunk=ray_chunk,
    )
    settings = RenderSettings(
        width=args.width,
        height=args.height,
        spp_per_pass=args.spp_per_pass,
        passes=args.passes,
        seed=args.seed,
        tonemap=args.tonemap,
        accum=args.accum,
        step_dir=args.step_dir,
        preview=args.preview,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        regen=regen,
    )
    log = RenderLog(enabled=not args.quiet)
    r = Renderer(scene, camera, config, settings, log=log, device=device, accel=accel)
    with trace(args.profile_dir):
        r.render()
    r.save_png(args.out)
    if not args.quiet:
        print(f"wrote {args.out} ({args.width}x{args.height}, "
              f"{float(r.film.weight):.0f} spp)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
