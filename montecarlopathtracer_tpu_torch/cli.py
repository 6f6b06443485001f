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

    # the open glossy stage with chunk culling and the wavefront sort
    python -m montecarlopathtracer_tpu_torch.cli --scene glossy --chunk-cull on \
        --ray-sort on

    # the split path (intersector call + segment body), or the fused intersector
    python -m montecarlopathtracer_tpu_torch.cli --whole-segment off
    python -m montecarlopathtracer_tpu_torch.cli --intersector fused

    # the KD-tree walk (the tree built on the host, natively if the C++ library builds)
    python -m montecarlopathtracer_tpu_torch.cli --intersector kdtree

``--device`` defaults to ``cuda``; without a GPU the run fails rather
than moving to the CPU. ``--device cpu`` runs the plain-torch version of
every kernel. Every option is explicit: the JAX CLI's automatic choices
of intersector, chunk culling and regen were measured on a TPU and are
not carried over. An option that cannot take effect is refused rather
than dropped: ``--ray-chunk`` with ``--regen on`` (one wavefront),
``--chunk-cull on`` with another intersector than ``megakernel``, and
``--regen on`` with ``brute``, ``fused`` or ``kdtree``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .models import bunny, cornell, glossy
from .render.integrator import TraceConfig, kd_tree
from .render.renderer import Renderer, RenderSettings
from .scene.camera import camera_for_scene
from .scene.scene import load_obj_scene
from .utils.logging import RenderLog


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
        "procedural displaced blob of 20*4^subdiv triangles in a room, 1/2 = "
        "reference scene (read-only mount), or a path to an .obj file",
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
    p.add_argument("--intersector",
                   choices=["megakernel", "traverse", "fused", "brute", "kdtree"],
                   default="megakernel",
                   help="'megakernel' = brute nearest hit in the segment kernel; "
                   "'traverse' = Morton-chunk walk, for large scenes; 'fused' = "
                   "nearest-index kernel + differentiable recompute; 'brute' = "
                   "plain torch; 'kdtree' = KD-tree walk in torch ops, the tree "
                   "built on the host (the last three on the split path)")
    p.add_argument("--whole-segment", choices=["on", "off"], default="on",
                   help="'on' = one kernel per path segment (megakernel, traverse); "
                   "'off' = the split path: intersector kernel + segment body in "
                   "torch ops")
    p.add_argument("--chunk-cull", choices=["on", "off"], default="off",
                   help="megakernel: Morton-order the triangles and skip the "
                   "128-triangle chunks no ray of a block can reach (open scenes)")
    p.add_argument("--ray-sort", choices=["on", "off"], default=None,
                   help="sort the wavefront each segment (default: on for "
                   "--intersector traverse, off otherwise)")
    p.add_argument("--regen", choices=["on", "off"], default="off",
                   help="regenerating wavefront: a lane whose path ends starts "
                   "its pixel's next sample")
    p.add_argument("--ray-chunk", type=int, default=0,
                   help="rays per wavefront tile (0 = the whole frame)")
    p.add_argument("--phong-model", choices=["blinn", "phong"], default="blinn",
                   help="specular sampler: 'blinn' = half-vector, 'phong' = "
                   "classic reflection lobe")
    p.add_argument("--tonemap", choices=["linear", "gamma"], default="linear")
    p.add_argument("--accum", choices=["linear", "gamma"], default="linear",
                   help="film accumulation space: 'linear' (CUDA estimator) "
                   "or 'gamma' (MCRT's gamma-space running mean)")
    p.add_argument("--out", default="result.png")
    p.add_argument("--step-dir", default=None, help="per-pass PNG dump dir")
    p.add_argument("--checkpoint", default=None, help="film checkpoint path")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain-torch path")
    return p


def load_scene(name: str, width: int, height: int, subdiv: int = 6):
    if name == "bunny":
        return bunny.bunny_scene(subdiv=subdiv, width=width, height=height)
    if name in ("1", "2"):
        return cornell.load_reference_scene(int(name), width=width, height=height)
    if name == "cornell":
        return cornell.cornell_box(width=width, height=height)
    if name == "glossy":
        return glossy.glossy_steps(width=width, height=height)
    if name == "cornell-full":
        return cornell.cornell_box(
            with_mirror_sphere=True, with_glass_sphere=True,
            width=width, height=height,
        )
    return load_obj_scene(name), camera_for_scene(1, width, height)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device} but no CUDA device is available "
              "(pass --device cpu for the plain-torch path)", file=sys.stderr)
        return 2
    regen = args.regen == "on"
    if regen and args.ray_chunk:
        print(f"error: --regen on renders the frame as one wavefront; it cannot "
              f"honour --ray-chunk {args.ray_chunk} (drop one of the two)",
              file=sys.stderr)
        return 2
    if args.chunk_cull == "on" and args.intersector != "megakernel":
        print(f"error: --chunk-cull on applies to --intersector megakernel only, not "
              f"{args.intersector!r}", file=sys.stderr)
        return 2
    if regen and args.intersector in ("fused", "brute", "kdtree"):
        print(f"error: --regen on needs --intersector megakernel or traverse, not "
              f"{args.intersector!r}", file=sys.stderr)
        return 2
    scene, camera = load_scene(args.scene, args.width, args.height, args.subdiv)
    accel = None
    if args.intersector == "kdtree":
        accel = kd_tree(scene.to(device))
    ray_sort = args.ray_sort == "on" if args.ray_sort else args.intersector == "traverse"
    config = TraceConfig(
        mode=args.mode,
        max_depth=args.max_depth,
        rr_depth=args.rr_depth,
        illum=args.illum,
        phong_model=args.phong_model,
        intersector=args.intersector,
        whole_segment=args.whole_segment == "on",
        ray_sort=ray_sort,
        chunk_cull=args.chunk_cull == "on",
        ray_chunk=args.ray_chunk,
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
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        regen=regen,
    )
    log = RenderLog(enabled=not args.quiet)
    r = Renderer(scene, camera, config, settings, log=log, device=device, accel=accel)
    r.render()
    r.save_png(args.out)
    if not args.quiet:
        print(f"wrote {args.out} ({args.width}x{args.height}, "
              f"{float(r.film.weight):.0f} spp)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
