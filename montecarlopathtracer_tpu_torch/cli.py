"""Command-line renderer for the PyTorch port.

Examples:
    # procedural Cornell box with mirror and glass spheres on the GPU
    python -m montecarlopathtracer_tpu_torch.cli --scene cornell-full \
        --width 800 --height 600 --passes 25 --out result.png

    # the same on the CPU with the plain-torch path (small sizes only)
    python -m montecarlopathtracer_tpu_torch.cli --device cpu \
        --scene cornell-full --width 64 --height 48 --passes 2

``--device`` defaults to ``cuda``; without a GPU the run fails rather
than moving to the CPU. ``--device cpu`` runs the plain-torch version of
every kernel.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .models import cornell
from .render.integrator import TraceConfig
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
        "with mirror + glass spheres, 1/2 = reference scene (read-only "
        "mount), or a path to an .obj file",
    )
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp-per-pass", type=int, default=4)
    p.add_argument("--passes", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", choices=["fixed", "rr"], default="fixed")
    p.add_argument("--max-depth", type=int, default=7)
    p.add_argument("--rr-depth", type=int, default=5)
    p.add_argument("--illum", type=float, default=10.0)
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


def load_scene(name: str, width: int, height: int):
    if name in ("1", "2"):
        return cornell.load_reference_scene(int(name), width=width, height=height)
    if name == "cornell":
        return cornell.cornell_box(width=width, height=height)
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
    scene, camera = load_scene(args.scene, args.width, args.height)
    config = TraceConfig(
        mode=args.mode,
        max_depth=args.max_depth,
        rr_depth=args.rr_depth,
        illum=args.illum,
        phong_model=args.phong_model,
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
    )
    log = RenderLog(enabled=not args.quiet)
    r = Renderer(scene, camera, config, settings, log=log, device=device)
    r.render()
    r.save_png(args.out)
    if not args.quiet:
        print(f"wrote {args.out} ({args.width}x{args.height}, "
              f"{float(r.film.weight):.0f} spp)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
