"""A single-device forward step and a multi-rank dry run: the twins of
the repository's ``__graft_entry__.py``.

- :func:`entry` gives ``(fn, args)`` for one forward sample pass of the
  flagship scene (the Cornell box with mirror and glass spheres, full
  BSDF set) at 128×128, fixed depth 7: ``fn(*args)`` renders
  f32[128, 128, 3].
- :func:`dryrun_multichip` runs the JAX dry run's three configurations at
  tiny shapes on ``n`` ranks (:func:`.parallel.launch.run_ranks`), each
  on a (rays × spp) mesh (two spp shards from four even ranks up): 1, the
  brute intersector (a progressive pass, a material step and a geometry
  step); 2, the megakernel whole segment (a progressive pass and a
  material step through the segment vjp and the row scatter); 3, the
  regenerating wavefront. It prints ``dryrun config k ok: ...`` for each.

Both run on the card unless ``device="cpu"`` is asked for. Started by
``torchrun``, each process is one rank of the dry run (the entry runs on
every rank, rank 0 prints); otherwise the dry run spawns ``--ranks``
local ranks::

    python -m montecarlopathtracer_tpu_torch.graft_entry [--device cpu] [--ranks N]
    torchrun --nproc-per-node 4 -m montecarlopathtracer_tpu_torch.graft_entry --device cpu
"""

from __future__ import annotations

import argparse
import functools
import os

import torch


def entry(device="cuda"):
    """``(fn, args)``: one forward sample pass, ``fn(*args)`` →
    f32[128, 128, 3] on ``device``."""
    from .models import cornell
    from .ops.rng import make_key
    from .render.integrator import TraceConfig, render_sample_batch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device is available; pass device='cpu'")
    width = height = 128
    scene, camera = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                        width=width, height=height, device=device)
    config = TraceConfig(mode="fixed", max_depth=7)
    fn = functools.partial(render_sample_batch, width=width, height=height, config=config)
    return fn, (scene, camera, make_key(0))


def _finite(what, *xs):
    if not all(bool(torch.isfinite(x).all()) for x in xs):
        raise RuntimeError(f"dryrun: {what} is not finite")


def _dryrun_rank(n_rays: int, n_spp: int, device: str) -> list:
    """One rank of :func:`dryrun_multichip`; returns its three lines."""
    from .diff.boundary import lamp_mask
    from .diff.grad import split_params
    from .models import cornell
    from .ops.rng import make_key
    from .parallel import sharded as SH
    from .parallel.mesh import make_mesh
    from .render.film import Film
    from .render.integrator import TraceConfig

    mesh = make_mesh(n_rays, n_spp, device=device)
    height, width, spp = 8 * n_rays, 16, 2 * n_spp
    scene, camera = cornell.cornell_box(width=width, height=height, device=mesh.device)
    rows = SH.film_band(mesh, height)[1]
    # The JAX dry run's keys: config 1 passes 0, trains 1, steps θ under 2;
    # config 2 passes 3, trains 4; config 3 renders under 5.
    for k, pass_key, config in (
            (1, 0, TraceConfig(mode="fixed", max_depth=2, intersector="brute")),
            (2, 3, TraceConfig(mode="fixed", max_depth=2))):
        kw = dict(width=width, height=height, spp=spp, config=config)
        step = SH.make_progressive_step(mesh, **kw)
        film = step(scene, camera, Film.zeros(rows, width, mesh.device), make_key(pass_key))
        _finite(f"config {k} film", film.color)
        target = SH.gather_film(mesh, film.color)
        train = SH.make_train_step(mesh, scene, camera, **kw)
        params, loss = train(split_params(scene, ("mat_kd", "mat_ka")), target,
                             make_key(pass_key + 1))
        _finite(f"config {k} train step", loss, *params.values())
        if k == 1:
            geom = SH.make_geom_train_step(mesh, scene, camera, lamp_mask(scene),
                                           n_edge_samples=64 * mesh.size, lr=1.0, **kw)
            theta, gloss = geom(torch.zeros(3), target, make_key(2))
            _finite("config 1 geometry step", theta, gloss)
    rimg = SH.sharded_regen_pass(mesh, width=width, height=height, spp=spp,
                                 config=TraceConfig(mode="fixed", max_depth=2))(
        scene, camera, make_key(5))
    _finite("config 3 regen pass", rimg)
    return ["dryrun config 1 ok: intersector=brute (fwd + material train + sharded geometry "
            "steps)",
            "dryrun config 2 ok: intersector=megakernel whole-segment (B1 fwd + B2/B3 bwd, "
            "gradients all-reduced over the ranks)",
            "dryrun config 3 ok: regenerating wavefront (per-rank quota drain)"]


def _mesh_shape(n: int):
    """The JAX dry run's mesh: two spp shards from four even ranks up."""
    return (n // 2, 2) if n >= 4 and n % 2 == 0 else (n, 1)


def dryrun_multichip(n_devices: int, *, device="cuda", timeout: float = 600.0) -> None:
    """One sharded forward pass, material step, geometry step and regen
    pass on ``n_devices`` ranks at tiny shapes; prints a line per
    configuration."""
    from .parallel.launch import run_ranks

    lines = run_ranks(_dryrun_rank, n_devices, (*_mesh_shape(n_devices), str(device)),
                      device=device, timeout=timeout)[0]
    for line in lines:
        print(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: the cards, or 4 on the CPU)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry ok:", tuple(out.shape), out.dtype)
    if "WORLD_SIZE" in os.environ:  # started by torchrun: this process is one rank
        lines = _dryrun_rank(*_mesh_shape(int(os.environ["WORLD_SIZE"])), args.device)
        if int(os.environ["RANK"]) == 0:
            print("\n".join(lines) + "\ndryrun ok")
        return 0
    ranks = args.ranks or (torch.cuda.device_count() if args.device == "cuda" else 4)
    dryrun_multichip(ranks, device=args.device)
    print("dryrun ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
