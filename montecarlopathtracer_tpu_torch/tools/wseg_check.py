"""Whole segment against the split path: the twin of the repository's
``tools/wseg_check.py``.

Renders the headline configuration (Cornell box, fixed depth 7 + the
final gather, megakernel) through the split path (``whole_segment=False``:
B4 and the segment body in torch ops) and through one whole-segment
kernel per segment (B1), holds the films to each other
(:func:`..testing.compare_images`) and times both; then the same for the
value and gradient in ``{mat_kd, mat_ka, vertices}``
(:func:`..testing.compare_param_grads` at 1e-4, the losses within 1e-5).
``chip_smoke.py`` phases 28 and 29 run :func:`forward` and
:func:`gradient`. Run on the card::

    python -m montecarlopathtracer_tpu_torch.tools.wseg_check [--quick] [--skip-grad]
        [--device cpu]

Prints one JSON line and writes it to ``out/wseg_check_torch.json`` under
the working directory (never to the repository's ``WSEG_CHECK.json``);
exits 1 when the two paths disagree.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

OUT = os.path.join("out", "wseg_check_torch.json")
SIZE, QUICK_SIZE = (800, 600), (400, 300)
SPP_PASSES, QUICK_SPP_PASSES = (4, 4), (2, 2)
GRAD_SPP, GRAD_ITERS, QUICK_GRAD_ITERS = 2, 3, 2
FIELDS = ("mat_kd", "mat_ka", "vertices")
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def _config(whole: bool):
    from ..render.integrator import TraceConfig

    return TraceConfig(mode="fixed", max_depth=7, illum=10.0, ray_chunk=0,
                       intersector="megakernel", whole_segment=whole)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def forward(scene, camera, *, width, height, spp, passes, device) -> dict:
    """Split path, then whole segment: each a Renderer with one warm-up
    pass and ``passes`` timed passes of the same keys; the two films
    compared."""
    from ..render.renderer import Renderer, RenderSettings
    from ..testing import compare_images

    settings = RenderSettings(width=width, height=height, spp_per_pass=spp, seed=0)
    out, films = {}, {}
    for name, whole in (("split", False), ("whole_segment", True)):
        r = Renderer(scene, camera, _config(whole), settings, device=device)
        t0 = time.perf_counter()
        r.render(1)
        _sync(device)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        r.render(passes)
        _sync(device)
        dt = time.perf_counter() - t0
        films[name] = r.film.color
        out[name] = {"msamples_s": width * height * spp * passes / dt / 1e6,
                     "seconds_per_pass": dt / passes, "warmup_s": warm,
                     "film_mean": float(r.film.color.mean())}
    rep = compare_images(films["split"], films["whole_segment"])
    out["film"] = rep
    out["ok"] = rep["ok"] and out["split"]["film_mean"] > 0.0
    return out


def gradient(scene, camera, *, width, height, spp, iters, device) -> dict:
    """Value and gradient through the split path, then the whole segment:
    each one warm-up iteration (key 7) and ``iters`` timed ones (keys 8,
    9, ...); the last iteration's losses and gradients compared."""
    from ..diff.grad import make_loss_fn, split_params, value_and_grad
    from ..ops.rng import make_key
    from ..testing import compare_param_grads

    scene, camera = scene.to(device), camera.to(device)
    target = torch.zeros(height, width, 3, device=device)
    params = split_params(scene, FIELDS)
    out, res = {}, {}
    for name, whole in (("grad_split", False), ("grad_whole", True)):
        loss_fn = make_loss_fn(scene, camera, target, width=width, height=height, spp=spp,
                               config=_config(whole))
        t0 = time.perf_counter()
        value_and_grad(loss_fn, params, make_key(7))
        _sync(device)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(iters):
            loss, grads = value_and_grad(loss_fn, params, make_key(8 + i))
        _sync(device)
        dt = time.perf_counter() - t0
        res[name] = (float(loss), grads)
        out[name] = {"msamples_s": width * height * spp * iters / dt / 1e6,
                     "seconds_per_iteration": dt / iters, "warmup_s": warm,
                     "loss": float(loss)}
    (loss, grads), (wloss, wgrads) = res["grad_split"], res["grad_whole"]
    rep = compare_param_grads(wgrads, grads, GRAD_TOL)
    out["grads"] = rep
    out["ok"] = rep["ok"] and abs(loss - wloss) <= LOSS_RTOL * abs(wloss)
    return out


def main(argv=None) -> int:
    from ..models import cornell
    from ..utils.profiling import card

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--skip-grad", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("wseg_check: no CUDA device is available; pass --device cpu")
    w, h = QUICK_SIZE if args.quick else SIZE
    spp, passes = QUICK_SPP_PASSES if args.quick else SPP_PASSES
    if cornell.has_reference_scenes():
        scene, camera = cornell.load_reference_scene(1, width=w, height=h)
    else:
        scene, camera = cornell.cornell_box(with_mirror_sphere=True, with_glass_sphere=True,
                                            width=w, height=h)
    out = {"device": card(device),
           "forward": forward(scene, camera, width=w, height=h, spp=spp, passes=passes,
                              device=device)}
    ok = out["forward"]["ok"]
    if not args.skip_grad:
        out["gradient"] = gradient(scene, camera, width=w, height=h, spp=GRAD_SPP,
                                   iters=QUICK_GRAD_ITERS if args.quick else GRAD_ITERS,
                                   device=device)
        ok = ok and out["gradient"]["ok"]
    out["ok"] = ok
    print(json.dumps(out))
    os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    if not ok:
        print("wseg_check: the split path disagrees with the whole segment", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
