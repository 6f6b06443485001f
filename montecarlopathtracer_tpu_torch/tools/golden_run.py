"""Golden-image parity runner of the port: the twin of the repository's
``tools/golden_run.py``.

Renders the reference's committed workloads with the port and compares
them with its committed PNGs (the reference's only regression baseline):

- scene1, scene2: the reference scenes at 800×600, fixed depth 7, 1000
  spp, linear accumulation and output, against ``result1.png`` and
  ``result2.png``;
- steps: the progressive sequences (10 passes of 100 spp) against
  ``result1step/`` and ``result2step/``, frame by frame, with the
  reference's own floor between ``result{n}.png`` and its last step;
- mcrt: the MCRT scene variant at 640×480, RR(5), no emitter scale,
  gamma-space accumulation, against the MCRT ``result.png``;
- scene3: the mirror box in its Blinn-Phong and Phong variants against
  ``result3.png`` and ``result4.png``.

Every image is linear in the emitter scale, so the float film is
rendered once at illum 10 and the scale s that minimises the MAE
against the golden is fitted (:func:`_fit_scale`); both the nominal and
the fitted comparison are recorded.

The reference checkout is read from :func:`..models.cornell.reference_root`
(``MCPT_REFERENCE_ROOT``, else ``reference`` beside the checkout). Where
it is absent the runner exits 2 and says so. It writes its PNGs and
``GOLDEN.json`` into ``out/goldens_torch/`` under the working directory,
never into the repository's ``goldens/``. Run on the card::

    python -m montecarlopathtracer_tpu_torch.tools.golden_run [--only SUBSTR]
        [--device cpu]

On the CPU (``--device cpu``) every sample count is cut 64-fold, as the
original does off the TPU: a smoke run, not a comparison.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

OUT = os.path.join("out", "goldens_torch")
CVMC = os.path.join("CVMCTracer", "CVMCTracer")


def _fit_scale(ours_lin: np.ndarray, golden_u8: np.ndarray) -> float:
    """Scale s minimising MAE(clip(s·ours·255), golden), by golden-section
    search on a bracket (the objective is piecewise smooth)."""
    g = golden_u8.astype(np.float64) / 255.0
    o = ours_lin.astype(np.float64)

    def mae(s):
        return np.abs(np.clip(o * s, 0, 1.0) - g).mean()

    lo, hi = 0.25, 8.0
    for _ in range(60):
        m1 = lo + (hi - lo) * 0.382
        m2 = lo + (hi - lo) * 0.618
        if mae(m1) < mae(m2):
            hi = m2
        else:
            lo = m1
    return float((lo + hi) / 2)


def _fitted_u8(film: np.ndarray, s: float) -> np.ndarray:
    return np.clip(film * s * 255.0, 0, 255).astype(np.uint8)


def render_film(scene, cam, config, settings, device):
    from ..render.renderer import Renderer
    from ..utils.logging import RenderLog

    r = Renderer(scene, cam, config, settings, log=RenderLog(stream=sys.stderr), device=device)
    t0 = time.perf_counter()
    r.render()
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
    dt = time.perf_counter() - t0
    spp = settings.spp_per_pass * settings.passes
    print(f"  rendered {settings.width}x{settings.height} @ {spp} spp in {dt:.1f}s "
          f"({settings.width * settings.height * spp / dt / 1e6:.2f} Ms/s)", file=sys.stderr)
    return r


def _run_scenes(report, ref, spp_scale, device, want):
    from ..models import cornell
    from ..render.film import tonemap_linear
    from ..render.integrator import TraceConfig
    from ..render.renderer import RenderSettings
    from ..utils.golden import compare_images
    from ..utils.image import load_png, save_png

    for n, golden_name in ((1, "result1.png"), (2, "result2.png")):
        if not want(f"scene{n}"):
            continue
        golden_path = os.path.join(ref, CVMC, golden_name)
        golden = load_png(golden_path)
        scene, cam = cornell.load_reference_scene(n, width=800, height=600)
        config = TraceConfig(mode="fixed", max_depth=7, illum=10.0, ray_chunk=0)
        settings = RenderSettings(width=800, height=600,
                                  spp_per_pass=max(1000 // (100 * spp_scale), 1), passes=100,
                                  seed=0)
        print(f"scene{n}: rendering vs {golden_name}", file=sys.stderr)
        film = render_film(scene, cam, config, settings, device).film.color.cpu().numpy()
        ours_u8 = tonemap_linear(torch.from_numpy(film))
        save_png(os.path.join(OUT, f"scene0{n}_ours.png"), ours_u8)
        s = _fit_scale(film, golden)
        fitted_u8 = _fitted_u8(film, s)
        save_png(os.path.join(OUT, f"scene0{n}_ours_fitted.png"), fitted_u8)
        report[f"scene{n}"] = {
            "golden": golden_path,
            "spp": int(settings.spp_per_pass * settings.passes),
            "nominal_illum10": compare_images(ours_u8, golden),
            "fitted_scale": round(s, 4),
            "effective_illum": round(10.0 * s, 2),
            "fitted": compare_images(fitted_u8, golden),
        }
        print(f"scene{n}: {json.dumps(report[f'scene{n}'], indent=1)}", file=sys.stderr)


def _run_steps(report, ref, spp_scale, device):
    """The progressive sequences: step k of the reference is the running
    mean after (k+1)·100 spp (step 9 is ``result{n}.png``). One emitter
    scale, fitted on the last step, serves every step; a sequence
    matches when it converges to the reference's own floor between
    ``result{n}.png`` and its last step (a different run for scene 2)."""
    from ..models import cornell
    from ..render.integrator import TraceConfig
    from ..render.renderer import Renderer, RenderSettings
    from ..utils.golden import compare_images
    from ..utils.image import load_png, save_png

    for n in (1, 2):
        step_dir = os.path.join(ref, CVMC, f"result{n}step")
        goldens = [load_png(os.path.join(step_dir, f"step{k:06d}.png")) for k in range(10)]
        scene, cam = cornell.load_reference_scene(n, width=800, height=600)
        config = TraceConfig(mode="fixed", max_depth=7, illum=10.0, ray_chunk=0)
        spp_pass = max(100 // spp_scale, 1)
        settings = RenderSettings(width=800, height=600, spp_per_pass=spp_pass, passes=10,
                                  seed=0)
        print(f"steps{n}: 10×{spp_pass} spp vs {step_dir}", file=sys.stderr)
        r = Renderer(scene, cam, config, settings, device=device)
        films = []
        for _ in range(10):
            r.render(1)
            films.append(r.film.color.cpu().numpy())
        s = _fit_scale(films[-1], goldens[-1])
        curve = []
        for k, (film, golden) in enumerate(zip(films, goldens)):
            fitted_u8 = _fitted_u8(film, s)
            curve.append(compare_images(fitted_u8, golden))
            if k in (0, 9):
                save_png(os.path.join(OUT, f"scene0{n}_step{k}_ours.png"), fitted_u8)
        maes = [c["mae_down8"] for c in curve]
        psnrs = [c["psnr_db"] for c in curve]
        final = load_png(os.path.join(ref, CVMC, f"result{n}.png"))
        floor = compare_images(final, goldens[-1])["mae_down8"]
        report[f"steps{n}"] = {
            "golden_dir": step_dir,
            "spp_per_step": spp_pass,
            "fitted_scale": round(s, 4),
            "down8_mae_per_step": [round(m, 4) for m in maes],
            "psnr_per_step": [round(p, 2) for p in psnrs],
            "inter_golden_floor_mae_down8": round(floor, 4),
            "converging": bool(psnrs[-1] >= psnrs[0]
                               and maes[-1] <= max(maes[0], floor * 1.05)),
        }
        print(f"steps{n}: {json.dumps(report[f'steps{n}'], indent=1)}", file=sys.stderr)


def _run_mcrt(report, ref, spp_scale, device):
    from ..models import cornell
    from ..render.film import tonemap_identity
    from ..render.integrator import TraceConfig
    from ..render.renderer import RenderSettings
    from ..utils.golden import compare_images
    from ..utils.image import load_png, save_png

    golden_path = os.path.join(ref, "MCRT", "QuinEngine", "result.png")
    golden = load_png(golden_path)
    scene, cam = cornell.load_mcrt_scene(width=640, height=480)
    config = TraceConfig(mode="rr", rr_depth=5, illum=1.0, refract_kd=False, ray_chunk=0)
    # MCRT's estimator: a gamma-space running mean of 1-spp frames.
    settings = RenderSettings(width=640, height=480, spp_per_pass=1,
                              passes=max(1024 // spp_scale, 4), seed=0, accum="gamma",
                              tonemap="gamma")
    print("mcrt: rendering vs result.png", file=sys.stderr)
    film_enc = render_film(scene, cam, config, settings, device).film.color.cpu().numpy()
    ours_u8 = tonemap_identity(torch.from_numpy(film_enc))
    save_png(os.path.join(OUT, "mcrt_ours.png"), ours_u8)
    # A gamma-encoded film: a radiance scale s shows as s^(1/2.2).
    s = _fit_scale(film_enc, golden)
    fitted_u8 = _fitted_u8(film_enc, s)
    save_png(os.path.join(OUT, "mcrt_ours_fitted.png"), fitted_u8)
    report["mcrt"] = {
        "golden": golden_path,
        "spp": int(settings.passes),
        "nominal": compare_images(ours_u8, golden),
        "fitted_display_scale": round(s, 4),
        "fitted": compare_images(fitted_u8, golden),
    }
    print(f"mcrt: {json.dumps(report['mcrt'], indent=1)}", file=sys.stderr)


def _run_scene3(report, ref, spp_scale, device, only=""):
    """Scene 3, the mirror box (back wall and floor Ns = 1000 mirrors),
    against the reference's Figures 3 and 4 (Blinn-Phong and Phong)."""
    from ..models import cornell
    from ..render.film import tonemap_linear
    from ..render.integrator import TraceConfig
    from ..render.renderer import RenderSettings
    from ..utils.golden import compare_images
    from ..utils.image import load_png, save_png

    for variant in ("blinn", "phong"):
        if only and only.startswith("scene3_") and only != f"scene3_{variant}":
            continue
        scene, cam = cornell.load_reference_scene(3, width=800, height=600)
        config = TraceConfig(mode="fixed", max_depth=7, illum=10.0, ray_chunk=0,
                             phong_model=variant)
        settings = RenderSettings(width=800, height=600,
                                  spp_per_pass=max(2048 // (128 * spp_scale), 1), passes=128,
                                  seed=0)
        print(f"scene3[{variant}]: rendering", file=sys.stderr)
        film = render_film(scene, cam, config, settings, device).film.color.cpu().numpy()
        ours_u8 = tonemap_linear(torch.from_numpy(film))
        save_png(os.path.join(OUT, f"scene03_{variant}_ours.png"), ours_u8)
        entry = {"spp": int(settings.spp_per_pass * settings.passes), "phong_model": variant}
        for gn in ("result3.png", "result4.png"):
            golden = load_png(os.path.join(ref, CVMC, gn))
            s = _fit_scale(film, golden)
            entry[gn] = {
                "nominal": compare_images(ours_u8, golden),
                "fitted_scale": round(s, 4),
                "fitted": compare_images(_fitted_u8(film, s), golden),
            }
        report[f"scene3_{variant}"] = entry
        print(f"scene3[{variant}]: {json.dumps(entry, indent=1)}", file=sys.stderr)


def main(argv=None) -> int:
    from ..models import cornell
    from ..utils.profiling import card

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", help="substring filter: run only matching "
                    "sections (scene1/scene2/steps/mcrt/scene3) and merge into the "
                    "existing GOLDEN.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    ref = cornell.reference_root()
    if not os.path.isdir(os.path.join(ref, CVMC)):
        print(f"golden_run: the reference checkout is not at {ref} (no {CVMC}); mount it "
              "there or set MCPT_REFERENCE_ROOT", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("golden_run: no CUDA device is available; pass --device cpu")

    def want(name):
        return not args.only or args.only in name

    os.makedirs(OUT, exist_ok=True)
    spp_scale = 1 if device.type == "cuda" else 64
    report = {"device": card(device)}
    print(f"device: {report['device']}", file=sys.stderr)
    _run_scenes(report, ref, spp_scale, device, want)
    if want("steps"):
        _run_steps(report, ref, spp_scale, device)
    if want("mcrt"):
        _run_mcrt(report, ref, spp_scale, device)
    if want("scene3") or want("scene3_blinn") or want("scene3_phong"):
        _run_scene3(report, ref, spp_scale, device, args.only)
    out_path = os.path.join(OUT, "GOLDEN.json")
    if args.only and os.path.exists(out_path):
        with open(out_path) as f:
            merged = json.load(f)
        merged.update(report)
        report = merged
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
