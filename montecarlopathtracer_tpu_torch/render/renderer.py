"""Progressive renderer: the host-side pass loop.

The counterpart of ``montecarlopathtracer_tpu/render/renderer.py``: run
passes of ``spp_per_pass`` full-frame samples, fold each pass into the
film, optionally write per-pass PNGs (``step%06d.png``, plus a live
``preview.png``), and checkpoint the exact restartable state (film +
weight + m2 + seed + pass index) as ``.npz`` with the JAX package's
keys, so a checkpoint from either package resumes in the other.

The key chain is the JAX package's: pass ``p`` renders under
``fold_in(make_key(seed), p)`` and its sample ``i`` under
``fold_in(pass_key, i)``. A regenerating-wavefront pass
(``RenderSettings.regen``) renders its ``spp_per_pass`` samples as one
persistent wavefront under the pass key (:mod:`.regen`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..ops.rng import fold_in, make_key
from ..scene.camera import Camera
from ..scene.scene import ScenePack
from ..utils.image import save_png
from ..utils.logging import RenderLog
from .film import (
    Film,
    film_update,
    film_update_gamma,
    tonemap_gamma,
    tonemap_identity,
    tonemap_linear,
)
from .integrator import TraceConfig, render_rows_planar, scene_tables
from .regen import render_regen_planar


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Run-level configuration."""

    width: int = 800
    height: int = 600
    spp_per_pass: int = 4  # samples folded into the film per pass
    passes: int = 25
    seed: int = 0
    tonemap: str = "linear"  # "linear" (CUDA) or "gamma" (MCRT display)
    accum: str = "linear"  # "linear" (CUDA) or "gamma" (MCRT running mean)
    step_dir: Optional[str] = None  # per-pass PNG dumps when set
    preview: bool = False  # with step_dir: also keep `preview.png`
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0  # passes between checkpoints (0 = off)
    regen: bool = False  # regenerating-wavefront passes (render/regen.py):
    # lanes restart the next sample the step their path ends. Unbiased,
    # but not pass-exact against the scan for spp_per_pass > 1.


class Renderer:
    """Progressive path-tracing loop bound to one scene + camera on
    one device: the card by default (``device="cuda"``, which raises
    without one); ``device="cpu"`` runs the plain-torch path."""

    def __init__(
        self,
        scene: ScenePack,
        camera: Camera,
        config: TraceConfig = TraceConfig(),
        settings: RenderSettings = RenderSettings(),
        log: Optional[RenderLog] = None,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer: no CUDA device is available; pass device='cpu' "
                               "to render with the plain-torch path")
        self.scene = scene.to(self.device)
        self.camera = camera.to(self.device)
        self.config = config
        self.settings = settings
        self.log = log or RenderLog(enabled=False)
        self.tables = scene_tables(self.scene, config)
        self.film = Film.zeros(settings.height, settings.width, self.device)
        self.pass_idx = 0
        if settings.checkpoint_path and os.path.exists(settings.checkpoint_path):
            self.load_checkpoint(settings.checkpoint_path)

    # -- checkpoint / resume --------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp.npz"
        np.savez(
            tmp,
            color=self.film.color.cpu().numpy(),
            weight=self.film.weight.cpu().numpy(),
            m2=self.film.m2.cpu().numpy(),
            seed=np.int64(self.settings.seed),
            pass_idx=np.int64(self.pass_idx),
        )
        os.replace(tmp, path)

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as z:
            if int(z["seed"]) != self.settings.seed:
                raise ValueError(
                    f"checkpoint seed {int(z['seed'])} != settings seed "
                    f"{self.settings.seed}"
                )
            color = torch.as_tensor(z["color"], dtype=torch.float32)
            if tuple(color.shape) != (self.settings.height, self.settings.width, 3):
                raise ValueError(
                    f"checkpoint film {tuple(color.shape)} does not match "
                    f"{self.settings.height}x{self.settings.width}"
                )
            m2 = z["m2"] if "m2" in z else np.zeros((), np.float32)
            self.film = Film(
                color=color.to(self.device),
                weight=torch.as_tensor(z["weight"], dtype=torch.float32).to(self.device),
                m2=torch.as_tensor(m2, dtype=torch.float32).to(self.device),
            )
            self.pass_idx = int(z["pass_idx"])

    # -- rendering ------------------------------------------------------------

    @torch.no_grad()
    def _pass(self, key) -> Film:
        """One pass: the mean of ``spp_per_pass`` full-frame samples,
        folded into the film with weight ``spp_per_pass``."""
        s = self.settings
        if s.regen:
            mean = render_regen_planar(self.scene, self.camera, key, s.width, s.height,
                                       s.spp_per_pass, self.config, self.tables)
        else:
            total = torch.zeros(3, s.height, s.width, device=self.device)
            for i in range(s.spp_per_pass):
                total += render_rows_planar(
                    self.scene, self.camera, fold_in(key, i), s.width, s.height,
                    0, s.height, self.config, self.tables,
                )
            mean = total / s.spp_per_pass
        update = film_update_gamma if s.accum == "gamma" else film_update
        return update(self.film, mean.permute(1, 2, 0), float(s.spp_per_pass))

    def render(self, passes: Optional[int] = None) -> Film:
        """Run progressive passes (resuming from ``self.pass_idx``)."""
        s = self.settings
        n = passes if passes is not None else s.passes
        base_key = make_key(s.seed)
        end = self.pass_idx + n
        while self.pass_idx < end:
            t0 = time.perf_counter()
            self.film = self._pass(fold_in(base_key, self.pass_idx))
            self.pass_idx += 1
            if self.log.enabled:
                m2 = float(self.film.m2)  # waits for the pass to finish
                weight = s.spp_per_pass * self.pass_idx
                self.log.batch(
                    spp=s.spp_per_pass,
                    width=s.width,
                    height=s.height,
                    seconds=time.perf_counter() - t0,
                    pass_idx=self.pass_idx,
                    total_spp=float(weight),
                    noise=round(float(np.sqrt(max(m2, 0.0))) / max(weight, 1e-20), 6),
                )
            if s.step_dir:
                img_u8 = self.image_u8()
                save_png(
                    os.path.join(s.step_dir, f"step{self.pass_idx - 1:06d}.png"),
                    img_u8,
                )
                if s.preview:
                    tmp = os.path.join(s.step_dir, ".preview.tmp.png")
                    save_png(tmp, img_u8)
                    os.replace(tmp, os.path.join(s.step_dir, "preview.png"))
            if (
                s.checkpoint_path
                and s.checkpoint_every
                and self.pass_idx % s.checkpoint_every == 0
            ):
                self.save_checkpoint(s.checkpoint_path)
        if s.checkpoint_path:
            self.save_checkpoint(s.checkpoint_path)
        return self.film

    def image_u8(self) -> np.ndarray:
        if self.settings.accum == "gamma":
            return tonemap_identity(self.film.color)
        if self.settings.tonemap == "gamma":
            return tonemap_gamma(self.film.color)
        return tonemap_linear(self.film.color)

    def save_png(self, path: str) -> None:
        save_png(path, self.image_u8())
