"""Pinhole camera: basis construction and batched ray generation.

The counterpart of ``montecarlopathtracer_tpu/scene/camera.py``: the
reference's two camera conventions behind one dataclass.

- CUDA backend: 60° horizontal FOV pinhole with aspect folded in as
  ``(H/W)``, ±1 px jitter, basis built from eye/forward/up.
- HLSL backend: vertical FOV π/4 with ±0.5 px jitter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


@dataclasses.dataclass
class Camera:
    """Camera with orthonormal basis and per-axis tangent half-FOVs.

    The camera ray through pixel (x, y) with jitter (jx, jy) is::

        d_cam = ((2 (x+jx) / W - 1) * tan_half_x,
                 (1 - 2 (y+jy) / H) * tan_half_y,
                 -1)
        d_world = normalize(right * d_cam.x + up * d_cam.y + forward)
    """

    eye: torch.Tensor  # f32[3]
    forward: torch.Tensor  # f32[3], unit
    up: torch.Tensor  # f32[3], unit
    right: torch.Tensor  # f32[3], unit
    tan_half_x: torch.Tensor  # f32[] tangent of horizontal half-FOV
    tan_half_y: torch.Tensor  # f32[] tangent of vertical half-FOV
    jitter: float = 1.0  # half-width of the pixel jitter in pixels

    @property
    def device(self) -> torch.device:
        return self.eye.device

    def to(self, device) -> "Camera":
        return Camera(
            eye=self.eye.to(device),
            forward=self.forward.to(device),
            up=self.up.to(device),
            right=self.right.to(device),
            tan_half_x=self.tan_half_x.to(device),
            tan_half_y=self.tan_half_y.to(device),
            jitter=self.jitter,
        )

    @classmethod
    def look(
        cls,
        eye,
        forward,
        up,
        *,
        width: int,
        height: int,
        fov_x_deg: float = 60.0,
        jitter: float = 1.0,
        device="cpu",
    ) -> "Camera":
        """Orthonormal basis as the reference builds it:
        ``right = forward × up``, ``up = right × forward``."""

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        fwd = _normalize(f32(forward))
        right = _normalize(torch.linalg.cross(fwd, f32(up)))
        upv = _normalize(torch.linalg.cross(right, fwd))
        tan_half = f32(math.tan(math.radians(fov_x_deg) / 2.0))
        return cls(
            eye=f32(eye),
            forward=fwd,
            up=upv,
            right=right,
            tan_half_x=tan_half,
            tan_half_y=tan_half * (height / width),
            jitter=jitter,
        )

    def generate_rays_soa(
        self,
        xs: torch.Tensor,
        ys: torch.Tensor,
        jx: torch.Tensor,
        jy: torch.Tensor,
        width: int,
        height: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched primary rays, component-major.

        ``xs``/``ys`` are pixel column/row indices (row 0 = image top);
        ``jx``/``jy`` are uniform in [-1, 1) and scaled by ``jitter``.
        Returns (origins f32[3, R], directions f32[3, R] unit).
        """
        bx = xs.to(torch.float32) + jx * self.jitter
        by = ys.to(torch.float32) + jy * self.jitter
        dx = (2.0 * bx / width - 1.0) * self.tan_half_x
        dy = (1.0 - 2.0 * by / height) * self.tan_half_y
        d = (
            self.right[:, None] * dx[None, :]
            + self.up[:, None] * dy[None, :]
            + self.forward[:, None]
        )
        d = d / torch.sqrt(torch.sum(d * d, dim=0, keepdim=True))
        o = self.eye[:, None].expand(d.shape)
        return o, d


def camera_for_mcrt(width: int, height: int, device="cpu") -> Camera:
    """The MCRT backend's camera: eye (0,5,17) looking −z, up +Y,
    *vertical* FOV π/4 with aspect on the horizontal axis, ±0.5 px
    jitter."""
    tan_half_y = math.tan(math.pi / 8.0)
    cam = Camera.look(
        (0.0, 5.0, 17.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0),
        width=width, height=height, jitter=0.5, device=device,
    )
    return dataclasses.replace(
        cam,
        tan_half_y=torch.tensor(tan_half_y, dtype=torch.float32, device=device),
        tan_half_x=torch.tensor(
            tan_half_y * width / height, dtype=torch.float32, device=device
        ),
    )


def camera_for_scene(scene_id: int, width: int, height: int, device="cpu") -> Camera:
    """The reference's per-scene cameras: scene 1 eye=(0,5,17), scene 2
    eye=(0,5,23), both looking −z, 60° FOV, ±1 px jitter. Scene 3's box
    is closed, so its camera sits inside it (eye (0,5,4.8), 90° FOV, as
    the JAX package fitted it)."""
    if scene_id == 3:
        eye, fov = (0.0, 5.0, 4.8), 90.0
    else:
        eye = (0.0, 5.0, 17.0) if scene_id == 1 else (0.0, 5.0, 23.0)
        fov = 60.0
    return Camera.look(
        eye, (0.0, 0.0, -1.0), (0.0, 1.0, 0.0),
        width=width, height=height, fov_x_deg=fov, jitter=1.0,
        device=device,
    )
