"""State carried across from the JAX package, through numpy only.

The JAX package's arrays convert with ``np.asarray`` on that side; this
module turns the numpy arrays into the port's objects, so nothing here
imports JAX::

    from montecarlopathtracer_tpu_torch import convert
    scene = convert.scene_from_numpy(
        {f: np.asarray(getattr(jax_scene, f)) for f in convert.FIELDS})
    camera = convert.camera_from_numpy(
        {f: np.asarray(getattr(jax_camera, f)) for f in convert.CAMERA_FIELDS},
        jitter=jax_camera.jitter)

A film checkpoint written by the JAX package's
``Renderer.save_checkpoint`` has the same ``.npz`` keys as the port's
(``color``, ``weight``, ``m2``, ``seed``, ``pass_idx``) and loads into
the port's ``Renderer`` as it is.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .scene.camera import Camera
from .scene.scene import FIELDS, ScenePack

CAMERA_FIELDS = ("eye", "forward", "up", "right", "tan_half_x", "tan_half_y")

_INT_FIELDS = ("tri_v", "tri_n", "tri_mat")


def scene_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu") -> ScenePack:
    """:class:`ScenePack` from the twelve ScenePack fields as numpy
    arrays (padding triangles included; ``tri_valid`` keeps them out)."""
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"missing ScenePack fields: {missing}")

    def conv(name):
        a = np.asarray(arrays[name])
        if name == "tri_valid":
            a = a.astype(bool)
        elif name in _INT_FIELDS:
            a = a.astype(np.int32)
        else:
            a = a.astype(np.float32)
        return torch.as_tensor(a, device=device)

    return ScenePack(**{f: conv(f) for f in FIELDS})


def camera_from_numpy(
    arrays: Mapping[str, np.ndarray], jitter: float = 1.0, device="cpu"
) -> Camera:
    """:class:`Camera` from its six array fields as numpy arrays."""
    missing = [f for f in CAMERA_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"missing Camera fields: {missing}")
    return Camera(
        **{
            f: torch.as_tensor(np.array(arrays[f], np.float32), device=device)
            for f in CAMERA_FIELDS
        },
        jitter=float(jitter),
    )
