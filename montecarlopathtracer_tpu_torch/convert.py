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

Parameter and gradient dicts (the JAX package's ``split_params`` and
``jax.grad`` outputs, ``{field: array}``) cross with
:func:`params_from_numpy` and :func:`params_to_numpy`. A KD tree of the
JAX package (its ``FlatKDTree``, all numpy) crosses with
:func:`kdtree_from_numpy`::

    flat = convert.kdtree_from_numpy(
        {f: getattr(jax_flat, f) for f in convert.KD_FIELDS})

A film checkpoint written by the JAX package's
``Renderer.save_checkpoint`` has the same ``.npz`` keys as the port's
(``color``, ``weight``, ``m2``, ``seed``, ``pass_idx``) and loads into
the port's ``Renderer`` as it is.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .accel.kdtree import FlatKDTree
from .scene.camera import Camera
from .scene.scene import FIELDS, ScenePack

CAMERA_FIELDS = ("eye", "forward", "up", "right", "tan_half_x", "tan_half_y")
KD_FIELDS = ("node_lo", "node_hi", "node_skip", "leaf_start", "leaf_count", "leaf_tris")

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


def params_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu") -> dict:
    """``{field: f32 tensor}`` from a parameter or gradient dict of numpy
    arrays (``{f: np.asarray(x) for f, x in jax_params.items()}``)."""
    return {
        f: torch.as_tensor(np.array(a, np.float32), device=device)
        for f, a in arrays.items()
    }


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict:
    """``{field: f32 numpy array}`` from a parameter or gradient dict of
    tensors, on any device."""
    return {f: t.detach().cpu().numpy().astype(np.float32) for f, t in params.items()}


def kdtree_from_numpy(arrays: Mapping[str, np.ndarray]) -> FlatKDTree:
    """The port's :class:`.accel.kdtree.FlatKDTree` from the six arrays of
    a JAX ``FlatKDTree`` (float32 boxes, int32 links and leaf lists)."""
    missing = [f for f in KD_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"missing FlatKDTree fields: {missing}")
    return FlatKDTree(**{
        f: np.array(arrays[f], np.float32 if f in ("node_lo", "node_hi") else np.int32)
        for f in KD_FIELDS
    })
