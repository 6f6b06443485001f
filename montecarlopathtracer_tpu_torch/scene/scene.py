"""Flat tensor scene representation.

The counterpart of ``montecarlopathtracer_tpu/scene/scene.py``: a
:class:`ScenePack` of tensors with the same twelve fields, shapes and
dtypes, moved between devices with :meth:`ScenePack.to`. Materials are
stored per triangle (``tri_mat``); CUDA group semantics (a whole group
shades with its first triangle's material) are applied at build time
with ``material_mode="group"``.

The JAX package pads the triangle axis to a multiple of 128 for the TPU
lanes; this package does not. A pack converted from the JAX package
(:func:`..convert.scene_from_numpy`) keeps its padding triangles, which
``tri_valid`` marks and which can never win an intersection.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .objio import ObjModel, read_obj

FIELDS = (
    "vertices", "normals", "tri_v", "tri_n", "tri_mat", "tri_valid",
    "mat_ka", "mat_kd", "mat_ks", "mat_ns", "mat_tr", "mat_ni",
)


@dataclasses.dataclass
class ScenePack:
    """Scene as flat tensors. V vertices, N normals, T triangles, M
    materials; float tensors are float32, index tensors int32."""

    vertices: torch.Tensor  # f32[V, 3]
    normals: torch.Tensor  # f32[N, 3]
    tri_v: torch.Tensor  # i32[T, 3] vertex indices
    tri_n: torch.Tensor  # i32[T, 3] normal indices
    tri_mat: torch.Tensor  # i32[T] material ids
    tri_valid: torch.Tensor  # bool[T] False for padding
    mat_ka: torch.Tensor  # f32[M, 3] emission (emitter iff any > 0)
    mat_kd: torch.Tensor  # f32[M, 3] diffuse albedo
    mat_ks: torch.Tensor  # f32[M, 3] specular albedo
    mat_ns: torch.Tensor  # f32[M] Phong exponent (specular iff > 1)
    mat_tr: torch.Tensor  # f32[M] transparency (refractive iff > 0)
    mat_ni: torch.Tensor  # f32[M] index of refraction

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v.shape[0])

    def to(self, device) -> "ScenePack":
        return ScenePack(**{f: getattr(self, f).to(device) for f in FIELDS})

    def triangle_vertices(self) -> Tuple[torch.Tensor, ...]:
        """Triangle corner positions: three f32[T, 3] tensors."""
        tv = self.tri_v.long()
        return tuple(self.vertices[tv[:, k]] for k in range(3))

    def triangle_normals(self) -> Tuple[torch.Tensor, ...]:
        """Per-corner shading normals: three f32[T, 3] tensors."""
        tn = self.tri_n.long()
        return tuple(self.normals[tn[:, k]] for k in range(3))

    def aabb(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Scene bounds over valid triangles."""
        pts = torch.cat(self.triangle_vertices(), dim=0)
        valid = self.tri_valid.repeat(3)[:, None]
        big = 3.4e38
        lo = torch.where(valid, pts, big).amin(dim=0)
        hi = torch.where(valid, pts, -big).amax(dim=0)
        return lo, hi


def _materials_from_model(model: ObjModel) -> dict:
    mats = model.materials
    return {
        "Ka": [m.Ka for m in mats], "Kd": [m.Kd for m in mats],
        "Ks": [m.Ks for m in mats], "Ns": [m.Ns for m in mats],
        "Tr": [m.Tr for m in mats], "Ni": [m.Ni for m in mats],
    }


def scene_pack_from_model(
    model: ObjModel, material_mode: str = "group", device="cpu"
) -> ScenePack:
    """Flatten a parsed :class:`ObjModel` into a :class:`ScenePack`.

    ``material_mode="group"``: every triangle of a named group shades
    with the material of the group's first triangle (CUDA backend);
    ``"triangle"`` keeps per-triangle materials as parsed (MCRT).
    Triangles are ordered by sorted group name, as in the JAX package.
    """
    tri_rows = []
    for _, tri_ids in sorted(model.groups.items()):
        if not tri_ids:
            continue
        if material_mode == "group":
            mats = [model.triangles[tri_ids[0]].material] * len(tri_ids)
        elif material_mode == "triangle":
            mats = [model.triangles[t].material for t in tri_ids]
        else:
            raise ValueError(f"unknown material_mode: {material_mode!r}")
        for tid, mat in zip(tri_ids, mats):
            tri = model.triangles[tid]
            tri_rows.append((tri.v, tri.n, mat))
    if not tri_rows:
        raise ValueError(f"model {model.path!r} has no triangles")
    return scene_pack_from_arrays(
        model.vertex_array(),
        model.normal_array(),
        np.asarray([r[0] for r in tri_rows], np.int32),
        np.asarray([r[1] for r in tri_rows], np.int32),
        np.asarray([r[2] for r in tri_rows], np.int32),
        _materials_from_model(model),
        device=device,
    )


def scene_pack_from_arrays(
    vertices: np.ndarray,  # f32[V, 3]
    normals: np.ndarray,  # f32[N, 3]
    tri_v: np.ndarray,  # i32[T, 3]
    tri_n: np.ndarray,  # i32[T, 3]
    tri_mat: np.ndarray,  # i32[T]
    materials: dict,  # {"Ka": [M,3], "Kd": [M,3], "Ks": [M,3],
    #                    "Ns": [M], "Tr": [M], "Ni": [M]}
    device="cpu",
) -> ScenePack:
    """Assemble a :class:`ScenePack` from raw numpy arrays; every
    triangle is valid."""

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return ScenePack(
        vertices=f32(vertices),
        normals=f32(normals),
        tri_v=i32(tri_v),
        tri_n=i32(tri_n),
        tri_mat=i32(tri_mat),
        tri_valid=torch.ones(len(tri_v), dtype=torch.bool, device=device),
        mat_ka=f32(materials["Ka"]),
        mat_kd=f32(materials["Kd"]),
        mat_ks=f32(materials["Ks"]),
        mat_ns=f32(materials["Ns"]),
        mat_tr=f32(materials["Tr"]),
        mat_ni=f32(materials["Ni"]),
    )


def load_obj_scene(
    path: str, material_mode: str = "group", device="cpu"
) -> ScenePack:
    """Parse an OBJ file and flatten it in one call."""
    return scene_pack_from_model(read_obj(path), material_mode, device)
