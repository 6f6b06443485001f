"""A scene assembled from polygons into flat numpy arrays.

The layout of the program's scene packs: vertices and normals keep a
dummy entry 0 (OBJ's 1-based indices), material 0 is the unnamed
default (Ka = Kd = Ks = 0, Ns = 1, Tr = 0, Ni = 1), a polygon is fanned
from its first corner, and the triangles are ordered by sorted group
name (each group's own order kept), every triangle shading with its own
material.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Arrays:
    """A scene as flat arrays: V vertices, N normals, T triangles, M
    materials."""

    vertices: np.ndarray  # f32[V, 3]
    normals: np.ndarray  # f32[N, 3]
    tri_v: np.ndarray  # i32[T, 3]
    tri_n: np.ndarray  # i32[T, 3]
    tri_mat: np.ndarray  # i32[T]
    mat_ka: np.ndarray  # f32[M, 3]
    mat_kd: np.ndarray  # f32[M, 3]
    mat_ks: np.ndarray  # f32[M, 3]
    mat_ns: np.ndarray  # f32[M]
    mat_tr: np.ndarray  # f32[M]
    mat_ni: np.ndarray  # f32[M]

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v.shape[0])

    def corners(self):
        """The triangles' corners, three f32[T, 3] arrays."""
        return tuple(self.vertices[self.tri_v[:, k]] for k in range(3))


class Assembler:
    def __init__(self):
        self.vertices = [(0.0, 0.0, 0.0)]
        self.normals = [(0.0, 0.0, 0.0)]
        self.materials = [dict(Ka=(0.0,) * 3, Kd=(0.0,) * 3, Ks=(0.0,) * 3, Ns=1.0,
                               Tr=0.0, Ni=1.0)]
        self.groups = {}  # name -> [(v, n, material)]

    def material(self, Ka=(0.0,) * 3, Kd=(0.0,) * 3, Ks=(0.0,) * 3, Ns=1.0, Tr=0.0,
                 Ni=1.0) -> int:
        self.materials.append(dict(Ka=Ka, Kd=Kd, Ks=Ks, Ns=Ns, Tr=Tr, Ni=Ni))
        return len(self.materials) - 1

    def _vertex(self, p) -> int:
        self.vertices.append(tuple(float(x) for x in p))
        return len(self.vertices) - 1

    def _normal(self, n) -> int:
        self.normals.append(tuple(float(x) for x in n))
        return len(self.normals) - 1

    def polygon(self, group, mat, corners):
        """A planar polygon, fanned from its first corner into triangles,
        each with its own face normal (the side does not matter: every
        lobe reads the normal two-sided)."""
        v = [self._vertex(p) for p in corners]
        tris = self.groups.setdefault(group, [])
        for k in range(1, len(v) - 1):
            a, b, c = (np.asarray(corners[i], np.float64) for i in (0, k, k + 1))
            nrm = np.cross(b - a, c - a)
            n = self._normal(nrm / np.linalg.norm(nrm))
            tris.append(((v[0], v[k], v[k + 1]), (n, n, n), mat))

    def arrays(self) -> Arrays:
        rows = [r for _, tris in sorted(self.groups.items()) for r in tris]
        f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
        m = self.materials
        return Arrays(
            vertices=f32(self.vertices), normals=f32(self.normals),
            tri_v=np.asarray([r[0] for r in rows], np.int32),
            tri_n=np.asarray([r[1] for r in rows], np.int32),
            tri_mat=np.asarray([r[2] for r in rows], np.int32),
            mat_ka=f32([x["Ka"] for x in m]), mat_kd=f32([x["Kd"] for x in m]),
            mat_ks=f32([x["Ks"] for x in m]), mat_ns=f32([x["Ns"] for x in m]),
            mat_tr=f32([x["Tr"] for x in m]), mat_ni=f32([x["Ni"] for x in m]))
