"""The large procedural benchmark scene ("bunny-class" triangle count).

Carried over from ``montecarlopathtracer_tpu/models/bunny.py`` (numpy
only, the same arrays): a displaced icosphere, an irregular blob whose
triangle count and locality are those of a scanned mesh, in a
Cornell-style room open towards the camera, with a ceiling lamp. At
subdivision 6 it has 81,920 + 12 = 81,932 triangles, the scene of the
traversal path (``intersector="traverse"``): brute selection does
O(R·T) work per segment there.

The port's :class:`ScenePack` is not padded to a multiple of 128
triangles; the JAX package's is, so its first T rows are this scene's.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from ..scene.camera import Camera, camera_for_scene
from ..scene.scene import ScenePack, scene_pack_from_arrays


def icosphere(subdiv: int) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere by midpoint subdivision: (verts f64[V, 3], faces
    i64[F, 3]) with F = 20·4^subdiv."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ],
        np.int64,
    )
    for _ in range(subdiv):
        # One midpoint vertex per unique undirected edge.
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
        uniq, inv = np.unique(np.sort(e, axis=1), axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid_idx = len(verts) + np.arange(len(uniq))
        verts = np.concatenate([verts, mids], axis=0)
        F = len(faces)
        m01 = mid_idx[inv[0:F]]
        m12 = mid_idx[inv[F:2 * F]]
        m20 = mid_idx[inv[2 * F:3 * F]]
        faces = np.concatenate(
            [
                np.stack([faces[:, 0], m01, m20], axis=1),
                np.stack([faces[:, 1], m12, m01], axis=1),
                np.stack([faces[:, 2], m20, m12], axis=1),
                np.stack([m01, m12, m20], axis=1),
            ],
            axis=0,
        )
    return verts, faces


def _fbm_displace(v: np.ndarray, seed: int = 7) -> np.ndarray:
    """Radial displacement: a few fixed sine octaves (deterministic,
    smooth and irregular)."""
    rng = np.random.default_rng(seed)
    d = np.zeros(len(v))
    for octave in range(4):
        freq = 1.5 * 2.0**octave
        amp = 0.30 / 2.0**octave
        k = rng.normal(size=(3, 3))
        ph = rng.uniform(0, 2 * np.pi, 3)
        d += amp * np.sin(v @ (freq * k) + ph).sum(axis=1) / 3.0
    return d


def bunny_mesh(subdiv: int = 6) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Displaced icosphere: (verts f32[V, 3], normals f32[V, 3], faces
    i32[F, 3]) with F = 20·4^subdiv (81,920 at subdiv 6)."""
    v, f = icosphere(subdiv)
    p = v * (1.0 + _fbm_displace(v))[:, None]
    # Smooth vertex normals: area-weighted face-normal accumulation.
    fn = np.cross(p[f[:, 1]] - p[f[:, 0]], p[f[:, 2]] - p[f[:, 0]])
    n = np.zeros_like(p)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    return p.astype(np.float32), n.astype(np.float32), f.astype(np.int32)


def bunny_scene(
    *,
    subdiv: int = 6,
    width: int = 1024,
    height: int = 1024,
    glossy: bool = False,
    device="cpu",
) -> Tuple[ScenePack, Camera]:
    """The blob (20·4^subdiv triangles) on the floor of a room with a
    ceiling lamp; the scene-1 camera (eye on +z looking −z, 60° FOV).
    The blob is diffuse, or with ``glossy=True`` a Phong lobe (Kd 0,
    Ks 0.9, Ns 50), as in the JAX package."""
    mv, mn, mf = bunny_mesh(subdiv)
    mv = mv * (2.6 / np.abs(mv).max())  # radius ~2.6, like scene 1's spheres
    mv[:, 1] += 3.0  # above the floor
    mv[:, 2] -= 1.0

    # Room: x in [-6, 6], y in [0, 10], z in [-6, 6], no front wall.
    x0, x1, y0, y1, z0, z1 = -6.0, 6.0, 0.0, 10.0, -6.0, 6.0
    lx0, lx1, lz0, lz1, ly = -1.5, 1.5, -1.5, 1.5, y1 - 0.01
    quads = [
        # (p0, p1, p2, p3, normal, material)
        ((x0, y0, z0), (x0, y0, z1), (x1, y0, z1), (x1, y0, z0), (0, 1, 0), 0),
        ((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1), (0, -1, 0), 0),
        ((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0), (0, 0, 1), 0),
        ((x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1), (1, 0, 0), 1),
        ((x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0), (-1, 0, 0), 2),
        ((lx0, ly, lz0), (lx1, ly, lz0), (lx1, ly, lz1), (lx0, ly, lz1), (0, -1, 0), 3),
    ]
    rv, rn, rf, rm = [], [], [], []
    for p0, p1, p2, p3, nrm, mat in quads:
        base = len(rv)
        rv += [p0, p1, p2, p3]
        rn.append(nrm)
        rf += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
        rm += [mat, mat]
    rv = np.asarray(rv, np.float32)
    rn = np.asarray(rn, np.float32)
    rf = np.asarray(rf, np.int32)
    room_tri_n = np.repeat(np.arange(len(quads), dtype=np.int32), 2)  # face normal q

    # Room normals are per face, mesh normals per vertex: one pool each,
    # concatenated with offsets.
    verts = np.concatenate([rv, mv], axis=0)
    normals = np.concatenate([rn, mn], axis=0)
    tri_v = np.concatenate([rf, mf + len(rv)], axis=0)
    tri_n = np.concatenate([np.stack([room_tri_n] * 3, axis=1), mf + len(rn)], axis=0)
    tri_mat = np.concatenate([np.asarray(rm, np.int32), np.full(len(mf), 4, np.int32)])

    Z3 = (0.0, 0.0, 0.0)
    materials = dict(
        Ka=[Z3, Z3, Z3, (0.78, 0.78, 0.78), Z3],
        Kd=[(0.8, 0.8, 0.8), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.8, 0.8, 0.8),
            Z3 if glossy else (0.75, 0.71, 0.62)],
        Ks=[Z3, Z3, Z3, Z3, (0.9, 0.9, 0.9) if glossy else Z3],
        Ns=[1.0, 1.0, 1.0, 1.0, 50.0 if glossy else 1.0],
        Tr=[0.0] * 5,
        Ni=[1.0] * 5,
    )
    pack = scene_pack_from_arrays(verts, normals, tri_v, tri_n, tri_mat, materials,
                                  device=device)
    return pack, camera_for_scene(1, width, height, device=device)
