"""Procedural Cornell-box scene family.

The counterpart of ``montecarlopathtracer_tpu/models/cornell.py``: the
reference scene01 layout (white floor/ceiling/back, red left wall, blue
right wall, ceiling lamp, optional mirror and glass spheres), built
triangle for triangle the same way, plus loaders for the reference's
own OBJ scenes when their read-only mount is present.

The box interior is roughly x ∈ [-6, 6], y ∈ [0, 10], z ∈ [-6, 6] with
the camera on +z looking down −z.

The reference's own scenes are read from a read-only checkout of the
reference project: ``$MCPT_REFERENCE_ROOT``, or else a directory named
``reference`` beside this repository's checkout.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np

from ..scene.camera import Camera, camera_for_mcrt, camera_for_scene
from ..scene.objio import ObjMaterial, ObjModel, ObjTriangle
from ..scene.scene import ScenePack, load_obj_scene, scene_pack_from_model

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def reference_root() -> str:
    """The reference project's checkout (see the module docstring)."""
    return os.environ.get("MCPT_REFERENCE_ROOT") or os.path.join(
        os.path.dirname(_CHECKOUT), "reference")


class _Assembler:
    """Assembles an ObjModel programmatically (vertices/normals are
    1-based with the dummy 0 slot, matching the parser contract)."""

    def __init__(self):
        self.model = ObjModel()

    def add_material(self, name: str, **kw) -> int:
        self.model.materials.append(ObjMaterial(name=name, **kw))
        return len(self.model.materials) - 1

    def _vert(self, p) -> int:
        self.model.vertices.append(tuple(float(x) for x in p))
        return len(self.model.vertices) - 1

    def _norm(self, n) -> int:
        self.model.normals.append(tuple(float(x) for x in n))
        return len(self.model.normals) - 1

    def add_quad(self, group: str, material: int, p0, p1, p2, p3, normal) -> None:
        """Two triangles (fan split like the reference parser) sharing
        one face normal."""
        vi = [self._vert(p) for p in (p0, p1, p2, p3)]
        ni = self._norm(normal)
        g = self.model.groups.setdefault(group, [])
        for tri in ((vi[0], vi[1], vi[2]), (vi[0], vi[2], vi[3])):
            self.model.triangles.append(
                ObjTriangle(v=tri, n=(ni, ni, ni), material=material)
            )
            g.append(len(self.model.triangles) - 1)

    def add_sphere(
        self, group: str, material: int, center, radius: float, subdiv: int = 2
    ) -> None:
        """Icosphere with smooth (per-vertex) normals."""
        t = (1.0 + math.sqrt(5.0)) / 2.0
        verts = [
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
        ]
        faces = [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ]
        verts = [np.asarray(v, np.float64) for v in verts]
        verts = [v / np.linalg.norm(v) for v in verts]
        cache = {}

        def midpoint(i, j):
            k = (min(i, j), max(i, j))
            if k not in cache:
                m = verts[i] + verts[j]
                m /= np.linalg.norm(m)
                verts.append(m)
                cache[k] = len(verts) - 1
            return cache[k]

        for _ in range(subdiv):
            new_faces = []
            for a, b, c in faces:
                ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
                new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
            faces = new_faces

        center = np.asarray(center, np.float64)
        vid = [self._vert(center + radius * v) for v in verts]
        nid = [self._norm(v) for v in verts]
        g = self.model.groups.setdefault(group, [])
        for a, b, c in faces:
            self.model.triangles.append(
                ObjTriangle(
                    v=(vid[a], vid[b], vid[c]),
                    n=(nid[a], nid[b], nid[c]),
                    material=material,
                )
            )
            g.append(len(self.model.triangles) - 1)


def cornell_box_model(
    *,
    emitter_ka: float = 0.78,
    with_mirror_sphere: bool = False,
    with_glass_sphere: bool = False,
    sphere_subdiv: int = 2,
) -> ObjModel:
    """Cornell box in the reference scene01 layout; optional mirror
    (Ks=1, Ns=1000) and glass (Tr=0.9, Ni=1.5) spheres."""
    b = _Assembler()
    white = b.add_material("white", Kd=(0.8, 0.8, 0.8))
    red = b.add_material("red", Kd=(1.0, 0.0, 0.0))
    blue = b.add_material("blue", Kd=(0.0, 0.0, 1.0))
    light = b.add_material("light", Ka=(emitter_ka,) * 3, Kd=(0.8, 0.8, 0.8))

    x0, x1 = -6.0, 6.0
    y0, y1 = 0.0, 10.0
    z0, z1 = -6.0, 6.0
    b.add_quad("floor", white, (x0, y0, z0), (x0, y0, z1), (x1, y0, z1), (x1, y0, z0), (0, 1, 0))
    b.add_quad("ceiling", white, (x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1), (0, -1, 0))
    b.add_quad("back", white, (x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0), (0, 0, 1))
    b.add_quad("left", red, (x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1), (1, 0, 0))
    b.add_quad("right", blue, (x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0), (-1, 0, 0))
    # ceiling lamp: small downward-facing quad just below the ceiling
    lx0, lx1, lz0, lz1, ly = -1.5, 1.5, -1.5, 1.5, y1 - 0.01
    b.add_quad("lamp", light, (lx0, ly, lz0), (lx1, ly, lz0), (lx1, ly, lz1), (lx0, ly, lz1), (0, -1, 0))

    if with_mirror_sphere:
        mirror = b.add_material("mirror", Ks=(1.0, 1.0, 1.0), Ns=1000.0)
        b.add_sphere("sphere_mirror", mirror, (-2.5, 2.0, -2.0), 2.0, sphere_subdiv)
    if with_glass_sphere:
        glass = b.add_material("glass", Kd=(0.5, 0.5, 0.5), Tr=0.9, Ni=1.5)
        b.add_sphere("sphere_glass", glass, (2.5, 2.0, 1.0), 2.0, sphere_subdiv)
    return b.model


def cornell_box(
    *,
    emitter_ka: float = 0.78,
    with_mirror_sphere: bool = False,
    with_glass_sphere: bool = False,
    sphere_subdiv: int = 2,
    width: int = 256,
    height: int = 256,
    device="cpu",
) -> Tuple[ScenePack, Camera]:
    """Procedural Cornell box + the scene-1 camera (eye (0,5,17) looking
    −z, 60° FOV)."""
    model = cornell_box_model(
        emitter_ka=emitter_ka,
        with_mirror_sphere=with_mirror_sphere,
        with_glass_sphere=with_glass_sphere,
        sphere_subdiv=sphere_subdiv,
    )
    pack = scene_pack_from_model(model, device=device)
    return pack, camera_for_scene(1, width, height, device=device)


def reference_scene_path(n: int) -> str:
    return os.path.join(reference_root(), "CVMCTracer", "CVMCTracer",
                        "Resources", f"scene{n:02d}.obj")


def mcrt_scene_path() -> str:
    return os.path.join(reference_root(), "MCRT", "QuinEngine", "Res", "scene01.obj")


def has_reference_scenes() -> bool:
    return os.path.exists(reference_scene_path(1))


def load_reference_scene(
    n: int, *, width: int = 800, height: int = 600, device="cpu"
) -> Tuple[ScenePack, Camera]:
    """Load one of the reference's committed scenes (read-only mount)
    with its hardcoded camera."""
    pack = load_obj_scene(reference_scene_path(n), device=device)
    return pack, camera_for_scene(n, width, height, device=device)


def has_mcrt_scene() -> bool:
    return os.path.exists(mcrt_scene_path())


def load_mcrt_scene(
    *, width: int = 640, height: int = 480, device="cpu"
) -> Tuple[ScenePack, Camera]:
    """Load the MCRT backend's scene variant (per-triangle materials)
    and its π/4 camera; render it with ``TraceConfig(mode="rr",
    illum=1.0)`` and gamma-space accumulation."""
    pack = load_obj_scene(mcrt_scene_path(), material_mode="triangle", device=device)
    return pack, camera_for_mcrt(width, height, device=device)
