"""OBJ/MTL scene loader (host side, pure Python → NumPy).

Carried over from ``montecarlopathtracer_tpu/scene/objio.py`` with the
same reference-parser quirks, so both packages load a file to the same
triangle soup:

- 1-based OBJ indices are kept as-is by reserving a dummy entry 0 in the
  vertex / texture / normal pools;
- faces with >3 vertices are fan-triangulated: (v0, v_{i-1}, v_i);
- backslash line continuations are joined;
- a `Ks` line force-sets Ns=2 so the material classifies as specular
  unless a later `Ns` line overrides it;
- materials default to Ka=0 Kd=0 Ks=0 Ns=1 Tr=0 Ni=1;
- material slot 0 is an unnamed default; `usemtl` of an unknown name
  resolves to it;
- `g` switches the active group; groups accumulate triangle indices.

Only the pure-Python parser is carried: the JAX package's optional C++
parser lives in a module that imports JAX.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class ObjMaterial:
    """Material record of the reference's 6-field Phong model."""

    name: str = ""
    Ka: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    Kd: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    Ks: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    Ns: float = 1.0
    Tr: float = 0.0
    Ni: float = 1.0


@dataclasses.dataclass
class ObjTriangle:
    v: Tuple[int, int, int] = (0, 0, 0)
    t: Tuple[int, int, int] = (0, 0, 0)
    n: Tuple[int, int, int] = (0, 0, 0)
    material: int = 0


@dataclasses.dataclass
class ObjModel:
    """Parsed OBJ scene.

    Index 0 of ``vertices``/``textures``/``normals``/``triangles`` is a
    dummy entry so raw 1-based OBJ indices index directly.
    """

    path: str = ""
    vertices: List[Tuple[float, float, float]] = dataclasses.field(
        default_factory=lambda: [(0.0, 0.0, 0.0)]
    )
    textures: List[Tuple[float, float]] = dataclasses.field(
        default_factory=lambda: [(0.0, 0.0)]
    )
    normals: List[Tuple[float, float, float]] = dataclasses.field(
        default_factory=lambda: [(0.0, 0.0, 0.0)]
    )
    triangles: List[ObjTriangle] = dataclasses.field(
        default_factory=lambda: [ObjTriangle()]
    )
    materials: List[ObjMaterial] = dataclasses.field(
        default_factory=lambda: [ObjMaterial()]
    )
    # group name -> list of triangle indices (into `triangles`)
    groups: Dict[str, List[int]] = dataclasses.field(default_factory=dict)

    def vertex_array(self) -> np.ndarray:
        return np.asarray(self.vertices, dtype=np.float32)

    def normal_array(self) -> np.ndarray:
        return np.asarray(self.normals, dtype=np.float32)


def _parse_face_vertex(token: str) -> Tuple[int, int, int]:
    """Parse one face-vertex token: ``v``, ``v/t``, ``v//n`` or ``v/t/n``.
    Missing components resolve to index 0 (the dummy slot)."""
    parts = token.split("/")
    v = int(parts[0])
    t = int(parts[1]) if len(parts) > 1 and parts[1] != "" else 0
    n = int(parts[2]) if len(parts) > 2 and parts[2] != "" else 0
    return v, t, n


def _read_logical_lines(path: str):
    """Yield lines with backslash continuations joined."""
    with open(path, "r") as f:
        buf = ""
        for raw in f:
            line = raw.rstrip("\n").rstrip("\r")
            if line.endswith("\\"):
                buf += line[:-1]
                continue
            yield buf + line
            buf = ""
        if buf:
            yield buf


def _read_mtl(model: ObjModel, path: str) -> None:
    """Parse a .mtl file into ``model.materials``: a ``Ks`` line sets
    Ns=2 (a later ``Ns`` overrides); ``newmtl`` with an existing name
    re-opens it; unknown keys are ignored."""
    idx = 0
    for line in _read_logical_lines(path):
        tokens = line.split()
        if not tokens or tokens[0].startswith("#"):
            continue
        key = tokens[0]
        if key == "newmtl":
            name = tokens[1]
            idx = _find_material(model, name)
            if idx == 0:
                model.materials.append(ObjMaterial(name=name))
                idx = len(model.materials) - 1
        elif key == "Ka":
            model.materials[idx].Ka = tuple(float(x) for x in tokens[1:4])
        elif key == "Kd":
            model.materials[idx].Kd = tuple(float(x) for x in tokens[1:4])
        elif key == "Ks":
            model.materials[idx].Ks = tuple(float(x) for x in tokens[1:4])
            model.materials[idx].Ns = 2.0  # reference quirk: Ks ⇒ specular
        elif key == "Ns":
            model.materials[idx].Ns = float(tokens[1])
        elif key == "Tr":
            model.materials[idx].Tr = float(tokens[1])
        elif key == "Ni":
            model.materials[idx].Ni = float(tokens[1])


def _find_material(model: ObjModel, name: str) -> int:
    """Material lookup by name; slot 0 (unnamed default) when missing."""
    for i in range(1, len(model.materials)):
        if model.materials[i].name == name:
            return i
    return 0


def read_obj(path: str) -> ObjModel:
    """Load an OBJ file (plus any ``mtllib``) into an :class:`ObjModel`."""
    model = ObjModel(path=path)
    group = "default"
    model.groups.setdefault(group, [])
    material = 0

    for line in _read_logical_lines(path):
        tokens = line.split()
        if not tokens or tokens[0].startswith("#"):
            continue
        key = tokens[0]
        if key == "mtllib":
            mtl_path = os.path.join(os.path.dirname(path), tokens[1])
            _read_mtl(model, mtl_path)
        elif key == "g":
            group = tokens[1] if len(tokens) > 1 else "default"
            model.groups.setdefault(group, [])
        elif key == "usemtl":
            material = _find_material(model, tokens[1])
        elif key == "v":
            model.vertices.append(tuple(float(x) for x in tokens[1:4]))
        elif key == "vt":
            model.textures.append(tuple(float(x) for x in tokens[1:3]))
        elif key == "vn":
            model.normals.append(tuple(float(x) for x in tokens[1:4]))
        elif key == "f":
            # Fan triangulation: (v0, v_{i-1}, v_i) for i >= 2.
            fv = [_parse_face_vertex(t) for t in tokens[1:]]
            for i in range(2, len(fv)):
                tri = ObjTriangle(
                    v=(fv[0][0], fv[i - 1][0], fv[i][0]),
                    t=(fv[0][1], fv[i - 1][1], fv[i][1]),
                    n=(fv[0][2], fv[i - 1][2], fv[i][2]),
                    material=material,
                )
                model.triangles.append(tri)
                model.groups[group].append(len(model.triangles) - 1)
    return model
