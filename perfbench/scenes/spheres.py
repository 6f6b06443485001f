"""A scene given as data: named materials, planar polygons (as
:mod:`.polygons` takes them), icospheres and spherical caps, as a
configuration's ``builder_args`` lists them.

A sphere is an icosahedron whose faces are split ``subdiv`` times, each
new vertex pushed out to the sphere, with smooth per-vertex normals
that are exactly radial: 20 * 4^subdiv triangles. A cap is the part of
a sphere below the plane y = ``below``, in ``rings`` rings of
``segments`` vertices around its lowest point, every vertex on the
sphere with a radial normal: segments * (2 rings - 1) triangles.
"""

from __future__ import annotations

import math

import numpy as np

from .assemble import Arrays, Assembler

_T = (1.0 + math.sqrt(5.0)) / 2.0
ICOSAHEDRON = (
    [(-1, _T, 0), (1, _T, 0), (-1, -_T, 0), (1, -_T, 0), (0, -1, _T), (0, 1, _T), (0, -1, -_T),
     (0, 1, -_T), (_T, 0, -1), (_T, 0, 1), (-_T, 0, -1), (-_T, 0, 1)],
    [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
     (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
     (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)],
)


def icosphere(subdiv: int):
    """Unit vectors f64[V, 3] and faces [(a, b, c)] of the icosahedron
    split ``subdiv`` times: each face into four through its edges'
    midpoints, pushed out to the unit sphere."""
    verts = [np.asarray(v, np.float64) for v in ICOSAHEDRON[0]]
    verts = [v / np.linalg.norm(v) for v in verts]
    faces = list(ICOSAHEDRON[1])
    mid = {}

    def midpoint(i, j):
        k = (min(i, j), max(i, j))
        if k not in mid:
            m = verts[i] + verts[j]
            verts.append(m / np.linalg.norm(m))
            mid[k] = len(verts) - 1
        return mid[k]

    for _ in range(subdiv):
        split = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            split += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = split
    return np.stack(verts), faces


def cap(center, radius: float, below: float, segments: int, rings: int):
    """Unit vectors f64[V, 3] (from the centre) and faces of the cap of
    the sphere below the plane y = ``below``: the lowest point, then
    ``rings`` rings at polar angles k / rings of the rim's (k = 1 ..
    rings), ``segments`` vertices each, the last ring on the plane."""
    rim = math.acos((center[1] - below) / radius)
    verts = [np.array([0.0, -1.0, 0.0])]
    for k in range(1, rings + 1):
        theta = rim * k / rings
        for j in range(segments):
            phi = 2.0 * math.pi * j / segments
            verts.append(np.array([math.sin(theta) * math.cos(phi), -math.cos(theta),
                                   math.sin(theta) * math.sin(phi)]))

    def at(k, j):  # vertex j of ring k (1-based)
        return 1 + (k - 1) * segments + j % segments

    faces = [(0, at(1, j), at(1, j + 1)) for j in range(segments)]
    for k in range(1, rings):
        for j in range(segments):
            faces += [(at(k, j), at(k + 1, j), at(k + 1, j + 1)),
                      (at(k, j), at(k + 1, j + 1), at(k, j + 1))]
    return np.stack(verts), faces


def _add(b: Assembler, group: str, mat: int, center, radius: float, unit, faces):
    """Triangles on a sphere: each vertex ``center + radius * unit``
    with the unit vector as its normal."""
    center = np.asarray(center, np.float64)
    v = [b._vertex(center + radius * u) for u in unit]
    n = [b._normal(u) for u in unit]
    tris = b.groups.setdefault(group, [])
    for a, c, d in faces:
        tris.append(((v[a], v[c], v[d]), (n[a], n[c], n[d]), mat))


def build(*, materials: dict, polygons: list = (), spheres: list = (),
          caps: list = ()) -> Arrays:
    """``materials``: name -> {Ka, Kd, Ks, Ns, Tr, Ni} (missing keys take
    the default); ``polygons``: [{"group", "material", "corners"}];
    ``spheres``: [{"group", "material", "center", "radius", "subdiv"}];
    ``caps``: [{"group", "material", "center", "radius", "below",
    "segments", "rings"}]."""
    b = Assembler()
    ids = {name: b.material(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in m.items()})
           for name, m in materials.items()}
    for p in polygons:
        b.polygon(p["group"], ids[p["material"]], p["corners"])
    for s in spheres:
        _add(b, s["group"], ids[s["material"]], s["center"], s["radius"],
             *icosphere(s["subdiv"]))
    for c in caps:
        _add(b, c["group"], ids[c["material"]], c["center"], c["radius"],
             *cap(c["center"], c["radius"], c["below"], c["segments"], c["rings"]))
    return b.arrays()
