"""Procedural glossy-steps scene: the reference's scene02 family.

Carried over from ``montecarlopathtracer_tpu/models/glossy.py`` (the same
arrays): an open stage of two planes lit by four sphere emitters of
different radii, with four glossy cubes of decreasing Phong exponent
(Ns = 50/20/10/5) showing the roughness ladder: 4 + 48 + 4 × 320 =
1,332 triangles (the JAX scene's default options), the scene of the
chunk-cull path (``TraceConfig(chunk_cull=True)``): open, so most rays
leave it, and most chunks are out of most tiles' reach.
"""

from __future__ import annotations

from typing import Tuple

from ..scene.camera import Camera, camera_for_scene
from ..scene.objio import ObjModel
from ..scene.scene import ScenePack, scene_pack_from_model
from .cornell import _Assembler


NS_LADDER = (50.0, 20.0, 10.0, 5.0)  # the cubes' Phong exponents
SPHERE_SUBDIV = 2  # icosphere subdivisions of the lamps (320 triangles each)


def glossy_steps_model() -> ObjModel:
    """Two planes + four sphere emitters + four glossy cubes."""
    b = _Assembler()
    gray = b.add_material("floor", Kd=(0.75, 0.75, 0.75))
    wall = b.add_material("wall", Kd=(0.7, 0.7, 0.75))
    light = b.add_material("light", Ka=(1.0, 1.0, 1.0))

    # Stage: floor plane and back wall.
    b.add_quad("floor", gray, (-10, 0, -8), (-10, 0, 10), (10, 0, 10), (10, 0, -8), (0, 1, 0))
    b.add_quad("back", wall, (-10, 0, -8), (10, 0, -8), (10, 14, -8), (-10, 14, -8), (0, 0, 1))

    # Four glossy cubes in a row, Ns descending (the "steps").
    xs = (-6.0, -2.0, 2.0, 6.0)
    for i, (x, ns) in enumerate(zip(xs, NS_LADDER)):
        mat = b.add_material(f"glossy{i}", Kd=(0.2, 0.2, 0.2), Ks=(0.8, 0.8, 0.8), Ns=ns)
        s = 1.4  # half-size
        y0, y1 = 0.0, 2.0 * s
        g = f"cube{i}"
        # 6 faces of an axis-aligned cube centred at (x, s, 0)
        b.add_quad(g, mat, (x - s, y0, -s), (x - s, y0, s), (x + s, y0, s), (x + s, y0, -s), (0, -1, 0))
        b.add_quad(g, mat, (x - s, y1, -s), (x + s, y1, -s), (x + s, y1, s), (x - s, y1, s), (0, 1, 0))
        b.add_quad(g, mat, (x - s, y0, s), (x - s, y1, s), (x + s, y1, s), (x + s, y0, s), (0, 0, 1))
        b.add_quad(g, mat, (x - s, y0, -s), (x + s, y0, -s), (x + s, y1, -s), (x - s, y1, -s), (0, 0, -1))
        b.add_quad(g, mat, (x - s, y0, -s), (x - s, y1, -s), (x - s, y1, s), (x - s, y0, s), (-1, 0, 0))
        b.add_quad(g, mat, (x + s, y0, -s), (x + s, y0, s), (x + s, y1, s), (x + s, y1, -s), (1, 0, 0))

    # Four sphere emitters of different radii.
    for i, (x, r) in enumerate(zip(xs, (0.6, 0.9, 1.2, 1.5))):
        b.add_sphere(f"lamp{i}", light, (x, 6.5, 1.0), r, SPHERE_SUBDIV)
    return b.model


def glossy_steps(
    *, width: int = 256, height: int = 256, device="cpu"
) -> Tuple[ScenePack, Camera]:
    """The procedural glossy-steps scene and the scene-2 camera (eye
    (0,5,23) looking −z, 60° FOV)."""
    pack = scene_pack_from_model(glossy_steps_model(), device=device)
    return pack, camera_for_scene(2, width, height, device=device)
