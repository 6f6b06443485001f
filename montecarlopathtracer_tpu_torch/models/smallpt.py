"""smallpt's scene: the box, mirror sphere, glass sphere and light of
Kevin Beason's 99-line path tracer (http://www.kevinbeason.com/smallpt/,
``smallpt.cpp``: the ``spheres[]`` list and the camera of ``main()``),
in smallpt's own units, as the triangles the port renders.

- The walls are quads on the planes of smallpt's radius-1e5 spheres
  (x = 1 red, x = 99 blue, z = 0, y = 0 and y = 81.6 white, Kd 0.75);
  the black front wall at z = 170 is left out, since the pinhole sits at
  smallpt's eye and every primary ray enters the box through it.
- The mirror (Ks 0.999, the Blinn lobe at Ns 1e6) and the glass (Kd
  0.999, Tr 0.96, Ni 1.5) are icospheres of :data:`SPHERE_SUBDIV`
  subdivisions of radius 16.5 (1,280 triangles each, radial normals).
- The light is the cap of smallpt's radius-600 light sphere below the
  ceiling (:data:`CAP_SEGMENTS` x (2 :data:`CAP_RINGS` - 1) triangles),
  Ka 12 at an emitter scale of 1, Kd 0.
- The camera is smallpt's: eye (50, 52, 295.6), direction (0, -0.042612,
  -1), its film spanning ``cy = 0.5135`` vertically and ``cx = 0.5135 w /
  h`` horizontally, so a horizontal field of 2 atan(0.5135 w / 2 h).

2,696 triangles, between the CLI's ``CULL_FROM`` and ``TRAVERSE_FROM``;
the benchmark's ``perfbench/configs/smallpt.json`` holds the same
triangles.
"""

from __future__ import annotations

import math
from typing import Tuple

from ..scene.camera import Camera
from ..scene.objio import ObjModel
from ..scene.scene import ScenePack, scene_pack_from_model
from .cornell import _Assembler

SPHERE_SUBDIV = 3  # 1,280 triangles a sphere; the deepest face 0.075 units inside
CAP_SEGMENTS, CAP_RINGS = 42, 2  # the light's cap: 126 triangles
FOV_SCALE = 0.5135  # smallpt's cy: the film's height at unit distance
EYE = (50.0, 52.0, 295.6)
FORWARD = (0.0, -0.042612, -1.0)
LIGHT_CENTER, LIGHT_RADIUS, CEILING = (50.0, 681.6 - 0.27, 81.6), 600.0, 81.6


def smallpt_model() -> ObjModel:
    """The box's five walls, the two spheres and the light's cap."""
    b = _Assembler()
    left = b.add_material("left", Kd=(0.75, 0.25, 0.25))
    right = b.add_material("right", Kd=(0.25, 0.25, 0.75))
    white = b.add_material("white", Kd=(0.75, 0.75, 0.75))
    mirror = b.add_material("mirror", Ks=(0.999, 0.999, 0.999), Ns=1e6)
    glass = b.add_material("glass", Kd=(0.999, 0.999, 0.999), Tr=0.96, Ni=1.5)
    light = b.add_material("light", Ka=(12.0, 12.0, 12.0))
    x0, x1, y0, y1, z0, z1 = 1.0, 99.0, 0.0, CEILING, 0.0, 170.0
    b.add_quad("left", left, (x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1), (1, 0, 0))
    b.add_quad("right", right, (x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0), (-1, 0, 0))
    b.add_quad("back", white, (x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0), (0, 0, 1))
    b.add_quad("bottom", white, (x0, y0, z0), (x0, y0, z1), (x1, y0, z1), (x1, y0, z0), (0, 1, 0))
    b.add_quad("top", white, (x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1), (0, -1, 0))
    b.add_sphere("mirror", mirror, (27.0, 16.5, 47.0), 16.5, SPHERE_SUBDIV)
    b.add_sphere("glass", glass, (73.0, 16.5, 78.0), 16.5, SPHERE_SUBDIV)
    b.add_cap("light", light, LIGHT_CENTER, LIGHT_RADIUS, CEILING, CAP_SEGMENTS, CAP_RINGS)
    return b.model


def smallpt_camera(width: int, height: int, device="cpu") -> Camera:
    """smallpt's camera at ``width`` x ``height``, ±1 px jitter."""
    fov_x = math.degrees(2.0 * math.atan(0.5 * FOV_SCALE * width / height))
    return Camera.look(EYE, FORWARD, (0.0, 1.0, 0.0), width=width, height=height,
                       fov_x_deg=fov_x, jitter=1.0, device=device)


def smallpt_scene(*, width: int = 1024, height: int = 768,
                  device="cpu") -> Tuple[ScenePack, Camera]:
    """smallpt's scene and camera."""
    return (scene_pack_from_model(smallpt_model(), device=device),
            smallpt_camera(width, height, device=device))
