"""Sharded rendering on ``torch.distributed``: one process per rank over a
(rays × spp) mesh (:mod:`.mesh`, :mod:`.sharded`), started by torchrun or
:func:`.launch.run_ranks`."""

from .mesh import RAYS_AXIS, SPP_AXIS, Mesh, make_mesh
from .sharded import (
    film_band,
    gather_film,
    make_geom_train_step,
    make_progressive_step,
    make_train_step,
    sharded_regen_pass,
    sharded_sample_pass,
)

__all__ = [
    "make_mesh",
    "Mesh",
    "RAYS_AXIS",
    "SPP_AXIS",
    "sharded_sample_pass",
    "sharded_regen_pass",
    "make_progressive_step",
    "make_train_step",
    "make_geom_train_step",
    "film_band",
    "gather_film",
]
