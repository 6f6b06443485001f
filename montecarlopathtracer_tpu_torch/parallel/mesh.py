"""The (rays × spp) mesh of ranks for sharded rendering.

The counterpart of ``montecarlopathtracer_tpu/parallel/mesh.py``, with
its axes:

- ``"rays"``: the film's rows are split; rank row ``ri`` owns a
  horizontal band of the image;
- ``"spp"``: the sample batch is split; the ranks of one band sum their
  partial films over this axis.

The JAX mesh reshapes the devices as ``(n_rays, n_spp)``, so rank ``r``
sits at ``ri = r // n_spp``, ``si = r % n_spp`` here too: the random
keys depend on that place. A :class:`Mesh` is one rank's view of the
grid: its place, its device, and the two process groups it sums over,
the spp group (ranks ``ri·n_spp + s``) and the rays group (ranks
``i·n_spp + si``). The scene is replicated on every rank.

A single process with no process group is a 1×1 mesh whose sums do
nothing, as JAX's single-device mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from . import distributed

RAYS_AXIS = "rays"
SPP_AXIS = "spp"
ALL_AXES = (RAYS_AXIS, SPP_AXIS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's place in a ``n_rays × n_spp`` grid of ranks."""

    n_rays: int
    n_spp: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None  # None: no process group, and no collective
    spp_group: Optional[dist.ProcessGroup] = None  # ranks ri * n_spp + s
    rays_group: Optional[dist.ProcessGroup] = None  # ranks i * n_spp + si

    @property
    def ri(self) -> int:
        """This rank's row on the rays axis."""
        return self.rank // self.n_spp

    @property
    def si(self) -> int:
        """This rank's column on the spp axis."""
        return self.rank % self.n_spp

    @property
    def size(self) -> int:
        return self.n_rays * self.n_spp

    def psum(self, x: torch.Tensor, axes: Union[str, Tuple[str, ...]]) -> torch.Tensor:
        """Sum of ``x`` over the ranks of ``axes`` (one axis name, or
        :data:`ALL_AXES`), every rank getting the sum, as
        ``jax.lax.psum``; the identity without a process group. An
        all-reduce: in place when ``x`` takes no gradient. Under autograd
        its backward passes the cotangent through unchanged: each rank
        backpropagates its own loss term, and the parameter gradients are
        summed over the ranks afterwards (:mod:`.sharded`)."""
        if axes == RAYS_AXIS:
            group = self.rays_group
        elif axes == SPP_AXIS:
            group = self.spp_group
        elif axes == ALL_AXES:
            group = None  # the whole process group
        else:
            raise ValueError(f"unknown mesh axes {axes!r}")
        if self.backend is None:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _SumOver.apply(x, group)
        dist.all_reduce(x, group=group)
        return x


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) with an identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def make_mesh(
    n_rays_shards: Optional[int] = None,
    n_spp_shards: Optional[int] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
) -> Mesh:
    """This rank's view of a (rays × spp) mesh over every rank of the
    process group (:func:`.distributed.ensure_initialized` joins it
    first, from torchrun's environment; without one the world is this
    process alone).

    Defaults: all ranks on the rays axis. The product of the two shard
    counts must equal the world size. Every rank must call this with the
    same counts, in the same order as its other calls that make process
    groups: each call makes every group of the grid on every rank. On
    the card the rank drives ``cuda:(LOCAL_RANK % device_count)``
    (:func:`.distributed.rank_device`); the default device is the card,
    and this raises without one."""
    dev = distributed.rank_device(device)
    distributed.ensure_initialized(device=dev, backend=backend)
    if dist.is_initialized():
        n, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    else:
        n, rank, backend = 1, 0, None
    if n_rays_shards is None and n_spp_shards is None:
        n_rays_shards, n_spp_shards = n, 1
    elif n_rays_shards is None:
        n_rays_shards = n // n_spp_shards
    elif n_spp_shards is None:
        n_spp_shards = n // n_rays_shards
    if n_rays_shards * n_spp_shards != n:
        raise ValueError(f"mesh {n_rays_shards}x{n_spp_shards} != {n} ranks")
    spp_group = rays_group = None
    if backend is not None:
        # Every rank makes every group, in the same order.
        for ri in range(n_rays_shards):
            g = dist.new_group([ri * n_spp_shards + s for s in range(n_spp_shards)])
            if rank // n_spp_shards == ri:
                spp_group = g
        for si in range(n_spp_shards):
            g = dist.new_group([i * n_spp_shards + si for i in range(n_rays_shards)])
            if rank % n_spp_shards == si:
                rays_group = g
    return Mesh(n_rays_shards, n_spp_shards, rank, dev, backend, spp_group, rays_group)
