"""Process-group bootstrap for the sharded renderer.

The counterpart of ``montecarlopathtracer_tpu/parallel/distributed.py``.
The JAX package runs one program over every device of a slice; here one
process runs per rank and drives one device, and the ranks meet in a
``torch.distributed`` process group. Start them with ``torchrun``
(which sets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``
and ``LOCAL_RANK``), with ``torch.multiprocessing.spawn``, or with
:func:`.launch.run_ranks`::

    from montecarlopathtracer_tpu_torch.parallel import distributed, make_mesh
    distributed.ensure_initialized()   # no-op in a single process
    mesh = make_mesh()                 # every rank on the rays axis

The backend is NCCL on the card and gloo on the CPU unless the caller
names one. NCCL refuses two ranks on one device, so two ranks that share
a card take ``backend="gloo"`` (gloo all-reduces CUDA tensors too).
Nothing here falls back: a rank that asks for the card and finds none
raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def rank_device(device="cuda") -> torch.device:
    """The device this rank drives: for ``"cuda"`` without an index,
    ``cuda:(LOCAL_RANK % device_count)``; raises when a CUDA device is
    asked for and none is available."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "sharded paths on the CPU")
    if dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def ensure_initialized(
    *,
    device="cuda",
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout: Optional[float] = None,
) -> bool:
    """Join this process's process group when it runs as one of several
    ranks; returns True if a process group exists afterwards.

    Without ``init_method``, the group is set up from torchrun's
    environment (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``); a process with neither ``init_method`` nor
    ``RANK`` and ``WORLD_SIZE`` in its environment is a single process,
    and nothing is done. ``timeout`` (seconds) bounds every collective.
    On the card, the rank's device (:func:`rank_device`) becomes the
    current device first."""
    if dist.is_initialized():
        return True
    if init_method is None and not ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return False
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kw)
    return True


def process_info() -> dict:
    """Topology summary for logs, with the JAX function's keys: each
    process drives one device, so it has one local device and the world
    has as many devices as ranks."""
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1, "local_devices": 1,
                "global_devices": 1}
    world = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": world, "local_devices": 1,
            "global_devices": world}
