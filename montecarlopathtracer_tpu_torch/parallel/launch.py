"""Start the ranks of a sharded run as local processes.

:func:`run_ranks` spawns ``world`` processes (the ``spawn`` start method,
never ``fork``), joins them in one process group on a ``file://`` store
in a temporary directory, calls ``fn(*args)`` on every rank and returns
the ranks' results in rank order. Each rank gets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` in its environment and one torch
thread on the CPU, so that several ranks (and several test workers) do
not oversubscribe the host's cores (ROADMAP C16).

``fn`` and ``args`` are pickled: ``fn`` is a module-level function, and
every child imports its module, so that module must not import JAX
(nor must anything it imports). A rank's result may hold tensors; they
come back as numpy arrays.

On the card each rank drives ``cuda:(LOCAL_RANK % device_count)``; the
backend defaults to NCCL there, and two ranks on one card need
``backend="gloo"``. Build the CUDA kernels in the parent before calling
this (:func:`..ops.cuda_build.build_all`), so that no two ranks compile
at once.

The parent waits at most ``timeout`` seconds. The first rank that fails
ends the run: the others (which may be waiting in a collective for it)
are terminated, and the error names the rank.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from . import distributed


def to_host(x):
    """``x`` with every tensor in it (in dicts, lists, tuples) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def _rank_main(rank, world, fn, args, backend, device, store, timeout, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        distributed.ensure_initialized(device=device, backend=backend,
                                       init_method=f"file://{store}", world_size=world,
                                       rank=rank, timeout=timeout)
        results.put((rank, True, to_host(fn(*args))))
    except Exception:  # reported to the parent, which ends the run
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), *, backend=None, device="cuda",
              timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world`` ranks; returns their results in
    rank order. ``device`` is ``"cuda"`` (the default; raises without a
    card) or ``"cpu"``; ``backend`` defaults to NCCL on the card, gloo
    on the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks: no CUDA device is available; pass device='cpu'")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world, fn, tuple(args), backend, str(device), store, timeout, results))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = [r for r in range(world) if r not in out]
                    raise TimeoutError(f"run_ranks: ranks {missing} did not finish within "
                                       f"{timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    # A rank that exits 0 has sent its message; a crash has not.
                    for r, p in enumerate(procs):
                        if r not in out and p.exitcode not in (None, 0):
                            raise RuntimeError(f"run_ranks: rank {r} exited with code "
                                               f"{p.exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} of {world} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10.0)
    return [out[r] for r in range(world)]
