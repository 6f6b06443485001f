"""Scatter-add of per-ray row cotangents into the triangle row table.

The counterpart of ``scatter_rows`` in
``montecarlopathtracer_tpu/ops/intersect_pallas.py`` (Pallas kernel
``_scatter_rows_kernel``): ``zeros(T, 48).at[idx].add(dvals.T)``, where
ray ``r`` adds its 48 row cotangents ``dvals[:, r]`` into row
``idx[r]`` and a ray with ``idx = −1`` adds nothing. It carries the
gradient of a segment from the rays back to the table of
:func:`.segment_fused.pack_rows_full`.

- :func:`scatter_rows` is the entry point: CUDA tensors launch
  ``csrc/scatter_rows.cu`` and count the launch as B3 (and as B3s when
  the small-table path served it); CPU tensors run :func:`scatter_rows_ref`.
- :func:`scatter_rows_ref` is the plain-torch version, an exact f32
  ``index_add_``.

The TPU kernel's bf16 term split, one-hot matmul and 16k cap on T are
TPU-only and are not ported. The kernel takes one of two paths, chosen
from T alone (:func:`small_path`): up to :data:`T_SMALL` rows each warp
bins its rays by row straight from the staged cotangents and the blocks'
partial tables are summed by a second kernel; above it, the rays are
grouped by row with a counting sort of ``idx`` written by hand and each
row's rays summed in a fixed order (see the source). Either way no
atomics touch the table, every entry is written once, and two calls on
the same inputs give bit-equal tables, as the TPU kernel's do. Its sums
differ from the plain version's in the last bits (``index_add_`` on a
CUDA tensor adds with atomics in no fixed order).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import count_launch
from . import cuda_build

_P = ctypes.c_void_p

T_SMALL = 128
"""The largest table the small-table path takes: its limit, the bins of
four warps in 227 KB of shared memory (``csrc/scatter_rows.cu``), and
faster than the sort path up to there. Device ms a call on an H100
(700 W) at R = 480,000, the same cotangents of an 800x600 segment of the
published Cornell box through both paths: T = 32 0.0409 against 0.1098,
its rows spread over T = 64 0.0472 against 0.1170, over T = 128 0.0610
against 0.1217."""

SMALL_GRID = 132
"""Blocks of the small path's first kernel: one on each SM of an H100."""

_CHUNK = 32  # rays a warp of the small path stages at a time


def small_path(T: int) -> bool:
    """Whether a table of ``T`` rows takes the small-table path."""
    return T <= T_SMALL


def small_grid(R: int) -> int:
    """The small path's blocks for ``R`` rays: :data:`SMALL_GRID`, or one
    a 32-ray chunk where there are fewer chunks (at least one)."""
    return max(1, min(SMALL_GRID, -(-R // _CHUNK)))


def small_workspace(R: int, T: int) -> int:
    """Bytes of the small path's workspace: each block's partial table,
    ``T × 48`` doubles."""
    return small_grid(R) * T * 48 * 8


def scatter_rows_ref(idx: torch.Tensor, dvals: torch.Tensor, T: int) -> torch.Tensor:
    """Plain-torch scatter: idx i32[R], dvals f32[48, R] → f32[T, 48]."""
    keep = (idx >= 0)[:, None]
    out = torch.zeros(T, 48, dtype=dvals.dtype, device=dvals.device)
    return out.index_add_(0, idx.clamp_min(0).long(), torch.where(keep, dvals.T, 0.0))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("scatter_rows")
    fn = lib.scatter_rows_launch
    fn.restype = ctypes.c_int
    # idx, dvals, R, T, out, work, stream
    fn.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P]
    ws = lib.scatter_rows_workspace
    ws.restype = ctypes.c_size_t
    ws.argtypes = [ctypes.c_int, ctypes.c_int]
    small = lib.scatter_rows_small_launch
    small.restype = ctypes.c_int
    # idx, dvals, R, T, out, work, blocks, stream
    small.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int, _P]
    lib.scatter_rows_small_init.restype = ctypes.c_int
    lib.scatter_rows_small_init.argtypes = []
    return lib


@functools.cache
def _small_ready(index: int) -> None:
    """Let the small path's first kernel take its shared memory on device
    ``index`` (once a device, at its first small call, which is eager:
    a CUDA graph captures the calls after it)."""
    with torch.cuda.device(index):
        err = _lib().scatter_rows_small_init()
    if err != 0:
        raise RuntimeError(f"scatter_rows small path set-up failed: cudaError {err}")


def _scatter_rows_cuda(idx, dvals, T, small):
    """The kernel on CUDA tensors, the small-table path if ``small``
    (T ≤ 128), else the sort path."""
    dev = dvals.device
    if idx.device != dev:
        raise ValueError(f"idx must be on {dev}, got {idx.device}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if dvals.dtype != torch.float32:
        raise TypeError(f"dvals must be float32, got {dvals.dtype}")
    if not (idx.is_contiguous() and dvals.is_contiguous()):
        raise ValueError("idx and dvals must be contiguous")
    R = idx.shape[0]
    if idx.dim() != 1 or tuple(dvals.shape) != (48, R):
        raise ValueError(f"need idx [R] and dvals [48, R], got {tuple(idx.shape)} "
                         f"and {tuple(dvals.shape)}")
    if not 0 < T < 2**31 // 48 or R >= 2**31:
        raise ValueError(f"T = {T} and R = {R} out of range")
    lib = _lib()
    if small:
        _small_ready(dev.index)
    # Every entry of `out` is written by the kernel; the workspace (sort
    # buffers, counts, partials) needs no zeroing either.
    out = torch.empty(T, 48, dtype=torch.float32, device=dev)
    size = small_workspace(R, T) if small else lib.scatter_rows_workspace(R, T)
    work = torch.empty(size, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if small:
            err = lib.scatter_rows_small_launch(idx.data_ptr(), dvals.data_ptr(), R, T,
                                                out.data_ptr(), work.data_ptr(), small_grid(R),
                                                stream)
        else:
            err = lib.scatter_rows_launch(idx.data_ptr(), dvals.data_ptr(), R, T,
                                          out.data_ptr(), work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows kernel launch failed: cudaError {err}")
    count_launch("B3")
    if small:
        count_launch("B3s")
    return out


def scatter_rows(idx: torch.Tensor, dvals: torch.Tensor, T: int) -> torch.Tensor:
    """``zeros(T, 48).at[idx].add(dvals.T)`` with ``idx = −1`` skipped
    (see the module docstring)."""
    if dvals.device.type == "cuda":
        return _scatter_rows_cuda(idx, dvals, int(T), small_path(int(T)))
    if dvals.device.type == "cpu":
        return scatter_rows_ref(idx, dvals, int(T))
    raise ValueError(f"no scatter_rows kernel for device {dvals.device}")
