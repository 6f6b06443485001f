"""Scatter-add of per-ray row cotangents into the triangle row table.

The counterpart of ``scatter_rows`` in
``montecarlopathtracer_tpu/ops/intersect_pallas.py`` (Pallas kernel
``_scatter_rows_kernel``): ``zeros(T, 48).at[idx].add(dvals.T)``, where
ray ``r`` adds its 48 row cotangents ``dvals[:, r]`` into row
``idx[r]`` and a ray with ``idx = −1`` adds nothing. It carries the
gradient of a segment from the rays back to the table of
:func:`.segment_fused.pack_rows_full`.

- :func:`scatter_rows` is the entry point: CUDA tensors launch
  ``csrc/scatter_rows.cu`` and add one to ``scatter_rows.launches``;
  CPU tensors run :func:`scatter_rows_ref`.
- :func:`scatter_rows_ref` is the plain-torch version, an exact f32
  ``index_add_``.

The TPU kernel's bf16 term split, one-hot matmul and 16k cap on T are
TPU-only and are not ported: the kernel adds with atomics and takes any
T, in f32 into a private table in shared memory when the [T, 48] table
fits there, and in f64 into a global table otherwise (long chains of f32
atomics into one row lose too much). Atomics add in no fixed order, so
the kernel's sums differ from the plain version's in the last bits, and
from run to run.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

_P = ctypes.c_void_p


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
    # idx, dvals, R, T, out, wide, stream
    fn.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P]
    return lib


def _scatter_rows_cuda(idx, dvals, T):
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
    if T * 48 * 4 <= torch.cuda.get_device_properties(dev).shared_memory_per_block_optin:
        out, wide = torch.zeros(T, 48, dtype=torch.float32, device=dev), None
    else:
        out = torch.empty(T, 48, dtype=torch.float32, device=dev)
        wide = torch.zeros(T, 48, dtype=torch.float64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scatter_rows_launch(idx.data_ptr(), dvals.data_ptr(), R, T, out.data_ptr(),
                                      None if wide is None else wide.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows kernel launch failed: cudaError {err}")
    scatter_rows.launches += 1
    return out


def scatter_rows(idx: torch.Tensor, dvals: torch.Tensor, T: int) -> torch.Tensor:
    """``zeros(T, 48).at[idx].add(dvals.T)`` with ``idx = −1`` skipped
    (see the module docstring)."""
    if dvals.device.type == "cuda":
        return _scatter_rows_cuda(idx, dvals, int(T))
    if dvals.device.type == "cpu":
        return scatter_rows_ref(idx, dvals, int(T))
    raise ValueError(f"no scatter_rows kernel for device {dvals.device}")


scatter_rows.launches = 0
