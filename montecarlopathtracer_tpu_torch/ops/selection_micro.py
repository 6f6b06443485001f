"""Selection-step microkernels (the roofline probes of the JAX
package's ``tools/kernel_micro.py``), each with its plain version.

- :func:`selection_micro` (B12, TPU kernel ``make`` with the bodies
  ``body_v3``, ``body_matmul_only`` and ``body_matmul_bf16``): per ray,
  the contraction p = wsᵀ·rays of ``ws`` bf16[48, 6T] (chunk-major: the
  six components of triangle j at columns ``(j // tc)·6tc + k·tc + j %
  tc``) with ``rays`` bf16[48, R], each product exact in f32 and summed in
  f32 over the 48 rows in order; then ``variant``:

  - ``"full"``: the accept chain of the streamed selection kernel on
    (o'_x, o'_y, q = −o'_z, d'_x, d'_y, w = d'_z) with an IEEE reciprocal:
    t = q·(1/w), β = o'_x + t·d'_x, γ = o'_y + t·d'_y, accepted iff β, γ,
    t and 1 − (β + γ) are all > 0; the least (t, j) accepted, −1 if none;
  - ``"matmul_only"``: int32 (toward zero) of the least p;
  - ``"matmul_bf16"``: the same with every p rounded to bf16 first.

- :func:`epilogue_only` (B13, ``make_epilogue_only``): the accept chain
  on ``p_all`` f32[6T, R] laid out as p above (rows) by rays (columns).
- :func:`epilogue_shared` (B14, ``make_epilogue_shared``): the accept
  chain on one block ``p_blk`` f32[6·tc, Rt] that every (ray tile,
  chunk) step reuses: triangle j of ray r reads row ``k·tc + j % tc``,
  column ``r % Rt``. Its kernel stages a slice of the block's columns
  at a time through shared memory, chunk by chunk; it still runs the
  chain on every one of the R × T pairs.

They stay in bf16, as the TPU kernels do: they measure a bf16-input
contraction and are not the renderer's selection, which runs in f32.
For CUDA tensors each launches ``csrc/selection_micro.cu`` and counts
the launch (as ``B12 <variant>``, B13, B14); for CPU tensors it runs the
plain version. B13's and B14's plain versions round as their kernel
does, so the two agree bit for bit. B12's kernel sums p
on the bf16 tensor cores, in their order and rounding, where the plain
version sums the 48 rows in order: the two are held together by
``testing.compare_micro``'s rounding rule.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import count_launch
from . import cuda_build

VARIANTS = ("full", "matmul_only", "matmul_bf16")
K = 48  # contraction depth: the split-bf16 packing's 6 × 8
_BIG = 3.0e38
_IMAX = 2**31 - 1
_REF_ELEMS = 1 << 24  # bound on the plain versions' [6·tc, rays] intermediates
_P = ctypes.c_void_p


def _chain(opx, opy, q, dpx, dpy, w):
    """t where the accept chain accepts, else 3e38 (elementwise)."""
    t = q * (1.0 / w)
    beta = opx + t * dpx
    gamma = opy + t * dpy
    ok = (beta > 0.0) & (gamma > 0.0) & (t > 0.0) & (1.0 - (beta + gamma) > 0.0)
    return torch.where(ok, t, _BIG)


def _select_chunks(blocks, T, tc, R, device):
    """The least (t, j) over chunks; ``blocks(c, s, e)`` returns the six
    f32 [tc, e − s] component rows of chunk c for rays s..e − 1."""
    out = torch.empty(R, dtype=torch.int32, device=device)
    step = max(1, _REF_ELEMS // (6 * tc))
    col = torch.arange(tc, device=device)[:, None]
    for s in range(0, R, step):
        e = min(R, s + step)
        bt = torch.full((e - s,), _BIG, device=device)
        bi = torch.full((e - s,), _IMAX, dtype=torch.int64, device=device)
        for c in range(T // tc):
            tm = _chain(*blocks(c, s, e))
            c_min = tm.amin(dim=0)
            c_idx = torch.where(tm <= c_min[None, :], col, _IMAX).amin(dim=0) + c * tc
            better = c_min < bt
            bt = torch.where(better, c_min, bt)
            bi = torch.where(better, c_idx, bi)
        out[s:e] = torch.where(bt < _BIG, bi, -1).to(torch.int32)
    return out


def _contract(ws_c, x):
    """p f32[6·tc, r] = ws_cᵀ·x over the 48 rows, in row order."""
    wf, xf = ws_c.float(), x.float()
    p = wf[0][:, None] * xf[0][None, :]
    for k in range(1, K):
        p = p + wf[k][:, None] * xf[k][None, :]
    return p


def _check_micro(ws, rays, t_chunk, variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    for name, x in (("ws", ws), ("rays", rays)):
        if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[0] != K:
            raise ValueError(f"{name} must be bf16 [{K}, n], got {x.dtype} {tuple(x.shape)}")
    T6 = ws.shape[1]
    if t_chunk <= 0 or T6 % (6 * t_chunk):
        raise ValueError(f"ws has {T6} columns: not 6 x T with T a multiple of {t_chunk}")
    return T6 // 6


def selection_micro_ref(ws, rays, t_chunk: int = 256, variant: str = "full"):
    """Plain version of :func:`selection_micro`: i32[R]."""
    T = _check_micro(ws, rays, t_chunk, variant)
    tc, R = t_chunk, rays.shape[1]
    if variant == "full":
        def blocks(c, s, e):
            p = _contract(ws[:, c * 6 * tc:(c + 1) * 6 * tc], rays[:, s:e])
            return p.reshape(6, tc, e - s).unbind(0)

        return _select_chunks(blocks, T, tc, R, rays.device)
    out = torch.empty(R, dtype=torch.int32, device=rays.device)
    step = max(1, _REF_ELEMS // (6 * tc))
    for s in range(0, R, step):
        low = torch.full((min(R, s + step) - s,), torch.inf, device=rays.device)
        for c in range(T // tc):
            p = _contract(ws[:, c * 6 * tc:(c + 1) * 6 * tc], rays[:, s:s + step])
            if variant == "matmul_bf16":
                p = p.to(torch.bfloat16).float()
            low = torch.minimum(low, p.amin(dim=0))
        out[s:s + step] = low.to(torch.int32)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("selection_micro")
    lib.selection_micro_launch.restype = ctypes.c_int
    # variant, ws, rays, T, tc, R, out, stream
    lib.selection_micro_launch.argtypes = [ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, _P, _P]
    lib.selection_epilogue_launch.restype = ctypes.c_int
    # p, T, tc, R, out, stream
    lib.selection_epilogue_launch.argtypes = [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                              _P, _P]
    lib.selection_epilogue_shared_launch.restype = ctypes.c_int
    # p, T, tc, R, ld, out, stream
    lib.selection_epilogue_shared_launch.argtypes = [_P, ctypes.c_int, ctypes.c_int,
                                                     ctypes.c_int, ctypes.c_int, _P, _P]
    return lib


def _check_card(dev, *xs):
    for x in xs:
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"inputs must be contiguous tensors on {dev}")


def selection_micro(ws, rays, t_chunk: int = 256, variant: str = "full"):
    """B12: i32[R] as the module docstring says, for ``ws`` bf16[48, 6T]
    and ``rays`` bf16[48, R] (T a multiple of ``t_chunk``)."""
    if rays.device.type == "cpu":
        return selection_micro_ref(ws, rays, t_chunk, variant)
    if rays.device.type != "cuda":
        raise ValueError(f"no selection_micro kernel for device {rays.device}")
    T = _check_micro(ws, rays, t_chunk, variant)
    dev, R = rays.device, rays.shape[1]
    _check_card(dev, ws, rays)
    if 6 * T * K >= 2**31 or R * K >= 2**31:
        raise ValueError("ws and rays must hold fewer than 2^31 values")
    if t_chunk % 8 or ws.data_ptr() % 16:
        raise ValueError("the kernel stages ws in 16-byte pieces: t_chunk must be a multiple "
                         "of 8 and ws 16-byte aligned")
    out = torch.empty(R, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().selection_micro_launch(VARIANTS.index(variant), ws.data_ptr(),
                                            rays.data_ptr(), T, t_chunk, R, out.data_ptr(),
                                            stream)
    if err != 0:
        raise RuntimeError(f"selection_micro kernel launch failed: cudaError {err}")
    count_launch(f"B12 {variant}")
    return out


def _epilogue_ref(p, T, tc, R, shared):
    def blocks(c, s, e):
        if shared:
            cols = torch.arange(s, e, device=p.device) % p.shape[1]
            blk = p[:, cols]
        else:
            blk = p[c * 6 * tc:(c + 1) * 6 * tc, s:e]
        return blk.reshape(6, tc, e - s).unbind(0)

    return _select_chunks(blocks, T, tc, R, p.device)


def _epilogue(p, T, tc, R, shared):
    """The kernel (or, for a CPU tensor, the plain version) of B13, or of
    B14 with ``shared``, counting each launch."""
    if p.dtype != torch.float32 or p.dim() != 2:
        raise ValueError(f"p must be a float32 matrix, got {p.dtype} {tuple(p.shape)}")
    if p.device.type == "cpu":
        return _epilogue_ref(p, T, tc, R, shared)
    if p.device.type != "cuda":
        raise ValueError(f"no selection epilogue kernel for device {p.device}")
    _check_card(p.device, p)
    ld = p.shape[1]
    if shared and (ld % 4 or p.data_ptr() % 16 or ld >= 1 << 21):
        raise ValueError("the kernel stages p_blk in 16-byte pieces: its width must be a "
                         "multiple of 4 below 2^21 and p_blk 16-byte aligned")
    out = torch.empty(R, dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        if shared:
            err = _lib().selection_epilogue_shared_launch(p.data_ptr(), T, tc, R, ld,
                                                          out.data_ptr(), stream)
        else:
            err = _lib().selection_epilogue_launch(p.data_ptr(), T, tc, R, out.data_ptr(),
                                                   stream)
    if err != 0:
        raise RuntimeError(f"selection epilogue kernel launch failed: cudaError {err}")
    count_launch("B14" if shared else "B13")
    return out


def epilogue_only(p_all, t_chunk: int = 256):
    """B13: the accept chain on ``p_all`` f32[6T, R]; i32[R]."""
    if p_all.shape[0] % (6 * t_chunk):
        raise ValueError(f"p_all has {p_all.shape[0]} rows: not 6 x T with T a multiple of "
                         f"{t_chunk}")
    return _epilogue(p_all, p_all.shape[0] // 6, t_chunk, p_all.shape[1], False)


def epilogue_only_ref(p_all, t_chunk: int = 256):
    """Plain version of :func:`epilogue_only`."""
    return _epilogue_ref(p_all, p_all.shape[0] // 6, t_chunk, p_all.shape[1], False)


def epilogue_shared(p_blk, T: int, R: int):
    """B14: the accept chain on the one block ``p_blk`` f32[6·tc, Rt]
    for R rays over T triangles (T a multiple of tc); i32[R]. The kernel
    stages ``p_blk`` through shared memory in 16-byte pieces, so on the
    card Rt must be a multiple of 4 and ``p_blk`` 16-byte aligned."""
    tc = p_blk.shape[0] // 6
    if p_blk.shape[0] % 6 or tc == 0 or T % tc:
        raise ValueError(f"p_blk {tuple(p_blk.shape)} and T {T} do not make chunks")
    return _epilogue(p_blk, T, tc, R, True)


def epilogue_shared_ref(p_blk, T: int, R: int):
    """Plain version of :func:`epilogue_shared`."""
    return _epilogue_ref(p_blk, T, p_blk.shape[0] // 6, R, True)
