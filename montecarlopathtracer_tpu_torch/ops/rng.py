"""Counter-based random streams, bit-equal to JAX's threefry on the CPU.

The counterpart of ``montecarlopathtracer_tpu/ops/rng.py``. Every
uniform is a pure function of (key, stream id, lane), so the same key
replays the same paths and no generator state exists anywhere.

A key is a pair of unsigned 32-bit Python ints, exactly the two words
of a JAX threefry key. :func:`make_key` and :func:`fold_in` run on the
host (one threefry block each). :func:`stream_uniforms` draws up to
:data:`MAX_STREAMS` streams of a key at once: for a CUDA device it
launches ``csrc/rng.cu`` once (adding one to
``stream_uniforms.launches``), for the CPU it runs
:func:`stream_uniforms_ref`, the per-lane threefry on int64 tensors
masked to 32 bits; it never falls back from one to the other. Both give
the same bits, bit-equal to
``jax.random.uniform(jax.random.fold_in(key, stream_id), shape)`` with
``jax_threefry_partitionable`` on (the JAX default).
:func:`stream_uniform` is its one-stream row.

The JAX package draws with the ``rbg`` generator on a TPU; this package
uses threefry everywhere, so its renders match the JAX package's CPU
renders.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import cuda_build

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
MAX_STREAMS = 4  # streams per call of the kernel (csrc/rng.cu's kMaxStreams)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32_int(key: Key, x0: int, x1: int) -> Key:
    """Threefry-2x32 (20 rounds) of one counter pair, on Python ints."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def make_key(seed: int) -> Key:
    """Key of ``jax.random.key(seed)`` for a non-negative 32-bit seed."""
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return (0, int(seed))


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a 32-bit unsigned ``data``."""
    return _threefry2x32_int(key, 0, int(data) & _M32)


def _threefry2x32_lanes(key: Key, x1: torch.Tensor) -> torch.Tensor:
    """Threefry-2x32 over lanes with counter words (0, x1); returns the
    32-bit xor of the two output words as int64."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = torch.full_like(x1, ks[0])
    x1 = (x1 + ks[1]).bitwise_and_(_M32)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            x1 = (x1 << r).bitwise_or_(x1 >> (32 - r)).bitwise_and_(_M32)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0.bitwise_xor_(x1)


def random_bits(key: Key, n: int, device) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as int64 in [0, 2**32)."""
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    return _threefry2x32_lanes(key, lanes)


def uniform(key: Key, n: int, device) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32)``: 23 random mantissa
    bits under exponent 0, minus one."""
    bits = random_bits(key, n, device)
    mant = (bits >> 9).bitwise_or_(0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def stream_uniforms_ref(key: Key, stream_ids: Sequence[int], n: int, device) -> torch.Tensor:
    """Plain version of :func:`stream_uniforms`: one :func:`uniform` per
    stream, f32[k, n]."""
    return torch.stack([uniform(fold_in(key, s), n, device) for s in stream_ids])


class _StreamKeys(ctypes.Structure):
    """csrc/rng.cu's ``StreamKeys``: the folded keys, passed by value."""

    _fields_ = [("k0", ctypes.c_uint32 * MAX_STREAMS), ("k1", ctypes.c_uint32 * MAX_STREAMS)]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("rng")
    fn = lib.uniform_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [_StreamKeys, ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p,
                   ctypes.c_void_p]  # keys, k, n, out, stream
    return lib


def _uniforms_cuda(key: Key, stream_ids, n: int, dev: torch.device) -> torch.Tensor:
    keys = _StreamKeys()
    for s, sid in enumerate(stream_ids):
        keys.k0[s], keys.k1[s] = fold_in(key, sid)
    out = torch.empty(len(stream_ids), n, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.uniform_launch(keys, len(stream_ids), n, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"uniform kernel launch failed: cudaError {err}")
    stream_uniforms.launches += 1
    return out


def stream_uniforms(key: Key, stream_ids: Sequence[int], n: int, device) -> torch.Tensor:
    """Uniform [0, 1) draws f32[k, n] of the k = len(stream_ids) <=
    :data:`MAX_STREAMS` given streams of ``key``, a contiguous row per
    stream (so each row is a contiguous f32[n]). For a CUDA ``device``
    one launch of ``csrc/rng.cu`` (adding one to
    ``stream_uniforms.launches``); :func:`stream_uniforms_ref` for the
    CPU. Raises on k outside 1..4 and on n >= 2**32 (the lane counter is
    32 bits)."""
    stream_ids = [int(s) & _M32 for s in stream_ids]
    if not 1 <= len(stream_ids) <= MAX_STREAMS:
        raise ValueError(f"draw 1 to {MAX_STREAMS} streams at once, got {len(stream_ids)}")
    if not 0 <= n < 2**32:
        raise ValueError(f"n must be in [0, 2**32), got {n}")
    dev = torch.device(device)
    if dev.type == "cuda":
        return _uniforms_cuda(key, stream_ids, n, dev)
    if dev.type == "cpu":
        return stream_uniforms_ref(key, stream_ids, n, dev)
    raise ValueError(f"no uniform kernel for device {dev}")


stream_uniforms.launches = 0


def stream_uniform(key: Key, stream_id: int, n: int, device) -> torch.Tensor:
    """Uniform [0, 1) f32[n] draws for the given stream of ``key``: the
    one row of :func:`stream_uniforms`."""
    return stream_uniforms(key, (stream_id,), n, device)[0]
