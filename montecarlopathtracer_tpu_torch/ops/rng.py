"""Counter-based random streams, bit-equal to JAX's threefry on the CPU.

The counterpart of ``montecarlopathtracer_tpu/ops/rng.py``. Every
uniform is a pure function of (key, stream id, lane), so the same key
replays the same paths and no generator state exists anywhere.

A key is a pair of unsigned 32-bit Python ints, exactly the two words
of a JAX threefry key. :func:`make_key` and :func:`fold_in` run on the
host (one threefry block each). :func:`stream_uniforms` draws up to
:data:`MAX_STREAMS` streams of a key at once: for a CUDA device it
launches ``csrc/rng.cu`` once (counted as RNG), for the CPU it runs
:func:`stream_uniforms_ref`, the per-lane threefry on int64 tensors
masked to 32 bits; it never falls back from one to the other. Both give
the same bits, bit-equal to
``jax.random.uniform(jax.random.fold_in(key, stream_id), shape)`` with
``jax_threefry_partitionable`` on (the JAX default).
:func:`stream_uniform` is its one-stream row.

A :class:`DeviceKey` is a key whose words live in a tensor on the
device, with host words folded into it (:func:`fold_in` appends them);
:func:`stream_uniforms` draws the same bits from it (on a CUDA device,
``csrc/rng.cu`` reads the words there and folds them on the card). A CUDA graph
that holds such draws draws under whatever key the tensor holds when it
replays (``diff/grad.py``'s graphed steps).

The JAX package draws with the ``rbg`` generator on a TPU; this package
uses threefry everywhere, so its renders match the JAX package's CPU
renders.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple, Union

import torch

from ..utils.profiling import count_launch, in_primal
from . import cuda_build

_M32 = 0xFFFFFFFF
MAX_STREAMS = 4  # streams per call of the kernel (csrc/rng.cu's kMaxStreams)
MAX_FOLDS = 3  # host words folded into a device key by one call (csrc/rng.cu's kMaxFolds)


@dataclasses.dataclass(frozen=True)
class DeviceKey:
    """A key on a device: ``base`` i32[2] holds its two words (as signed
    32-bit), ``folds`` the host words folded into it since, in order."""

    base: torch.Tensor
    folds: Tuple[int, ...] = ()

    @classmethod
    def stage(cls, key: Tuple[int, int], out: torch.Tensor) -> "DeviceKey":
        """``key``'s words written into ``out`` (i32[2], contiguous, on
        any device) without waiting for the device: one fill of the pair
        as an int64 (the low word first), its value passed by value, so
        nothing is copied from the host."""
        packed = key[0] | (key[1] << 32)
        out.view(torch.int64).fill_(packed - (1 << 64) if packed >> 63 else packed)
        return cls(out)

    def host(self) -> Tuple[int, int]:
        """The key's words on the host (a read of ``base``: it waits for
        the device)."""
        key = tuple(int(w) & _M32 for w in self.base.tolist())
        for d in self.folds:
            key = fold_in(key, d)
        return key


Key = Union[Tuple[int, int], DeviceKey]
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
    """``jax.random.fold_in(key, data)`` for a 32-bit unsigned ``data``;
    for a :class:`DeviceKey`, the same key with ``data`` appended to its
    folds (nothing runs on the device)."""
    if isinstance(key, DeviceKey):
        return dataclasses.replace(key, folds=key.folds + (int(data) & _M32,))
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
    if isinstance(key, DeviceKey):
        key = key.host()
    return torch.stack([uniform(fold_in(key, s), n, device) for s in stream_ids])


class _Draw(ctypes.Structure):
    """csrc/rng.cu's ``Draw``: a call's keys, passed by value (each
    stream's folded key for a host key; for a :class:`DeviceKey`, its
    folds and the streams' ids)."""

    _fields_ = [("k0", ctypes.c_uint32 * MAX_STREAMS), ("k1", ctypes.c_uint32 * MAX_STREAMS),
                ("fold", ctypes.c_uint32 * MAX_FOLDS), ("stream", ctypes.c_uint32 * MAX_STREAMS),
                ("n_folds", ctypes.c_int)]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("rng")
    fn = lib.uniform_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, _Draw, ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p,
                   ctypes.c_void_p]  # base (None for a host key), keys, k, n, out, stream
    return lib


def _draw(key: Key, stream_ids, dev: torch.device):
    """(base pointer or None, :class:`_Draw`) of a call."""
    d = _Draw()
    if not isinstance(key, DeviceKey):
        for s, sid in enumerate(stream_ids):
            d.k0[s], d.k1[s] = fold_in(key, sid)
        return None, d
    base = key.base
    if dev.index is None:  # "cuda": the current card
        dev = torch.device(dev.type, torch.cuda.current_device())
    if base.device != dev or base.dtype != torch.int32 or tuple(base.shape) != (2,) \
            or not base.is_contiguous():
        raise ValueError(f"a device key's base must be a contiguous int32 [2] tensor on {dev}")
    if len(key.folds) > MAX_FOLDS:
        raise ValueError(f"fold at most {MAX_FOLDS} words into a device key, got {key.folds}")
    d.n_folds = len(key.folds)
    for i, w in enumerate(key.folds):
        d.fold[i] = w
    for s, sid in enumerate(stream_ids):
        d.stream[s] = sid
    return base.data_ptr(), d


def _uniforms_cuda(key: Key, stream_ids, n: int, dev: torch.device) -> torch.Tensor:
    base, d = _draw(key, stream_ids, dev)
    out = torch.empty(len(stream_ids), n, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.uniform_launch(base, d, len(stream_ids), n, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"uniform kernel launch failed: cudaError {err}")
    count_launch("RNG")
    if in_primal():
        count_launch("RNGp")
    return out


def stream_uniforms(key: Key, stream_ids: Sequence[int], n: int, device) -> torch.Tensor:
    """Uniform [0, 1) draws f32[k, n] of the k = len(stream_ids) <=
    :data:`MAX_STREAMS` given streams of ``key``, a contiguous row per
    stream (so each row is a contiguous f32[n]). For a CUDA ``device``
    one launch of ``csrc/rng.cu`` (counted as RNG, and as RNGp too inside
    :func:`..utils.profiling.primal`; the base of a
    :class:`DeviceKey` must be on ``device``);
    :func:`stream_uniforms_ref` for the CPU. Raises on k outside 1..4
    and on n >= 2**32 (the lane counter is 32 bits)."""
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


def stream_uniform(key: Key, stream_id: int, n: int, device) -> torch.Tensor:
    """Uniform [0, 1) f32[n] draws for the given stream of ``key``: the
    one row of :func:`stream_uniforms`."""
    return stream_uniforms(key, (stream_id,), n, device)[0]
