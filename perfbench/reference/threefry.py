"""Counter-based uniforms: threefry-2x32 (20 rounds), as JAX draws them.

A key is two 32-bit words. ``fold_in(key, d)`` is the block of counter
(0, d) under ``key``; element ``i`` of a key's uniform stream is the
block of counter (0, i), its two words xor-ed, the top 23 bits under
exponent 0, minus one. Keys are folded on the host in numpy; the lanes'
uniforms are drawn on any device in int64 torch arithmetic masked to
32 bits, one key per lane.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@np.errstate(over="ignore")
def _block_np(k0, k1, c1):
    """Threefry-2x32 of counters (0, c1) under keys (k0, k1), numpy uint32
    arrays broadcast together: the two output words."""
    k0, k1, c1 = np.broadcast_arrays(np.asarray(k0, np.uint32), np.asarray(k1, np.uint32),
                                     np.asarray(c1, np.uint32))
    ks = (k0.copy(), k1.copy(), k0 ^ k1 ^ np.uint32(PARITY))
    x0 = ks[0].copy()
    x1 = c1 + ks[1]
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def make_key(seed: int) -> np.ndarray:
    """The key of a 32-bit seed, u32[2] = (0, seed)."""
    if not 0 <= seed <= M32:
        raise ValueError(f"a key's seed is 32 bits, got {seed}")
    return np.array([0, seed], np.uint32)


def fold_in(keys: np.ndarray, data) -> np.ndarray:
    """Fold ``data`` (broadcast against the keys' leading shape) into keys
    u32[..., 2]: u32[..., 2]."""
    keys = np.asarray(keys, np.uint32)
    d = (np.asarray(data, np.int64) & M32).astype(np.uint32)
    x0, x1 = _block_np(keys[..., 0], keys[..., 1], d)
    return np.stack([x0, x1], axis=-1)


def uniform_lanes(keys: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """Element ``counters[i]`` of the uniform stream of key ``keys[i]``:
    keys i64[n, 2] holding 32-bit words, counters i64[n]; f32[n] in [0, 1)."""
    k0, k1 = keys[:, 0], keys[:, 1]
    ks = (k0, k1, (k0 ^ k1) ^ PARITY)
    x0 = k0.clone()
    x1 = (counters + k1) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    bits = x0 ^ x1
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0
