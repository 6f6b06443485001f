"""The port's counter-based streams are bit-equal to JAX's threefry."""

import jax
import numpy as np
import pytest

from montecarlopathtracer_tpu_torch.ops import rng


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**31 - 1])
def test_make_key_and_fold_in_match_jax(seed):
    k = jax.random.key(seed)
    kt = rng.make_key(seed)
    assert tuple(int(x) for x in jax.random.key_data(k)) == kt
    # A fold chain like the renderer's: pass, sample, ray tile.
    for data in (3, 1, (1 << 29) + 2):
        k = jax.random.fold_in(k, data)
        kt = rng.fold_in(kt, data)
        assert tuple(int(x) for x in jax.random.key_data(k)) == kt


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("stream_id", [0, 5, 31, 1 << 30, (1 << 30) + 1])
@pytest.mark.parametrize("n", [1, 127, 1000])
def test_stream_uniform_bit_equal(seed, stream_id, n):
    k = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 2), 1)
    kt = rng.fold_in(rng.fold_in(rng.make_key(seed), 2), 1)
    want = np.asarray(jax.random.uniform(jax.random.fold_in(k, stream_id), (n,)))
    got = rng.stream_uniform(kt, stream_id, n, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_make_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        rng.make_key(-1)
    with pytest.raises(ValueError):
        rng.make_key(2**32)
