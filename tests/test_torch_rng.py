"""The port's counter-based streams are bit-equal to JAX's threefry: one
stream, and up to four at once (``stream_uniforms``), on the CPU."""

import jax
import numpy as np
import pytest
import torch

from montecarlopathtracer_tpu_torch.ops import rng
from montecarlopathtracer_tpu_torch.testing import cap_torch_threads, plain_kernels
from montecarlopathtracer_tpu_torch.utils import profiling

cap_torch_threads()


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


STREAMS = [(0,), (3,), (1 << 30,), ((1 << 30) + 673,), (0, 3), ((1 << 30) + 673, 1 << 30),
           (0, 3, 1 << 30), (0, 3, 1 << 30, (1 << 30) + 673)]


@pytest.mark.parametrize("n", [1, 127, 1000])
@pytest.mark.parametrize("ids", STREAMS, ids=lambda ids: "-".join(map(str, ids)))
def test_stream_uniforms_match_jax_row_by_row(ids, n):
    """Each row of ``stream_uniforms`` (the plain version on the CPU, the
    one that rng.cu is held to on the card) is JAX's uniform of its
    stream, bit for bit, and ``stream_uniform`` is the one-stream row."""
    k = jax.random.fold_in(jax.random.key(11), 4)
    kt = rng.fold_in(rng.make_key(11), 4)
    got = rng.stream_uniforms(kt, ids, n, "cpu")
    assert got.shape == (len(ids), n) and got.dtype == torch.float32 and got.is_contiguous()
    for row, sid in zip(got, ids):
        want = np.asarray(jax.random.uniform(jax.random.fold_in(k, sid), (n,)))
        np.testing.assert_array_equal(row.numpy().view(np.uint32), want.view(np.uint32))
        one = rng.stream_uniform(kt, sid, n, "cpu")
        assert torch.equal(one.view(torch.int32), row.view(torch.int32))


def test_stream_uniforms_refuses_what_the_kernel_cannot_take():
    key = rng.make_key(1)
    for bad in ((), tuple(range(5))):
        with pytest.raises(ValueError, match="streams"):
            rng.stream_uniforms(key, bad, 8, "cpu")
    for n in (2**32, 2**40, -1):
        with pytest.raises(ValueError, match="2\\*\\*32"):
            rng.stream_uniforms(key, (0,), n, "cpu")
    with pytest.raises(ValueError, match="device"):
        rng.stream_uniforms(key, (0,), 8, "meta")


def test_plain_kernels_routes_the_draws():
    """Under ``testing.plain_kernels`` every draw, the one-stream row
    included, goes to the plain version; the launch count stays."""
    key = rng.make_key(2)
    want = rng.stream_uniforms(key, (0, 5), 64, "cpu")
    before = profiling.launches()
    with plain_kernels():
        assert rng.stream_uniforms is rng.stream_uniforms_ref
        got = rng.stream_uniforms(key, (0, 5), 64, "cpu")
        one = rng.stream_uniform(key, 5, 64, "cpu")
    assert rng.stream_uniforms is not rng.stream_uniforms_ref
    assert torch.equal(got, want) and torch.equal(one, want[1])
    assert profiling.launches() - before == {}
