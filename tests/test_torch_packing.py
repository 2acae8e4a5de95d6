"""Port packing vs the JAX reference: packed words, unpacking and bit-planes
bit-identical (exact integer equality; the port's int32 words are viewed as
the reference's uint32).  Shapes cover the ranges of tests/test_packing.py:
1..7 rows, lengths 1..200 (ragged tails included), every axis."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import packing as JP
from repro_torch.core import packing as TP
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

SHAPES = [(1, 1), (7, 200), (3, 33), (5, 64), (2, 100)]
BITS = [1, 2, 4, 8]


def _data(bits, shape, seed=0):
    rng = np.random.default_rng([seed, bits, *shape])
    return rng.integers(0, 2**bits, size=shape).astype(np.int32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_bit_identical(bits, shape):
    x = _data(bits, shape)
    for axis in (0, 1, -1):
        want = np.asarray(JP.pack_bits(jnp.asarray(x), bits, axis=axis))
        got = TP.pack_bits(torch.from_numpy(x), bits, axis=axis)
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        back = TP.unpack_bits(got, bits, x.shape[axis], axis=axis)
        np.testing.assert_array_equal(back.numpy(), x)
        jback = JP.unpack_bits(jnp.asarray(want), bits, x.shape[axis], axis=axis)
        np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_bitplanes_bit_identical(bits, shape):
    x = _data(bits, shape, seed=1)
    planes = TP.to_bitplanes(torch.from_numpy(x), bits)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(JP.to_bitplanes(jnp.asarray(x), bits)))
    for axis in (-1, 0):
        want = np.asarray(JP.pack_bitplanes(jnp.asarray(x), bits, axis=axis))
        got = TP.pack_bitplanes(torch.from_numpy(x), bits, axis=axis)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_high_bit_words_survive_int32():
    """Words with bit 31 set are negative int32 in the port, same bits."""
    x = np.ones((2, 64), np.int32)
    got = TP.pack_bits(torch.from_numpy(x), 1)
    assert got.numpy().view(np.uint32).tolist() == [[0xFFFFFFFF] * 2] * 2
    np.testing.assert_array_equal(TP.unpack_bits(got, 1, 64).numpy(), x)


def test_tail_padding_is_zero():
    packed = TP.pack_bits(torch.ones((1, 33), dtype=torch.int32), 1)
    assert tuple(packed.shape) == (1, 2) and int(packed[0, 1]) == 1
    assert TP.packed_len(33, 1) == JP.packed_len(33, 1) == 2


def test_values_per_word_rejects_bad_bits():
    with pytest.raises(ValueError):
        TP.values_per_word(3)
