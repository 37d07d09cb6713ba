"""PyTorch port: the zero-knowledge randomizer's bit stream equals
jax.random.bits of a threefry2x32 key, word for word."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_anatomy_tpu_torch.utils import threefry


def _jax_bits(key_words: np.ndarray, rows: int, n: int) -> np.ndarray:
    key = jax.random.wrap_key_data(jnp.asarray(key_words), impl="threefry2x32")
    return np.asarray(jax.random.bits(key, (rows, n), dtype=jnp.uint32))


@pytest.mark.parametrize("n", [1, 8, 1000, 4096])
@pytest.mark.parametrize("seed", [b"golden-v1", b"\x00" * 32])
def test_random_bits_equal_jax_random_bits(n, seed):
    digest = hashlib.sha256(b"stark_anatomy_tpu/zk-fri-randomizer/v1" + seed).digest()
    key = np.frombuffer(digest[:8], dtype="<u4").copy()
    got = threefry.random_bits(key, 16, n, "cpu").numpy()
    assert got.min() >= 0 and got.max() < (1 << 32)
    np.testing.assert_array_equal(got.astype(np.uint32), _jax_bits(key, 16, n))


def test_extreme_key_words_and_other_row_counts():
    key = np.array([0xFFFFFFFF, 0x80000000], dtype=np.uint32)
    got = threefry.random_bits(key, 3, 77, "cpu").numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, _jax_bits(key, 3, 77))


@pytest.mark.parametrize("n", [64, 1000])
def test_a_set_of_columns_draws_the_same_words_as_the_whole_stream(n):
    # a process draws only the coefficients it holds (any index set, any
    # order); its words are those columns of the whole draw and of jax's
    key = np.array([0x01234567, 0x89ABCDEF], dtype=np.uint32)
    whole = threefry.random_bits(key, 16, n, "cpu")
    for cols in (np.arange(3, n, 8), np.array([n - 1, 0, 5, 5]), np.arange(n)):
        got = threefry.random_bits(key, 16, n, "cpu", columns=torch.from_numpy(cols))
        assert got.shape == (16, len(cols))
        np.testing.assert_array_equal(got.numpy(), whole.numpy()[:, cols])
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), _jax_bits(key, 16, n)[:, cols])
