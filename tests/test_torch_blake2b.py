"""PyTorch port, batched Blake2b-512: the plain version and the wrapper's CPU
path against hashlib and the JAX package (tolerance 0).

The JAX package's Pallas hasher is held here through its plain reference,
``blake2b_u32``, as that package's own CPU tests hold it: interpret-executing
the unrolled compressor takes many minutes on a CPU."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_anatomy_tpu.ops import blake2b as ref_b2
from stark_anatomy_tpu_torch.ops import blake2b as b2
from stark_anatomy_tpu_torch.ops import blake2b_kernels as bk
from stark_anatomy_tpu_torch.ops.limbs import to_numpy, to_tensor
from stark_anatomy_tpu_torch.reference import from_reference_digests, to_reference_digests


def _messages(msg_len: int, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + msg_len).integers(0, 256, size=(n, msg_len), dtype=np.uint8)


def _digests(planes: torch.Tensor) -> list:
    return b2.digests_to_bytes(to_numpy(planes))


@pytest.mark.parametrize("msg_len", [1, 3, 32, 64, 127, 128, 129, 192, 300])
def test_plain_and_wrapper_match_hashlib(msg_len):
    data = _messages(msg_len, 37)
    msg = to_tensor(b2.pack_bytes_to_planes(data), "cpu")
    want = [hashlib.blake2b(row.tobytes(), digest_size=64).digest() for row in data]
    assert _digests(b2.blake2b_planes_plain(msg, msg_len)) == want
    assert _digests(bk.blake2b_planes(msg, msg_len)) == want


def test_rfc7693_abc_vector():
    msg = to_tensor(b2.pack_bytes_to_planes(np.frombuffer(b"abc", dtype=np.uint8)[None]), "cpu")
    assert _digests(bk.blake2b_planes(msg, 3))[0].hex().startswith("ba80a53f981c4d0d6a2797b69f12f6e9")


@pytest.mark.parametrize("msg_len", [32, 64, 128, 192])
def test_matches_reference_blake2b_u32(msg_len):
    n = 1024
    data = _messages(msg_len, n, seed=1)
    planes = b2.pack_bytes_to_planes(data)
    got = to_reference_digests(bk.blake2b_planes(to_tensor(planes, "cpu"), msg_len))
    want = np.asarray(ref_b2.blake2b_u32(jnp.asarray(np.ascontiguousarray(planes.T)), msg_len))
    np.testing.assert_array_equal(got, want)


def test_merkle_node_hash_matches_reference_and_hashlib():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 1 << 32, size=(64, 16), dtype=np.uint32)
    level = from_reference_digests(rows, device="cpu")
    got = to_reference_digests(bk.merkle_node_hash(level))
    want = np.asarray(ref_b2.merkle_node_hash(jnp.asarray(rows[0::2]), jnp.asarray(rows[1::2])))
    np.testing.assert_array_equal(got, want)
    raw = rows.astype("<u4")
    assert got[3].astype("<u4").tobytes() == hashlib.blake2b(
        raw[6].tobytes() + raw[7].tobytes(), digest_size=64).digest()


def test_digest_layout_conversion_roundtrips():
    rows = np.random.default_rng(6).integers(0, 1 << 32, size=(5, 16), dtype=np.uint32)
    planes = from_reference_digests(rows, device="cpu")
    assert planes.shape == (16, 5) and planes.dtype == torch.int32
    np.testing.assert_array_equal(to_reference_digests(planes), rows)
    assert b2.bytes_to_digest_words(_digests(planes)[2]).tolist() == rows[2].tolist()


def test_rejects_wrong_shapes_and_empty_messages():
    msg = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        bk.blake2b_planes(msg, 64)  # 64 bytes need 16 planes
    with pytest.raises(ValueError):
        bk.blake2b_planes(msg, 0)
    with pytest.raises(TypeError):
        bk.blake2b_planes(msg.to(torch.int64), 32)
