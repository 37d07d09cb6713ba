"""PyTorch port, property-based tests (hypothesis): the strategies of
tests/test_properties.py over the port's own modules.

- field laws on random u128 inputs (host oracle, ops/field.py), and random
  batches cross-checked host oracle vs the plain PyTorch field ops
  (ops/field_torch.py, on the CPU) vs the native host batch ops
  (stark_anatomy_tpu_torch.native);
- Merkle multiproof soundness (iop/merkle.py verify_multiproof): honest
  openings accepted, any node-list mutation or wrong leaf rejected;
- transcript item decoders (utils/encoding.py): canonical or raise.

Settings: derandomized (a property run must be reproducible), no deadline,
at most 25 examples a test (the suite shares the Tier-1 time budget).
"""

from __future__ import annotations

import base64
import hashlib
import math

import pytest
from hypothesis import given, settings, strategies as st

from stark_anatomy_tpu_torch import native
from stark_anatomy_tpu_torch.iop.merkle import MerkleTree, verify_multiproof
from stark_anatomy_tpu_torch.ops import field_torch as ft
from stark_anatomy_tpu_torch.ops.field import PRIME, FieldElement, extended_euclidean, finv, sample_indices
from stark_anatomy_tpu_torch.ops.limbs import ints_to_words, to_numpy, to_tensor, words_to_ints
from stark_anatomy_tpu_torch.utils.encoding import (
    bytes_to_felt,
    digest_to_item,
    felt_to_bytes,
    felt_to_item,
    item_to_digest,
    item_to_felt,
    item_to_nonce,
    nonce_to_item,
)

SETTINGS = dict(derandomize=True, deadline=None, max_examples=25)

felts = st.integers(min_value=0, max_value=PRIME - 1)
u128s = st.integers(min_value=0, max_value=(1 << 128) - 1)
BATCH = 8
felt_batches = st.lists(felts, min_size=BATCH, max_size=BATCH)


# -- field laws: host oracle ------------------------------------------------


@settings(**SETTINGS)
@given(a=u128s, b=u128s, c=u128s)
def test_field_ring_laws_host(a: int, b: int, c: int):
    fa, fb, fc = FieldElement(a), FieldElement(b), FieldElement(c)
    assert fa + fb == fb + fa
    assert fa * fb == fb * fa
    assert (fa + fb) + fc == fa + (fb + fc)
    assert (fa * fb) * fc == fa * (fb * fc)
    assert fa * (fb + fc) == fa * fb + fa * fc
    assert fa - fa == FieldElement(0)
    assert fa + (-fa) == FieldElement(0)


@settings(**SETTINGS)
@given(a=felts)
def test_field_inverse_law_host(a: int):
    fa = FieldElement(a)
    if a == 0:
        with pytest.raises(ZeroDivisionError):
            _ = FieldElement(1) / fa
    else:
        assert fa / fa == FieldElement(1)
        assert fa.inverse() * fa == FieldElement(1)
        assert FieldElement(finv(a)) == fa.inverse()


@settings(**SETTINGS)
@given(a=st.integers(min_value=1, max_value=(1 << 128) - 1),
       b=st.integers(min_value=1, max_value=(1 << 128) - 1))
def test_extended_euclidean_bezout(a: int, b: int):
    g, s, t = extended_euclidean(a, b)
    assert g == math.gcd(a, b)
    assert s * a + t * b == g


# -- field laws: host vs plain torch ops vs native, random batches -----------


def _tensor(values):
    return to_tensor(ints_to_words(values), "cpu")


def _ints(t) -> list:
    return [int(v) for v in words_to_ints(to_numpy(t))]


@settings(**SETTINGS)
@given(a=felt_batches, b=felt_batches)
def test_field_host_vs_plain_torch_batch(a, b):
    ta, tb = _tensor(a), _tensor(b)
    assert _ints(ft.add(ta, tb)) == [(x + y) % PRIME for x, y in zip(a, b)]
    assert _ints(ft.sub(ta, tb)) == [(x - y) % PRIME for x, y in zip(a, b)]
    assert _ints(ft.mul(ta, tb)) == [x * y % PRIME for x, y in zip(a, b)]
    assert _ints(ft.from_mont(ft.mont_mul(ft.to_mont(ta), ft.to_mont(tb)))) == [
        x * y % PRIME for x, y in zip(a, b)]
    # Fermat inverse, 0 -> 0 (the convention of ft.inv and the kernels)
    assert _ints(ft.inv(ta, a_is_mont=False)) == [finv(x) if x else 0 for x in a]


@settings(**SETTINGS)
@given(a=felt_batches, b=felt_batches, e=u128s)
def test_field_host_vs_native_batch(a, b, e):
    assert native.add_batch(a, b) == [(x + y) % PRIME for x, y in zip(a, b)]
    assert native.sub_batch(a, b) == [(x - y) % PRIME for x, y in zip(a, b)]
    assert native.mul_batch(a, b) == [x * y % PRIME for x, y in zip(a, b)]
    assert native.inv_batch(a) == [finv(x) if x else 0 for x in a]
    assert native.pow_batch(a, e) == [FieldElement(x).pow(e).value for x in a]
    assert native.powers(a[0], BATCH) == [pow(a[0], i, PRIME) for i in range(BATCH)]
    assert native.mul_batch(a, b) == _ints(ft.mul(_tensor(a), _tensor(b)))


# -- Merkle multiproof soundness under random mutations ---------------------


def _tree_and_proof(leaf_seed: int, indices):
    leaves = [
        hashlib.blake2b(bytes([leaf_seed & 0xFF]) + i.to_bytes(4, "big"), digest_size=64).digest()
        for i in range(64)
    ]
    tree = MerkleTree.commit_bytes(leaves)
    nodes = tree.open_multi(indices)
    return tree, nodes, {i: leaves[i] for i in indices}


index_sets = st.sets(st.integers(min_value=0, max_value=63), min_size=1, max_size=8)


@settings(**SETTINGS)
@given(indices=index_sets, seed=st.integers(min_value=0, max_value=255))
def test_multiproof_accepts_honest(indices, seed):
    tree, nodes, leaf_map = _tree_and_proof(seed, sorted(indices))
    assert verify_multiproof(tree.root, leaf_map, nodes, 6)


@settings(**SETTINGS)
@given(indices=index_sets, data=st.data())
def test_multiproof_rejects_any_node_list_mutation(indices, data):
    """Dropped, duplicated, swapped, bit-flipped, extra or rotated nodes."""
    tree, nodes, leaf_map = _tree_and_proof(7, sorted(indices))
    kind = data.draw(st.sampled_from(["drop", "dup", "swap", "flip", "extra", "rotate"]), label="mutation")
    mutated = list(nodes)
    if kind == "drop" and mutated:
        mutated.pop(data.draw(st.integers(0, len(mutated) - 1), label="pos"))
    elif kind == "dup" and mutated:
        pos = data.draw(st.integers(0, len(mutated) - 1), label="pos")
        mutated.insert(pos, mutated[pos])
    elif kind == "swap" and len(mutated) >= 2:
        i = data.draw(st.integers(0, len(mutated) - 2), label="pos")
        mutated[i], mutated[i + 1] = mutated[i + 1], mutated[i]
    elif kind == "flip" and mutated:
        pos = data.draw(st.integers(0, len(mutated) - 1), label="pos")
        byte = data.draw(st.integers(0, 63), label="byte")
        d = bytearray(mutated[pos])
        d[byte] ^= 1 + data.draw(st.integers(0, 254), label="xor")
        mutated[pos] = bytes(d)
    elif kind == "extra":
        mutated.append(hashlib.blake2b(b"extra", digest_size=64).digest())
    elif kind == "rotate" and len(mutated) >= 2:
        mutated = mutated[1:] + mutated[:1]
    if mutated == nodes:
        return  # the mutation was a no-op (e.g. a swap of equal digests)
    assert not verify_multiproof(tree.root, leaf_map, mutated, 6)


@settings(**SETTINGS)
@given(indices=index_sets, wrong=st.integers(min_value=0, max_value=63))
def test_multiproof_rejects_wrong_leaf_value(indices, wrong):
    tree, nodes, leaf_map = _tree_and_proof(7, sorted(indices))
    target = sorted(indices)[wrong % len(indices)]
    leaf_map = dict(leaf_map)
    leaf_map[target] = hashlib.blake2b(b"forged", digest_size=64).digest()
    assert not verify_multiproof(tree.root, leaf_map, nodes, 6)


# -- transcript item decoder fuzz -------------------------------------------

#: digits plus every character that could slip into a decimal item
_FUZZ_ALPHABET = "0123456789abcdefABCDEF+-_ .xXoe"


@settings(**SETTINGS)
@given(item=st.text(alphabet=_FUZZ_ALPHABET, min_size=0, max_size=60))
def test_item_to_felt_canonical_or_raise(item: str):
    try:
        value = item_to_felt(item)
    except ValueError:
        return
    assert 0 <= value < PRIME
    assert felt_to_item(value) == item  # one value, one encoding


@settings(**SETTINGS)
@given(value=felts, prefix=st.sampled_from(["+", " ", "0", "00", "-"]))
def test_item_to_felt_rejects_noncanonical_reencodings(value: int, prefix: str):
    with pytest.raises(ValueError):
        item_to_felt(prefix + str(value))


_B64_ALPHABET = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/="


@settings(**SETTINGS)
@given(item=st.text(alphabet=_B64_ALPHABET, min_size=0, max_size=96))
def test_item_to_digest_canonical_or_raise(item: str):
    try:
        digest = item_to_digest(item)
    except ValueError:
        return
    assert len(digest) == 64
    assert digest_to_item(digest) == item


@settings(**SETTINGS)
@given(data=st.binary(min_size=64, max_size=64), pos=st.integers(0, 87))
def test_item_to_digest_perturbed_encodings(data: bytes, pos: int):
    """A changed character of a valid digest item raises, or decodes to
    ANOTHER digest whose canonical encoding is the changed string."""
    item = base64.b64encode(data).decode()
    swap = "B" if item[pos] != "B" else "C"
    mutated = item[:pos] + swap + item[pos + 1 :]
    try:
        decoded = item_to_digest(mutated)
    except ValueError:
        return
    assert decoded != data
    assert digest_to_item(decoded) == mutated


@settings(**SETTINGS)
@given(data=st.binary(min_size=0, max_size=140))
def test_item_to_nonce_canonical_or_raise(data: bytes):
    item = data.decode("latin-1")
    try:
        nonce = item_to_nonce(item)
    except ValueError:
        return
    assert 0 <= nonce < (1 << 64)
    assert nonce_to_item(nonce) == item


@settings(**SETTINGS)
@given(value=felts)
def test_felt_bytes_roundtrip(value: int):
    assert bytes_to_felt(felt_to_bytes(value)) == value


@settings(**SETTINGS)
@given(extra=st.integers(min_value=0, max_value=(1 << 128) - 1 - PRIME))
def test_bytes_to_felt_rejects_noncanonical(extra: int):
    """Any 16-byte encoding of a value >= p is rejected, not reduced."""
    with pytest.raises(ValueError):
        bytes_to_felt((PRIME + extra).to_bytes(16, "little"))


# -- transcript index sampling ----------------------------------------------


@settings(**SETTINGS)
@given(seed=st.binary(min_size=0, max_size=32), size_log=st.integers(min_value=3, max_value=12),
       data=st.data())
def test_sample_indices_distinct_and_in_range(seed, size_log, data):
    size = 1 << size_log
    reduced = 1 << data.draw(st.integers(2, size_log), label="reduced_log")
    number = data.draw(st.integers(1, min(reduced, 16)), label="number")
    idx = sample_indices(seed, size, reduced, number)
    assert len(idx) == number
    assert all(0 <= i < size for i in idx)
    assert len({i % reduced for i in idx}) == number  # distinct after folding
