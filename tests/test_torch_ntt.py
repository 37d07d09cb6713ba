"""PyTorch port, NTT: transforms, coset evaluation and the per-kernel plain
versions against the JAX package, bit for bit (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_anatomy_tpu.ops import ntt as ref_ntt
from stark_anatomy_tpu.ops import ntt_pallas as ntp
from stark_anatomy_tpu_torch.ops import ntt as nttmod
from stark_anatomy_tpu_torch.ops import ntt_kernels
from stark_anatomy_tpu_torch.ops.field import GENERATOR, PRIME, finv, primitive_root_of_unity
from stark_anatomy_tpu_torch.ops.limbs import mont, random_felt_words, to_tensor
from stark_anatomy_tpu_torch.reference import to_reference_limbs

SIZES = [2, 4, 8, 64, 512, 4096]


def _codeword(n: int, seed: int = 0):
    t = to_tensor(random_felt_words(np.random.default_rng(seed), n), "cpu")
    return t, jnp.asarray(to_reference_limbs(t))


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(to_reference_limbs(got), np.asarray(want))


@pytest.mark.parametrize("n", SIZES)
def test_ntt_and_intt_match_reference(n):
    x, jx = _codeword(n, seed=n)
    y = nttmod.ntt(x)
    _same(y, ref_ntt.ntt(jx))
    _same(nttmod.intt(x), ref_ntt.intt(jx))
    assert torch.equal(nttmod.intt(y), x)


@pytest.mark.parametrize("n", [4, 256, 2048])
def test_coset_evaluate_interpolate_lde_match_reference(n):
    x, jx = _codeword(n, seed=n + 1)
    _same(nttmod.coset_evaluate(x, 4 * n, GENERATOR), ref_ntt.coset_evaluate(jx, 4 * n, GENERATOR))
    _same(nttmod.coset_lde(x, 2, GENERATOR), ref_ntt.coset_lde(jx, 2, GENERATOR))
    _same(nttmod.coset_interpolate(x, GENERATOR), ref_ntt.coset_interpolate(jx, GENERATOR))
    assert torch.equal(
        nttmod.coset_interpolate(nttmod.coset_evaluate(x, n, GENERATOR), GENERATOR), x)


def test_matches_pallas_interpret_at_2048():
    # one direction only: interpret-executing the Pallas NTT takes ~20 s
    x, jx = _codeword(2048, seed=9)
    _same(nttmod.ntt(x), ntp._ntt_pallas_impl(jx, False, True))


@pytest.mark.parametrize("n,inverse", [(8, False), (1024, False), (1024, True), (4096, True)])
def test_twiddles_and_powers_match_reference(n, inverse):
    _same(nttmod._twiddles(n, inverse, "cpu"), ref_ntt._twiddles(n, inverse))
    base = 0x1234567 if not inverse else PRIME - 5
    _same(nttmod.powers(base, n - 3, "cpu"), ref_ntt.powers(base, n - 3))


@pytest.mark.parametrize("n,log_block", [(2, 1), (32, 5), (1024, 10), (4096, 3), (4096, 10)])
@pytest.mark.parametrize("inverse", [False, True])
def test_block_then_stage_kernels_plain_versions_compose_to_the_transform(n, log_block, inverse):
    # ntt_block / ntt_stage given CPU tensors take their plain versions; their
    # composition is the decimation-in-time form the CUDA kernels implement.
    x, _ = _codeword(n, seed=3)
    tw = nttmod._twiddles(n, inverse, "cpu")
    scale = mont(finv(n)) if inverse else None
    y = ntt_kernels.ntt_block(x, tw, log_block, scale)
    for s in range(log_block + 1, n.bit_length()):
        assert ntt_kernels.ntt_stage(y, tw, s) is y  # in place
    assert torch.equal(y, ntt_kernels.transform_plain(x, tw, scale))
    assert torch.equal(y, ntt_kernels.transform(x, tw, scale))


def test_rejects_bad_sizes_and_tables():
    x, _ = _codeword(8)
    with pytest.raises(ValueError):
        nttmod.ntt(x[:, :6].contiguous())
    with pytest.raises(ValueError):
        ntt_kernels.transform(x, nttmod._twiddles(16, False, "cpu"))
    with pytest.raises(ValueError):
        ntt_kernels.ntt_block(x, nttmod._twiddles(8, False, "cpu"), 4)
    with pytest.raises(ValueError):
        nttmod.coset_evaluate(x, 4, GENERATOR)


def _grouped_reference(jx, group: int, inverse: bool):
    """grouped_ntt_with_tables in interpret mode; the TPU kernel wants every
    group handed over bit-reversed, the port's takes natural order."""
    n = jx.shape[-1]
    rev = ref_ntt.bit_reverse_indices(group)
    flat = jnp.asarray(np.asarray(jx).reshape(8, n // group, group)[:, :, rev].reshape(8, n))
    early = ntp.stage_tables(group, inverse)[0]
    return ntp.grouped_ntt_with_tables(flat, early, group, inverse, interpret=True)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("group", [2, 8, 128])
@pytest.mark.parametrize("n", [1024, 2048])
def test_grouped_plain_matches_pallas_interpret(n, group, inverse):
    x, jx = _codeword(n, seed=n + group)
    got = nttmod.grouped_ntt(x, group, inverse)
    _same(got, _grouped_reference(jx, group, inverse))
    tw = nttmod._twiddles(group, inverse, "cpu")
    scale = mont(finv(group)) if inverse else None
    assert torch.equal(got, ntt_kernels.ntt_grouped_plain(x, tw, group, scale))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("group,n", [(2, 2), (2, 6), (4, 1028), (16, 48), (64, 4096), (128, 128)])
def test_grouped_is_the_transform_of_every_group(group, n, inverse):
    x, _ = _codeword(n, seed=group + n)
    single = nttmod.intt if inverse else nttmod.ntt
    want = torch.cat([single(x[:, i : i + group].contiguous()) for i in range(0, n, group)], dim=1)
    assert torch.equal(nttmod.grouped_ntt(x, group, inverse), want)


@pytest.mark.parametrize("log_n", [4, 10, 20, 24])
@pytest.mark.parametrize("group", [2, 8, 128])
def test_group_root_is_the_root_the_whole_transform_implies(log_n, group):
    # the four-step NTT's column transforms use w_g = w_n^(n/g)
    n = 1 << log_n
    if group <= n:
        assert pow(primitive_root_of_unity(n), n // group, PRIME) == primitive_root_of_unity(group)


def test_grouped_rejects_bad_groups_and_tables():
    x, _ = _codeword(256)
    for group in (0, 1, 3, 12, 256):
        with pytest.raises(ValueError, match="power of two in"):
            nttmod.grouped_ntt(x, group)
    with pytest.raises(ValueError, match="whole number of groups"):
        nttmod.grouped_ntt(x[:, :100].contiguous(), 8)
    with pytest.raises(ValueError, match="whole number of groups"):
        ntt_kernels.ntt_grouped(x, nttmod._twiddles(16, False, "cpu"), 8)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_kernels.ntt_grouped(x[:, ::2], nttmod._twiddles(8, False, "cpu"), 8)
    with pytest.raises(TypeError):
        ntt_kernels.ntt_grouped(x.to(torch.int64), nttmod._twiddles(8, False, "cpu"), 8)
