"""PyTorch port, field arithmetic: the plain int64 versions and the kernel
wrappers' CPU path against the JAX package, bit for bit (tolerance 0: all
exact integer math). One numpy input feeds both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_anatomy_tpu.ops import field_jnp as fj
from stark_anatomy_tpu.ops import field_pallas as fp
from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops import field_torch as ft
from stark_anatomy_tpu_torch.ops.field import PRIME
from stark_anatomy_tpu_torch.ops.limbs import (
    R_MOD_P,
    mont,
    random_felt_words,
    to_tensor,
    words_to_ints,
)
from stark_anatomy_tpu_torch.reference import from_reference_limbs, to_reference_limbs

N = 1024
EDGES_RAW = [0, 1, PRIME - 1, PRIME, (1 << 128) - 1, PRIME + 1, (1 << 64) - 1, 1 << 64,
             (1 << 96) - 1, 1 << 96, (1 << 32) - 1, 1 << 32, 1 << 127, 0xFFFF0000FFFF0000FFFF]
EDGES_CANON = [0, 1, 2, PRIME - 1, PRIME - 2, (1 << 64) - 1, 1 << 64, (1 << 96) - 1, 1 << 96,
               (1 << 16) - 1, 1 << 16, (1 << 112) - 1, 1 << 112]


def _words(seed: int, n: int, canonical: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if canonical:
        w, edges = random_felt_words(rng, n), EDGES_CANON
    else:
        w, edges = rng.integers(0, 1 << 32, size=(4, n), dtype=np.uint32), EDGES_RAW
    for i, e in enumerate(edges):
        # edges meet edges: the second operand (another seed) is shifted by one
        w[:, (i + seed) % n] = [(e >> (32 * j)) & 0xFFFFFFFF for j in range(4)]
    return w


def _both(words: np.ndarray):
    t = to_tensor(words, "cpu")
    return t, jnp.asarray(to_reference_limbs(t))


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(to_reference_limbs(got), np.asarray(want))


@pytest.fixture(scope="module")
def raw():
    return _both(_words(1, N, False)), _both(_words(2, N, False))


@pytest.fixture(scope="module")
def canon():
    return _both(_words(3, N, True)), _both(_words(4, N, True))


def test_reference_limb_conversion_roundtrips():
    w = _words(5, 64, False)
    t = to_tensor(w, "cpu")
    limbs = to_reference_limbs(t)
    assert limbs.shape == (8, 64) and limbs.dtype == np.uint32 and int(limbs.max()) < (1 << 16)
    assert torch.equal(from_reference_limbs(limbs, device="cpu"), t)
    vals = words_to_ints(w)
    assert int(vals[1]) == sum(int(limbs[k, 1]) << (16 * k) for k in range(8))


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
@pytest.mark.parametrize("impl", ["plain", "wrapper"])
def test_binary_ops_match_field_jnp_on_any_128_bit_input(raw, op, impl):
    (a, ja), (b, jb) = raw
    mod = ft if impl == "plain" else fk
    _same(getattr(mod, op)(a, b), getattr(fj, op)(ja, jb))


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops_match_pallas_interpret(raw, op):
    (a, ja), (b, jb) = raw
    _same(getattr(fk, op)(a, b), getattr(fp, op)(ja, jb, interpret=True))


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_constant_operand_equals_broadcast_tensor(raw, op):
    (a, _), _ = raw
    c = (1 << 128) - 12345
    col = ft.const_column(c, a).expand_as(a).contiguous()
    want = getattr(ft, op)(a, col)
    assert torch.equal(getattr(ft, op)(a, c), want)
    assert torch.equal(getattr(fk, op)(a, c), want)


def test_sub_constant_first_and_out_views(canon):
    (a, _), (b, _) = canon
    one = ft.const_column(mont(1), a).expand_as(a).contiguous()
    assert torch.equal(fk.sub(mont(1), a), ft.sub(one, a))
    out = torch.zeros((4, 2 * N), dtype=torch.int32)
    fk.mont_mul(a, b, out=out[:, N:])
    assert torch.equal(out[:, N:], ft.mont_mul(a, b)) and not out[:, :N].any()


@pytest.mark.parametrize("op", ["neg", "to_mont", "from_mont"])
def test_unary_ops_match_field_jnp(canon, op):
    (a, ja), _ = canon
    _same(getattr(ft, op)(a), getattr(fj, op)(ja))


def test_to_from_mont_wrappers_match_pallas_interpret(canon):
    (a, ja), _ = canon
    _same(fk.to_mont(a), fp.to_mont(ja, interpret=True))
    _same(fk.from_mont(a), fp.from_mont(ja, interpret=True))


def test_mul_eq_select_zeros_full_match_field_jnp(canon):
    (a, ja), (b, jb) = canon
    _same(ft.mul(a, b), fj.mul(ja, jb))
    b2 = b.clone()
    b2[:, ::3] = a[:, ::3]
    jb2 = jnp.asarray(to_reference_limbs(b2))
    mask = ft.eq(a, b2)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(fj.eq(ja, jb2)))
    assert mask[::3].all() and not mask.all()
    _same(ft.select(mask, a, b), fj.select(jnp.asarray(mask.numpy()), ja, jb))
    _same(ft.zeros((7,), "cpu"), fj.zeros((7,)))
    for value, m in ((5, False), (PRIME - 1, True), (PRIME + 3, False)):
        _same(ft.full((9,), value, "cpu", mont=m), fj.full((9,), value, mont=m))


@pytest.mark.parametrize("exponent", [0, 1, 3, 0b1011011, PRIME - 2, (1 << 128) + 5])
def test_pow_const_matches_field_jnp(canon, exponent):
    (a, ja), _ = canon
    n = N if exponent < (1 << 64) else 64  # ~250 products per element: keep the long ones short
    a, ja = a[:, :n].contiguous(), ja[:, :n]
    want = fj.pow_const(ja, exponent)
    _same(ft.pow_const(a, exponent), want)
    _same(fk.pow_const(a, exponent), want)
    out = a.clone()
    assert fk.pow_const(out, exponent, out=out) is out
    _same(out, want)
    if exponent < (1 << 64):
        _same(ft.pow_const(a, exponent, a_is_mont=False), fj.pow_const(ja, exponent, a_is_mont=False))


def test_pow_const_edges_zero_exponent_noncanonical_input_and_negative(raw):
    (a, ja), _ = raw  # any 128-bit input, p, p + 1 and 2^128 - 1 among them
    a, ja = a[:, :32].contiguous(), ja[:, :32]
    one = ft.const_column(R_MOD_P, a).expand_as(a)
    assert torch.equal(fk.pow_const(a, 0), one)  # also where a is 0
    for exponent in (1, 2, 12345):
        got = fk.pow_const(a, exponent)
        _same(got, fj.pow_const(ja, exponent))
        assert all(int(v) < PRIME for v in words_to_ints(got.numpy()))  # canonical out
    with pytest.raises(ValueError):
        fk.pow_const(a, -1)
    with pytest.raises(ValueError):
        ft.pow_const(a, -1)
    with pytest.raises(TypeError):
        fk.pow_const(a.to(torch.int64), 3)
    with pytest.raises(ValueError):
        fk.pow_const(a, 3, out=torch.zeros((4, 8), dtype=torch.int32))


def test_butterfly_matches_pallas_interpret(canon):
    (a, ja), (b, jb) = canon
    tw, jtw = _both(_words(8, N, True))
    hi, lo = fk.butterfly(a, b, tw)
    want_hi, want_lo = fp.butterfly(ja, jb, jtw, interpret=True)
    _same(hi, want_hi)
    _same(lo, want_lo)
    plain_hi, plain_lo = ft.butterfly(a, b, tw)
    assert torch.equal(hi, plain_hi) and torch.equal(lo, plain_lo)


def test_butterfly_ragged_constant_twiddle_and_aliased_outputs():
    n = 777
    (a, ja), (b, jb), (tw, jtw) = (_both(_words(s, n, False)) for s in (9, 10, 11))
    t = fj.mont_mul(jb, jtw)
    hi, lo = fk.butterfly(a, b, tw)
    _same(hi, fj.add(ja, t))
    _same(lo, fj.sub(ja, t))
    # a constant twiddle, by value
    c = mont(987654321)
    col = ft.const_column(c, a).expand_as(a).contiguous()
    chi, clo = fk.butterfly(a, b, c)
    want = ft.butterfly(a, b, col)
    assert torch.equal(chi, want[0]) and torch.equal(clo, want[1])
    # hi over even, lo over odd, as views of one buffer
    buf = torch.cat([a, b], dim=1)
    got = fk.butterfly(buf[:, :n], buf[:, n:], tw, out=(buf[:, :n], buf[:, n:]))
    assert got[0].data_ptr() == buf.data_ptr()
    assert torch.equal(buf[:, :n], hi) and torch.equal(buf[:, n:], lo)
    with pytest.raises(ValueError):
        fk.butterfly(a, b[:, :-1], tw)
    with pytest.raises(TypeError):
        fk.butterfly(a, b.to(torch.int64), tw)


def test_mont_mul_agrees_with_python_ints(canon):
    (a, _), (b, _) = canon
    got = words_to_ints(ft.mont_mul(a, b).numpy())
    r_inv = pow(R_MOD_P, -1, PRIME)
    xs, ys = words_to_ints(a.numpy()), words_to_ints(b.numpy())
    for i in range(0, N, 37):
        assert int(got[i]) == int(xs[i]) * int(ys[i]) * r_inv % PRIME


def test_inv_ladder_matches_fermat_and_field_jnp_and_maps_zero_to_zero():
    a, ja = _both(_words(6, N, True))  # holds 0 at index 6
    got = fk.inv(a)
    assert torch.equal(got, ft.inv(a))
    _same(got, fj.inv(ja))
    assert not got[:, 6].any()
    prod = ft.mont_mul(got, a)
    one = ft.const_column(R_MOD_P, a).expand_as(a)
    nz = ft.is_nonzero(a)
    assert torch.equal(prod[:, nz], one[:, nz])


def test_inv_batch_branch_equals_ladder_with_zeros():
    # the card's route (fp_batch_inv over inv_plan's levels, the 143-product
    # chain at its base) on the plain ops, against fk.inv's CPU route (Fermat)
    from test_torch_inv import model_batch_inv

    n = 1 << 14
    assert fk.inv_plan(n) == [n, n // (fk.INV_PER_THREAD * fk.INV_THREADS)]
    a = to_tensor(_words(7, n, True), "cpu")  # EDGES_CANON puts a 0 at index 7
    a[:, 5000] = 0
    got = fk.inv(a)
    assert torch.equal(got, model_batch_inv(a, fk.INV_PER_THREAD, fk.INV_THREADS))
    assert not got[:, 7].any() and not got[:, 5000].any()
