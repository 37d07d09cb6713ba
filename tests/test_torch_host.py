"""PyTorch port, host layer: the port's own copies of the JAX-free modules
(host field, transcript, encodings, limb helpers), the native host batch
ops, Fri.eval_domain and the top-level package surface against the
originals."""

import os

import numpy as np
import pytest

import stark_anatomy_tpu as ref_pkg
import stark_anatomy_tpu_torch as pkg
from stark_anatomy_tpu import native as ref_native
from stark_anatomy_tpu.iop import fri as ref_fri
from stark_anatomy_tpu.iop import proof_stream as ref_ps
from stark_anatomy_tpu.ops import field as ref_field
from stark_anatomy_tpu.ops import limbs as ref_limbs
from stark_anatomy_tpu.utils import encoding as ref_enc
from stark_anatomy_tpu_torch import native
from stark_anatomy_tpu_torch.iop import fri
from stark_anatomy_tpu_torch.iop import proof_stream as ps
from stark_anatomy_tpu_torch.iop.stark import Stark
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir
from stark_anatomy_tpu_torch.ops import field
from stark_anatomy_tpu_torch.ops import limbs
from stark_anatomy_tpu_torch.ops import ntt as nttmod
from stark_anatomy_tpu_torch.utils import encoding as enc
from stark_anatomy_tpu_torch.parallel import make_mesh
from stark_anatomy_tpu_torch.utils import telemetry

VALUES = [0, 1, 2, field.PRIME - 1, (1 << 64) + 12345, 0xDEADBEEFCAFEBABE1234]


def test_field_constants_and_scalar_functions_equal_originals():
    assert (field.PRIME, field.GENERATOR) == (ref_field.PRIME, ref_field.GENERATOR)
    assert field.PRIME == 1 + 407 * (1 << 119)
    for v in VALUES[1:]:
        assert field.finv(v) == ref_field.finv(v) and field.finv(v) * v % field.PRIME == 1
    for n in (1, 2, 1 << 10, 1 << 24, 1 << 119):
        w = field.primitive_root_of_unity(n)
        assert w == ref_field.primitive_root_of_unity(n) and pow(w, n, field.PRIME) == 1
    with pytest.raises(ZeroDivisionError):
        field.finv(0)
    with pytest.raises(ValueError):
        field.primitive_root_of_unity(3)


def test_field_element_operators():
    a, b = field.FieldElement(VALUES[4]), field.FieldElement(VALUES[5])
    ra, rb = ref_field.FieldElement(VALUES[4]), ref_field.FieldElement(VALUES[5])
    for op in ("__add__", "__sub__", "__mul__", "__truediv__"):
        assert getattr(a, op)(b).value == getattr(ra, op)(rb).value
    assert (-a).value == (-ra).value and a.pow(77).value == ra.pow(77).value
    assert (a / a) == field.ONE and (a - a) == field.ZERO
    with pytest.raises(ZeroDivisionError):
        a / field.ZERO


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_host_ntt_intt_and_poly_eval_equal_originals(n):
    rng = np.random.default_rng(n)
    vals = [int(x) for x in rng.integers(0, 1 << 62, size=n)]
    assert field.host_ntt(vals) == ref_field.host_ntt(vals)
    assert field.host_intt(vals) == ref_field.host_intt(vals)
    assert field.host_intt(field.host_ntt(vals)) == vals
    assert field.host_poly_eval(vals, 987654321) == ref_field.host_poly_eval(vals, 987654321)


def test_transcript_sampling_equals_originals():
    for data in (b"", b"seed", bytes(range(64))):
        assert field.sample_field_element(data) == ref_field.sample_field_element(data)
    for size, reduced, count in ((512, 32, 8), (1 << 23, 1 << 10, 16), (64, 16, 2)):
        assert field.sample_indices(b"s", size, reduced, count) == \
            ref_field.sample_indices(b"s", size, reduced, count)


def test_proof_stream_bytes_and_fiat_shamir_equal_originals():
    items = [{"root": "abc"}, {"vals": ["1", "22"]}, [1, 2, 3], {"n": None}]
    a, b = ps.ProofStream(), ref_ps.ProofStream()
    for it in items:
        a.push(it)
        b.push(it)
    assert a.serialize() == b.serialize() == ps.serialize_items(items)
    assert a.prover_fiat_shamir() == b.prover_fiat_shamir()
    for _ in range(2):
        assert a.pull() == b.pull()
        assert a.verifier_fiat_shamir() == b.verifier_fiat_shamir()
    back = ps.ProofStream.deserialize(a.serialize())
    assert back.items == items and len(back) == 4
    for _ in items:
        back.pull()
    with pytest.raises(ps.OutOfBoundsReadIndexError):
        back.pull()
    for garbage in (b"\xff\xfe", b"{}", b"3"):
        with pytest.raises(ps.ProofStreamError):
            ps.ProofStream.deserialize(garbage)


def test_encodings_equal_originals_and_reject_non_canonical_items():
    for v in VALUES:
        assert enc.felt_to_bytes(v) == ref_enc.felt_to_bytes(v)
        assert enc.felt_to_item(v) == ref_enc.felt_to_item(v)
        assert enc.item_to_felt(enc.felt_to_item(v)) == v
    assert enc.hash_felts(VALUES) == ref_enc.hash_felts(VALUES)
    digest = enc.hash_felts([7])
    assert enc.digest_to_item(digest) == ref_enc.digest_to_item(digest)
    assert enc.item_to_digest(enc.digest_to_item(digest)) == digest
    for bad in ("01", "-1", str(field.PRIME), "1e3", 5):
        with pytest.raises((ValueError, TypeError)):
            enc.item_to_felt(bad)
    with pytest.raises((ValueError, TypeError)):
        enc.item_to_digest("AAAA")
    nonce = enc.grind(b"seed", 8)
    assert nonce == ref_enc.grind(b"seed", 8)
    assert enc.pow_digest_ok(b"seed", nonce, 8) and ref_enc.pow_digest_ok(b"seed", nonce, 8)
    assert enc.item_to_nonce(enc.nonce_to_item(nonce)) == nonce


def test_limb_constants_and_word_packing_agree_with_the_digit_layout():
    assert (limbs.R_MOD_P, limbs.R2_MOD_P, limbs.R_INV) == (
        ref_limbs.R_MOD_P, ref_limbs.R2_MOD_P, ref_limbs.R_INV)
    words = limbs.ints_to_words(VALUES)
    digits = ref_limbs.ints_to_limbs(VALUES)
    assert words.shape == (4, len(VALUES)) and words.dtype == np.uint32
    np.testing.assert_array_equal(words, digits[0::2] | (digits[1::2] << np.uint32(16)))
    assert [int(v) for v in limbs.words_to_ints(words)] == VALUES
    np.testing.assert_array_equal(limbs.words_to_bytes(words), ref_limbs.limbs_to_bytes(digits))
    np.testing.assert_array_equal(limbs.bytes_to_words(limbs.words_to_bytes(words)), words)
    assert limbs.int_to_words((1 << 128) - 1) == (0xFFFFFFFF,) * 4
    assert limbs.mont(5) == 5 * ref_limbs.R_MOD_P % field.PRIME
    t = limbs.to_tensor(words, "cpu")
    np.testing.assert_array_equal(limbs.to_numpy(t), words)
    with pytest.raises(ValueError):
        limbs.int_to_words(1 << 128)


def test_telemetry_phases_nest_and_reset():
    telemetry.reset()
    with telemetry.phase("outer"):
        with telemetry.phase("inner"):
            pass
    rep = telemetry.report()
    assert set(rep) == {"outer", "outer.inner"} and rep["outer"]["calls"] == 1
    telemetry.reset()
    assert telemetry.report() == {}


def _batch_operands(n: int = 125):
    rng = np.random.default_rng(n)
    a = [0, 1, field.PRIME - 1] + [int.from_bytes(rng.bytes(16), "little") % field.PRIME for _ in range(n)]
    b = [field.PRIME - 1, 0, field.PRIME - 1] + [int.from_bytes(rng.bytes(16), "little") % field.PRIME
                                                 for _ in range(n)]
    return a, b


POW_EXPONENTS = [0, 1, field.PRIME - 2, (1 << 128) - 1]


@pytest.mark.parametrize("route", ["library", "fallback"])
def test_native_batch_ops_equal_the_jax_package(route, monkeypatch):
    if route == "library":
        assert native.available()
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
    a, b = _batch_operands()
    for ref_route in ("library", "fallback"):
        with monkeypatch.context() as m:
            if ref_route == "fallback":
                m.setattr(ref_native, "_load", lambda: None)
            assert native.add_batch(a, b) == ref_native.add_batch(a, b)
            assert native.sub_batch(a, b) == ref_native.sub_batch(a, b)
            assert native.mul_batch(a, b) == ref_native.mul_batch(a, b)
            assert native.inv_batch(a) == ref_native.inv_batch(a)  # 0 -> 0 on every route
            assert native.powers(a[7], 300) == ref_native.powers(a[7], 300)
            for e in POW_EXPONENTS:
                # The JAX library reduces the exponent mod p before it crosses
                # to C (its pow_batch encodes it as a field element), so for
                # e >= p it computes x^(e mod p); its fallback and both of the
                # port's routes compute x^e.
                if ref_route == "fallback" or e < field.PRIME:
                    assert native.pow_batch(a, e) == ref_native.pow_batch(a, e), e
    assert native.add_batch(a, b) == [(x + y) % field.PRIME for x, y in zip(a, b)]
    assert native.inv_batch(a)[1:] == [field.finv(x) for x in a[1:]]
    for e in POW_EXPONENTS:
        assert native.pow_batch(a, e) == [pow(x, e, field.PRIME) for x in a]
    for bad in (-1, 1 << 128):
        with pytest.raises(ValueError):
            native.pow_batch(a, bad)
    with pytest.raises(ValueError):
        native.add_batch(a, b[:-1])


def test_fri_eval_domain_equals_the_jax_package():
    kw = dict(offset=field.GENERATOR, domain_length=1024, expansion_factor=4, num_colinearity_tests=8)
    got = fri.Fri(**kw).eval_domain()
    assert got == ref_fri.Fri(**kw).eval_domain()
    assert len(set(got)) == 1024 and got[0] == field.GENERATOR


def test_top_level_exports_equal_the_jax_package():
    assert pkg.PRIME == ref_pkg.PRIME == field.PRIME
    assert pkg.FieldElement is field.FieldElement
    a, b = pkg.FieldElement(VALUES[4]), pkg.FieldElement(VALUES[5])
    ra, rb = ref_pkg.FieldElement(VALUES[4]), ref_pkg.FieldElement(VALUES[5])
    assert (a * b).value == (ra * rb).value and (a / b).value == (ra / rb).value
    assert callable(pkg.clear_table_caches)


def test_clear_table_caches_empties_both_caches_and_the_next_prove_gives_the_same_bytes():
    # A mesh prove fills both: twiddles, and the mesh's tables through cached_table.
    rp = RescuePrime()
    air = RescuePrimeAir(rp, chain_length=1)
    stark = Stark(air, expansion_factor=4, num_colinearity_checks=2, mesh=make_mesh(8, "cpu"))
    boundary = air.boundary_constraints(rp.hash(20260817))
    trace = rp.trace_bytes(20260817, 1)
    first = stark.prove(trace, boundary, randomizer_seed=b"golden-v1")
    assert nttmod._TWIDDLE_CACHE and nttmod._TABLE_CACHE
    pkg.clear_table_caches()
    assert not nttmod._TWIDDLE_CACHE and not nttmod._TABLE_CACHE
    assert stark.prove(trace, boundary, randomizer_seed=b"golden-v1") == first
    with open(os.path.join(os.path.dirname(__file__), "golden", "proof_rescue_chain1.json"), "rb") as fh:
        assert first == fh.read()
