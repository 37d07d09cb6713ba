"""PyTorch port, the slice as a whole: Rescue-Prime Stark.prove + verify on
the CPU path against the golden proof and the JAX package, byte for byte."""

import json
import os

import pytest

from stark_anatomy_tpu.iop import stark as ref_stark
from stark_anatomy_tpu.models import rescue_prime as ref_rp
from stark_anatomy_tpu_torch.iop.stark import PROFILES, Stark, default_config
from stark_anatomy_tpu_torch.models.fibonacci import FibonacciAir
from stark_anatomy_tpu_torch.models.mimc import MiMCAir
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir
from stark_anatomy_tpu_torch.ops.field import PRIME
from stark_anatomy_tpu_torch.reference import stark_from_reference

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "proof_rescue_chain1.json")
INPUT = 20260817
SEED = b"golden-v1"


@pytest.fixture(scope="module")
def golden_bytes():
    with open(GOLDEN, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def setup():
    rp = RescuePrime()
    air = RescuePrimeAir(rp, chain_length=1)
    stark = Stark(air, expansion_factor=4, num_colinearity_checks=2, device="cpu")
    boundary = air.boundary_constraints(rp.hash(INPUT))
    return rp, stark, boundary


@pytest.fixture(scope="module")
def ref_setup():
    rp = ref_rp.RescuePrime()
    air = ref_rp.RescuePrimeAir(rp, chain_length=1)
    return ref_stark.Stark(air, expansion_factor=4, num_colinearity_checks=2), \
        air.boundary_constraints(rp.hash(INPUT))


@pytest.fixture(scope="module")
def proof(setup):
    rp, stark, boundary = setup
    return stark.prove(rp.trace(INPUT), boundary, randomizer_seed=SEED)


def _tamper(proof: bytes, kind: str) -> bytes:
    items = json.loads(proof)
    for item in items:
        if kind in item:
            entry = item[kind][0]
            if isinstance(entry[1], list):
                entry[1][0] = str((int(entry[1][0]) + 1) % PRIME)
            else:
                entry[1] = str((int(entry[1]) + 1) % PRIME)
    return json.dumps(items, separators=(",", ":")).encode()


def test_regenerated_proof_matches_golden_bytes(proof, golden_bytes):
    assert proof == golden_bytes


def test_golden_proof_verifies_under_the_port(setup, golden_bytes):
    _, stark, boundary = setup
    assert stark.verify(golden_bytes, boundary)


def test_port_proof_verifies_under_the_reference_package(ref_setup):
    rp = RescuePrime()
    air = RescuePrimeAir(rp, chain_length=1)
    stark = Stark(air, expansion_factor=4, num_colinearity_checks=2, device="cpu")
    fresh = stark.prove(rp.trace(99), air.boundary_constraints(rp.hash(99)), randomizer_seed=b"other")
    ref, _ = ref_setup
    assert ref.verify(fresh, ref.air.boundary_constraints(ref.air.rp.hash(99)))
    assert stark.verify(fresh, air.boundary_constraints(rp.hash(99)))


@pytest.mark.parametrize("kind", ["bq_leaves", "zk_leaves"])
def test_tampered_proofs_are_rejected_by_both_packages(setup, ref_setup, proof, kind):
    _, stark, boundary = setup
    ref, ref_boundary = ref_setup
    bad = _tamper(proof, kind)
    assert bad != proof
    assert not stark.verify(bad, boundary)
    assert not ref.verify(bad, ref_boundary)


def test_wrong_boundary_truncation_and_garbage_are_rejected(setup, proof):
    rp, stark, boundary = setup
    assert not stark.verify(proof, stark.air.boundary_constraints(rp.hash(INPUT) + 1))
    assert not stark.verify(proof[: len(proof) // 2], boundary)
    assert not stark.verify(b"not a proof", boundary)
    flipped = bytearray(proof)
    flipped[len(flipped) // 3] ^= 1
    assert not stark.verify(bytes(flipped), boundary)


def test_wrong_trace_is_rejected(setup):
    rp, stark, boundary = setup
    trace = rp.trace(INPUT)
    trace[10, 0] = (int(trace[10, 0]) + 1) % PRIME
    assert not stark.verify(stark.prove(trace, boundary, randomizer_seed=SEED), boundary)


def test_bytes_trace_input_gives_the_same_bytes(setup, proof):
    rp, stark, boundary = setup
    raw = rp.trace_bytes(INPUT)
    assert raw.shape == (33, 2, 16)
    assert stark.prove(raw, boundary, randomizer_seed=SEED) == proof


def test_fresh_entropy_differs_and_seed_is_deterministic(setup, proof):
    rp, stark, boundary = setup
    other = stark.prove(rp.trace(INPUT), boundary)
    assert other != proof and stark.verify(other, boundary)


def test_chain_with_grinding_and_device_fri_rounds_verifies_under_both():
    # chain 3: F = 2048; the host tail lowered so two FRI rounds take the
    # tensor path (fold + commit) before the host finishes.
    stark = stark_from_reference(
        {"chain_length": 3, "num_colinearity_checks": 4, "grinding_bits": 5}, device="cpu")
    stark.fri_host_tail_n = 512
    rp = stark.air.rp
    boundary = stark.air.boundary_constraints(rp.chain_output(5, 3))
    proof = stark.prove(rp.trace_bytes(5, 3), boundary, randomizer_seed=b"chain3")
    assert stark.verify(proof, boundary)
    stark.fri_host_tail_n = 1 << 14
    assert stark.prove(rp.trace_bytes(5, 3), boundary, randomizer_seed=b"chain3") == proof
    rrp = ref_rp.RescuePrime()
    ref = ref_stark.Stark(ref_rp.RescuePrimeAir(rrp, chain_length=3), expansion_factor=4,
                          num_colinearity_checks=4, grinding_bits=5)
    assert ref.verify(proof, boundary)
    assert [next(iter(it)) for it in json.loads(proof)].count("pow_nonce") == 1


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("chain", [1, 32760])
def test_security_level_and_domains_equal_reference_for_every_profile(name, chain):
    assert PROFILES[name] == ref_stark.PROFILES[name]
    port = Stark.from_profile(name, RescuePrimeAir(RescuePrime(), chain), device="cpu")
    ref = ref_stark.Stark.from_profile(name, ref_rp.RescuePrimeAir(ref_rp.RescuePrime(), chain))
    for conj in (True, False):
        assert port.security_terms(conj) == ref.security_terms(conj)
        assert port.security_level(conj) == ref.security_level(conj)
    for attr in ("omicron_domain_length", "fri_domain_length", "degree_target", "expansion_shift",
                 "transition_quotient_degree", "max_degree", "omega", "omicron", "num_randomizers"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    if name == "production-128" and chain == 32760:
        assert port.fri_domain_length == 1 << 24 and port.security_level() == 99


def test_host_precomputations_equal_reference(setup, ref_setup):
    _, stark, boundary = setup
    ref, _ = ref_setup
    assert stark._excluded_coeffs() == ref._excluded_coeffs()
    assert stark._boundary_polys(boundary) == ref._boundary_polys(boundary)
    assert stark._periodic_coeffs() == ref._periodic_coeffs()
    x = 0x1234567890ABCDEF
    assert stark.eval_periodic_at(x) == ref.eval_periodic_at(x)
    cfg = default_config(2, device="cpu")
    assert (cfg.expansion_factor, cfg.num_colinearity_checks, cfg.trace_length) == (4, 16, 65)


def test_shape_mismatch_and_non_periodic_air_raise(setup):
    rp, stark, boundary = setup
    with pytest.raises(ValueError):
        stark.prove(rp.trace(INPUT)[:-1], boundary, randomizer_seed=SEED)

    # A non-periodic AIR must give its constant columns densely; one that has
    # neither periodic_columns() nor constant_columns*() raises.
    class NoColumns:
        def __init__(self, air):
            self._air = air

        def __getattr__(self, name):
            if name in ("periodic_columns", "constant_columns", "constant_columns_bytes"):
                raise AttributeError(name)
            return getattr(self._air, name)

    with pytest.raises(AttributeError, match="constant_columns"):
        Stark(NoColumns(MiMCAir(num_steps=60)), num_colinearity_checks=2, device="cpu") \
            ._constants_codewords("cpu")

    class BadPeriod(MiMCAir):
        def periodic_columns(self):
            return 3, [[1, 2, 3]]

    with pytest.raises(ValueError, match="period"):
        Stark(BadPeriod(num_steps=60), num_colinearity_checks=2, device="cpu")._periodic_coeffs()
    with pytest.raises(AttributeError):
        Stark(object(), device="cpu")


def test_non_periodic_air_is_accepted():
    # An AIR without periodic_columns() is accepted: its dense or absent
    # constant columns are extended like trace columns (proved end to end in
    # tests/test_torch_airs.py).
    assert Stark(FibonacciAir(num_steps=40), num_colinearity_checks=2, device="cpu") \
        ._constants_codewords("cpu") == []
