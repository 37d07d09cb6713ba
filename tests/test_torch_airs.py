"""PyTorch port, the Fibonacci and MiMC AIRs through the AIR-generic Stark
against the JAX package: constants, traces, device constraint evaluation and
whole proofs, byte for byte (tolerance 0: all exact integer math). Sizes are
those of tests/test_fibonacci.py and tests/test_mimc.py."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from stark_anatomy_tpu.iop import stark as ref_stark
from stark_anatomy_tpu.models import fibonacci as ref_fib
from stark_anatomy_tpu_torch.iop.stark import Stark
from stark_anatomy_tpu_torch.models import fibonacci as fib
from stark_anatomy_tpu_torch.models import mimc
from stark_anatomy_tpu_torch.ops.field import PRIME
from stark_anatomy_tpu_torch.ops.limbs import random_felt_words, to_tensor
from stark_anatomy_tpu_torch.reference import to_reference_limbs

# the JAX package's models/__init__ rebinds the name `mimc` to a function
ref_mimc = importlib.import_module("stark_anatomy_tpu.models.mimc")

MIMC_INPUT = 31337
SEED = b"airs-v1"


class _Dense:
    """An AIR seen without its periodic_columns(): only the dense
    constant_columns(num_rows) remain (and constant_columns_bytes where
    `as_bytes`), which sends a package down its column-LDE fall-back."""

    def __init__(self, air, as_bytes: bool):
        self._air, self._as_bytes = air, as_bytes

    def __getattr__(self, name):
        if name == "periodic_columns" or (name == "constant_columns_bytes" and not self._as_bytes):
            raise AttributeError(name)
        if name == "constant_columns_bytes":
            return lambda rows: [
                np.frombuffer(b"".join(int(v).to_bytes(16, "little") for v in col),
                              dtype=np.uint8).reshape(-1, 16)
                for col in self._air.constant_columns(rows)]
        return getattr(self._air, name)


def _case(name: str):
    """(port air, reference air, trace, output) of one AIR shape."""
    if name == "fibonacci":
        air, rair = fib.FibonacciAir(num_steps=40), ref_fib.FibonacciAir(num_steps=40)
        return air, rair, air.trace(), air.output()
    air, rair = mimc.MiMCAir(num_steps=60), ref_mimc.MiMCAir(num_steps=60)
    if name != "mimc":
        air, rair = _Dense(air, False), _Dense(rair, False)
    return air, rair, air.trace(MIMC_INPUT), mimc.mimc(MIMC_INPUT, 60)


@pytest.fixture(scope="module", params=["fibonacci", "mimc", "mimc-dense"])
def proved(request):
    """One port prove and one JAX prove of the same trace under one seed."""
    air, rair, trace, output = _case(request.param)
    port = Stark(air, expansion_factor=4, num_colinearity_checks=2, device="cpu")
    ref = ref_stark.Stark(rair, expansion_factor=4, num_colinearity_checks=2)
    boundary = air.boundary_constraints(output)
    assert boundary == rair.boundary_constraints(output)
    proof = port.prove(trace, boundary, randomizer_seed=SEED)
    ref_proof = ref.prove(trace, boundary, randomizer_seed=SEED)
    return request.param, port, ref, trace, boundary, output, proof, ref_proof


def test_mimc_round_constants_and_chain_equal_the_reference():
    assert mimc.PERIOD == ref_mimc.PERIOD == 32
    assert mimc.round_constants() == ref_mimc.round_constants()
    assert len(mimc.round_constants()) == 32 and mimc.round_constants()[0] == 0
    # one pinned value: a change of the derivation or its tag shows here too
    assert mimc.round_constants()[1] == ref_mimc.round_constants()[1] != 0
    for x in (0, 1, MIMC_INPUT, PRIME - 1):
        assert mimc.mimc(x, 70) == ref_mimc.mimc(x, 70)
    air, rair = mimc.MiMCAir(num_steps=60), ref_mimc.MiMCAir(num_steps=60)
    assert air.periodic_columns() == rair.periodic_columns()
    assert air.constant_columns(64) == rair.constant_columns(64)


@pytest.mark.parametrize("name", ["fibonacci", "mimc"])
def test_traces_properties_and_host_constraints_equal_the_reference(name):
    air, rair, trace, output = _case(name)
    rtrace = rair.trace() if name == "fibonacci" else rair.trace(MIMC_INPUT)
    assert trace.shape == rtrace.shape and (trace == rtrace).all()
    for attr in ("num_registers", "cycle_count", "constraint_degree", "num_constraints"):
        assert getattr(air, attr) == getattr(rair, attr), attr
    assert air.boundary_constraints(output) == rair.boundary_constraints(output)
    consts = [c[5] for c in air.constant_columns(64)]
    cur, nxt = [int(v) for v in trace[5]], [int(v) for v in trace[6]]
    assert air.eval_transition_host(cur, nxt, consts) == [0] * air.num_constraints
    bad = [(v + 1) % PRIME for v in nxt]
    assert air.eval_transition_host(cur, bad, consts) == rair.eval_transition_host(cur, bad, consts)
    assert any(air.eval_transition_host(cur, bad, consts))


@pytest.mark.parametrize("name", ["fibonacci", "mimc"])
def test_eval_transition_device_equals_the_reference_on_random_codewords(name):
    air, rair, _, _ = _case(name)
    rng = np.random.default_rng(17)
    n, w = 1024, air.num_registers
    n_const = len(air.constant_columns(1))
    planes = [to_tensor(random_felt_words(rng, n), "cpu") for _ in range(2 * w + n_const)]
    limbs = [jnp.asarray(to_reference_limbs(t)) for t in planes]
    got = air.eval_transition_device(planes[:w], planes[w : 2 * w], planes[2 * w :])
    want = rair.eval_transition_device(limbs[:w], limbs[w : 2 * w], limbs[2 * w :])
    assert len(got) == len(want) == air.num_constraints
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(to_reference_limbs(g), np.asarray(wnt))


def test_proof_bytes_equal_the_reference(proved):
    *_, proof, ref_proof = proved
    assert proof == ref_proof


def test_each_verifier_accepts_the_other_packages_proof(proved):
    _, port, ref, _, boundary, _, proof, ref_proof = proved
    assert port.verify(ref_proof, boundary) and port.verify(proof, boundary)
    assert ref.verify(proof, boundary)


def test_wrong_output_is_rejected(proved):
    _, port, ref, _, _, output, proof, _ = proved
    bad = port.air.boundary_constraints((output + 1) % PRIME)
    assert not port.verify(proof, bad)
    assert not ref.verify(proof, bad)


def test_wrong_trace_is_rejected(proved):
    _, port, _, trace, boundary, _, _, _ = proved
    bad_trace = trace.copy()
    bad_trace[7][-1] = (int(bad_trace[7][-1]) + 1) % PRIME
    assert not port.verify(port.prove(bad_trace, boundary, randomizer_seed=SEED), boundary)


def test_dense_columns_as_bytes_give_the_codewords_of_dense_ints_and_of_the_periodic_path():
    air = mimc.MiMCAir(num_steps=60)
    want = Stark(air, num_colinearity_checks=2, device="cpu")._constants_codewords("cpu")
    for as_bytes in (False, True):
        dense = Stark(_Dense(air, as_bytes), num_colinearity_checks=2, device="cpu")
        got = dense._constants_codewords("cpu")
        assert len(got) == len(want) == 1
        assert all(g.equal(w) for g, w in zip(got, want))


def test_degree_accounting_equals_the_reference(proved):
    name, port, ref, *_ = proved
    for attr in ("omicron_domain_length", "fri_domain_length", "degree_target", "max_degree",
                 "transition_quotient_degree", "expansion_shift", "num_randomizers"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    o = port.omicron_domain_length
    if name == "fibonacci":
        # degree 1: the boundary quotients dominate max_degree
        assert port.max_degree == o - 2 and port.transition_quotient_degree < o - 2
    else:
        assert port.max_degree == port.transition_quotient_degree == 3 * (o - 1) - 60


def test_bytes_trace_input_gives_the_same_bytes(proved):
    name, port, _, trace, boundary, _, proof, _ = proved
    raw = port.air.trace_bytes() if name == "fibonacci" else port.air.trace_bytes(MIMC_INPUT)
    assert raw.shape == trace.shape + (16,) and raw.dtype == np.uint8
    assert port.prove(raw, boundary, randomizer_seed=SEED) == proof
