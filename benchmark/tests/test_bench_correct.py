"""The plain reference against the program's proofs, and whole runs of the
harness on the CPU at a small size (the look for a card skipped): sound runs
come out correct, runs with the timed path broken underneath and the
configuration's control do not."""

import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import sys


import pytest
import torch

from benchmark import control, harness
from benchmark.reference import rescue_prime
from benchmark.reference.field import P
from benchmark.reference.rescue_prime import trace_faults
from benchmark.reference.verifier import Verifier, roots

#: traffic trace domains at which the cells' configurations prove chain 1
#: (default: O = 128, F = 2048) and chain 3 (production-80: O = 256, F = 4096)
SMALL = {"rescue-default.f24": 7, "rescue-prod80.f24": 8}
SEED = 2**31 + 977


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def small_cell(name):
    cell = harness.resolve(name)
    return dataclasses.replace(cell, traffic={**cell.traffic, "trace_domain_log2": SMALL[name]})


def run_small(name, trace=False, seconds=1.5, workers=1):
    result, lines = harness.run(small_cell(name), SEED, seconds, trace, device="cpu", workers=workers)
    assert lines[0].startswith("window: ") and lines[-1].startswith("check ") and list(result)[-1] == "checks"
    return result


def _tamper_leaf(proof: bytes) -> bytes:
    items = json.loads(proof)
    for item in items:
        if "bq_leaves" in item:
            leaf = item["bq_leaves"][0][1]
            leaf[0] = str((int(leaf[0]) + 1) % P)
    return json.dumps(items, separators=(",", ":")).encode()


def test_reference_accepts_the_programs_small_proof_and_rejects_tampering():
    from stark_anatomy_tpu_torch.iop.stark import Stark
    from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime as ProgramRescuePrime
    from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrimeAir

    config = harness.load_json(harness.os.path.join(harness.BENCH_DIR, "configs", "rescue-default.json"))
    rp = ProgramRescuePrime()
    air = RescuePrimeAir(rp, chain_length=1)
    stark = Stark(air, expansion_factor=4, num_colinearity_checks=2, grinding_bits=0, num_randomizers=8, device="cpu")
    assert stark.fri_domain_length == 1024
    trace = rp.trace_bytes(5, 1)
    output = int.from_bytes(trace[-1, 0].tobytes(), "little")
    proof = stark.prove(trace, air.boundary_constraints(output), randomizer_seed=b"bench")
    ref = Verifier(rescue_prime.from_config(config["air"]), 4, 2, 0, 8, 1)
    assert ref.f == 1024 and ref.verify(proof, output) and ref.air.output(trace) == output
    assert roots(proof) == tuple(json.loads(proof)[k][key] for k, key in enumerate(("bq_root", "zk_root")))
    assert roots(b"[]") is None and roots(b"not json") is None
    assert not ref.verify(proof, output + 1)  # a wrong output
    assert not ref.verify(_tamper_leaf(proof), output)
    assert not ref.verify(proof + b" ", output) and not ref.verify(proof[:-2], output)
    assert not Verifier(rescue_prime.from_config(config["air"]), 4, 3, 0, 8, 1).verify(proof, output)
    assert ref.air.trace_faults(trace, 5, 1) == 0
    assert ref.air.trace_faults(trace, 6, 1) == 1  # another input
    broken = trace.copy()
    broken[9, 1, 0] ^= 1  # one value: the transitions into and out of row 9
    assert ref.air.trace_faults(broken, 5, 1) == 2


def test_reference_trace_check_in_worker_processes():
    from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime as ProgramRescuePrime

    rp = rescue_prime.from_config(small_cell("rescue-default.f24").config["air"])
    chain = 4100  # two blocks of the check
    trace = ProgramRescuePrime().trace_bytes(3, chain)
    trace[131_072, 0, 4] ^= 8  # the first row of the second block
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=2, mp_context=ctx) as pool:
        assert trace_faults(rp, trace, 3, chain, pool) == trace_faults(rp, trace, 3, chain) == 2


@pytest.mark.parametrize("name,workers", [(name, 1) for name in sorted(SMALL)] + [("rescue-prod80.f24", 2)])
def test_a_sound_run_is_correct(name, workers):
    result = run_small(name, workers=workers)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"prove_s", "prove_p90_s", "setup_s"}  # no device memory on the CPU
    assert all(c["value"] == 0 for c in result["checks"].values())
    if workers > 1:  # the reference's pool and multiprocessing's resource tracker are gone
        assert harness.children() == []


def test_a_traced_run_is_correct_and_reads_the_spans():
    result = run_small("rescue-prod80.f24", trace=True)
    assert result["correct"] and result["attempted"] >= 1 + harness.PROFILED_PROVES
    assert {"lde_ms", "zk_ms", "combination_ms", "fri_ms", "host_tail_ms", "grind_ms"} <= set(result["metrics"])
    # the CPU runs no device operation: no device metric is read
    assert not {"ntt_roofline", "device_idle", "launches_per_prove"} & set(result["metrics"])


def _altered_answer(monkeypatch):
    from stark_anatomy_tpu_torch.iop.stark import Stark

    prove = Stark.prove
    monkeypatch.setattr(Stark, "prove", lambda self, *a, **k: _tamper_leaf(prove(self, *a, **k)))


def _fold_unchanged(monkeypatch):
    # every FRI fold returns its codeword's first half, unfolded (at these
    # sizes every round is on the host tail)
    from stark_anatomy_tpu_torch import native

    monkeypatch.setattr(native, "fri_fold_values", lambda values, *a, **k: list(values[: len(values) // 2]))


def _half_the_columns(monkeypatch):
    # register 1's extension left out, register 0's taken in its place
    from stark_anatomy_tpu_torch.iop.stark import Stark

    lde = Stark._trace_lde
    monkeypatch.setattr(Stark, "_trace_lde", lambda self, *a: [c.clone() for c in lde(self, *a)[:1] * 2])


def _stale_proof(monkeypatch):
    from stark_anatomy_tpu_torch.iop.stark import Stark

    prove, first = Stark.prove, []

    def stale(self, *a, **k):
        first.append(prove(self, *a, **k))
        return first[0]

    monkeypatch.setattr(Stark, "prove", stale)


def _wrong_trace(monkeypatch):
    from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime as ProgramRescuePrime

    trace_bytes = ProgramRescuePrime.trace_bytes

    def wrong(self, *a, **k):
        trace = trace_bytes(self, *a, **k).copy()
        trace[-1, 0, 0] ^= 1  # the claimed output
        return trace

    monkeypatch.setattr(ProgramRescuePrime, "trace_bytes", wrong)


def _frozen_zk_codeword(monkeypatch):
    # every prove's zk randomizer codeword drawn from one fixed seed
    from stark_anatomy_tpu_torch.iop.stark import Stark

    zk = Stark._zk_codeword
    monkeypatch.setattr(Stark, "_zk_codeword", lambda self, seed, *a, **k: zk(self, b"frozen", *a, **k))


def _fixed_padding(monkeypatch):
    # every prove pads its trace with the same rows
    from stark_anatomy_tpu_torch.iop.stark import Stark

    lde = Stark._trace_lde
    monkeypatch.setattr(Stark, "_trace_lde",
                        lambda self, trace, as_bytes, randomizer, device: lde(
                            self, trace, as_bytes, lambda r, j: 7 * r + j + 1, device))


def _prove_raises(monkeypatch):
    from stark_anatomy_tpu_torch.iop.stark import Stark

    def boom(self, *a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(Stark, "_combination", boom)


@pytest.mark.parametrize("fault,check,workers", [
    (_altered_answer, "proofs_rejected", 1),
    (_altered_answer, "proofs_rejected", 2),  # the proofs judged in worker processes
    (_fold_unchanged, "proofs_rejected", 1),
    (_half_the_columns, "proofs_rejected", 1),
    (_stale_proof, "proofs_repeated", 1),
    (_wrong_trace, "trace_faults", 1),
    (_prove_raises, "proves_failed", 1),
    (_frozen_zk_codeword, "zk_roots_repeated", 1),
    (_fixed_padding, "bq_roots_repeated", 1),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, check, workers):
    fault(monkeypatch)
    # more proves than statements, so that one statement is proved twice
    result = run_small("rescue-default.f24", workers=workers, seconds=4.0)
    assert result["attempted"] > harness.resolve("rescue-default.f24").traffic["statements"]
    assert not result["correct"] and result["failed"] >= 1
    assert result["checks"][check]["value"] > result["checks"][check]["limit"]
    if check.endswith("_roots_repeated"):  # every proof still verifies: only the repeat gives it away
        assert result["checks"]["proofs_rejected"]["value"] == 0



@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_and_the_sound_program_passes(name):
    r = control.readings(small_cell(name), SEED, proves=2, device="cpu", workers=1)
    assert all(v == 0 for v in r["sound"].values())
    assert r["control"]["proofs_rejected"] == 2


def test_statements_and_prove_seeds_come_from_the_seed():
    cell = harness.resolve("rescue-prod80.f24")
    a, b = harness.make_plan(cell, SEED), harness.make_plan(cell, SEED + 1)
    assert a.length == b.length == 32763 and len(set(a.inputs + b.inputs)) == 2 * cell.traffic["statements"]
    assert a == harness.make_plan(cell, SEED)
    assert [a.statement(i) for i in range(-2, 4)] == [1, 2, 0, 1, 2, 0]
    seeds = {a.prove_seed(i) for i in range(-2, 100)} | {b.prove_seed(i) for i in range(-2, 100)}
    assert len(seeds) == 204
    assert harness.make_plan(harness.resolve("rescue-default.f24"), 1).length == 32765
    assert harness.make_plan(harness.resolve("rescue-prod80.f26"), 1).length == 131067


def test_the_program_proves_the_statements_as_handed_over():
    cell = small_cell("rescue-default.f24")
    plan = harness.make_plan(cell, SEED)
    program = harness.Program(cell.config, plan, "cpu")
    traces = [t for t, _ in program.statements]
    ref = harness.reference_air(cell.config)
    assert len(traces) == len(plan.inputs) and len({ref.output(t) for t in traces}) == len(traces)
    assert all(ref.trace_faults(t, x, plan.length) == 0 for t, x in zip(traces, plan.inputs))
    seen = []
    prove = program.stark.prove
    program.stark.prove = lambda trace, *a, **k: seen.append(trace) or prove(trace, *a, **k)
    for i in range(4):
        assert program.prove(plan, i)[0] == i % 3
    assert all(t is traces[i % 3] for i, t in enumerate(seen))  # the statements in turn


def test_the_air_is_found_by_the_configurations_name(tmp_path, monkeypatch):
    cell = harness.resolve("rescue-prod80.f24")
    assert harness.air_module("airs", cell.config).__name__ == "benchmark.airs.rescue_prime"
    assert isinstance(harness.reference_air(cell.config), rescue_prime.RescuePrime)
    for kind in ("airs", "reference"):
        os.makedirs(tmp_path / kind)
        (tmp_path / kind / "toy_air.py").write_text(f"KIND = {kind!r}\n")
    monkeypatch.setattr(harness, "BENCH_DIR", str(tmp_path))
    monkeypatch.delitem(sys.modules, "benchmark.airs.toy_air", raising=False)
    monkeypatch.delitem(sys.modules, "benchmark.reference.toy_air", raising=False)
    toy = {"air": {"name": "toy_air"}}
    assert harness.air_module("airs", toy).KIND == "airs" and harness.air_module("reference", toy).KIND == "reference"
    with pytest.raises(KeyError):
        harness.air_module("airs", {"air": {"name": "no_such_air"}})


def test_every_field_of_the_air_reaches_the_program_or_is_refused():
    from benchmark.airs import rescue_prime as program_side

    air = harness.resolve("rescue-prod80.f24").config["air"]
    built = program_side.build(air, 3)
    assert (built.rp.m, built.rp.capacity, built.rp.N, built.rp.alpha, built.rp.rows_per_perm, built.chain_length) == (
        air["state_width"], air["capacity"], air["rounds"], air["alpha"], air["rows_per_perm"], 3)
    assert built.rp.round_constants == rescue_prime.from_config(air).round_constants
    with pytest.raises(ValueError, match="round constants"):
        program_side.build({**air, "constants_tag": "another/tag"}, 3)
    for side in (program_side.build, lambda a, _: rescue_prime.from_config(a)):
        with pytest.raises(ValueError, match="fields"):
            side({**air, "unknown": 1}, 3)
