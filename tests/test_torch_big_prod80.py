"""PyTorch port, the chunked big-domain prover (Stark._prove_big) under the
production-80 profile (32 queries, 16 grinding bits, 128 randomizers), the
way the benchmark's cell rescue-prod80.f28 runs it at F = 2^28, forced on at
a CPU size: chain 59 (1889 rows + 128 randomizers fit O = 2^11), F = 2^15,
chunks of 2^13 columns, so that every tree (the zk codeword's, the boundary
quotients', FRI round 0's) takes two ChunkedPairCommit adds of 2^13 leaves.

Checks the proof's bytes against the standard path's, the benchmark's plain
reference (benchmark/reference/) against the proof and the trace, that a
corrupted host copy of one quotient chunk is caught, and the spans that only
the big path opens (to-host, chunk-commit, excluded-factor; merkle-commit
around the boundary quotients' chunked commit) with their calls a prove.
Tolerance 0: all exact integer math."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference import rescue_prime as ref_rescue
from benchmark.reference.verifier import Verifier
from stark_anatomy_tpu_torch.iop import stark as stark_mod
from stark_anatomy_tpu_torch.iop.stark import PROFILES, Stark
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir
from stark_anatomy_tpu_torch.utils import telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN = 59
INPUT = 2**31 + 1501
SEED = b"big-prod80"
F = 1 << 15
BLK = 1 << 13  # the forced _BIG_CHUNK: F/BLK = 4 chunks, 2 mirrored pairs a tree
#: spans only the big path opens
BIG_ONLY = ("to-host", "chunk-commit", "excluded-factor")


def _config() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", "rescue-prod80-f28.json")) as fh:
        return json.load(fh)


def _stark() -> Stark:
    s = _config()["stark"]
    profile = PROFILES["production-80"]
    assert (s["expansion_factor"], s["num_colinearity_checks"], s["grinding_bits"]) == (
        profile["expansion_factor"], profile["num_colinearity_checks"], profile["grinding_bits"])
    stark = Stark(RescuePrimeAir(RescuePrime(), chain_length=CHAIN), device="cpu", **s)
    assert (stark.omicron_domain_length, stark.fri_domain_length) == (1 << 11, F)
    return stark


def _calls(report: dict, span: str) -> dict:
    """{dotted name: calls} of every entry of `span` in a report."""
    return {k: v["calls"] for k, v in report.items() if k.split(".")[-1] == span}


def _prove(stark, trace, boundary) -> tuple:
    telemetry.reset()
    proof = stark.prove(trace, boundary, randomizer_seed=SEED)
    return proof, telemetry.report()


def _roll_one_chunk(real):
    """copy_to_numpy whose second quotient copy of every prove (register 1's
    first chunk) lands rolled by one column: canonical values, the wrong ones."""
    count = []

    def copy(dst, src):
        real(dst, src)
        count.append(1)
        if len(count) % (2 * F // BLK) == 2:  # 2 registers, F/BLK chunks a prove
            dst[:] = np.roll(dst, 1, axis=1)

    return copy


@pytest.fixture(scope="module")
def proves():
    """The standard prove, the forced big prove and a big prove with one
    quotient chunk's host copy corrupted, with their reports."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    try:
        stark = _stark()
        trace = stark.air.rp.trace_bytes(INPUT, CHAIN)
        output = int.from_bytes(trace[-1, 0].tobytes(), "little")
        boundary = stark.air.boundary_constraints(output)
        assert not stark._big
        standard = _prove(stark, trace, boundary)
        mp.setattr(stark_mod, "_BIG_F_MIN", 1)
        mp.setattr(stark_mod, "_BIG_CHUNK", BLK)
        assert stark._big and stark._big_chunk_len() == BLK
        big = _prove(stark, trace, boundary)
        mp.setattr(stark_mod, "copy_to_numpy", _roll_one_chunk(stark_mod.copy_to_numpy))
        corrupted = _prove(stark, trace, boundary)
        return {"stark": stark, "trace": trace, "output": output, "boundary": boundary,
                "standard": standard, "big": big, "corrupted": corrupted}
    finally:
        mp.undo()
        torch.set_num_threads(threads)


def _reference() -> Verifier:
    c = _config()
    s = c["stark"]
    return Verifier(ref_rescue.from_config(c["air"]), s["expansion_factor"], s["num_colinearity_checks"],
                    s["grinding_bits"], s["num_randomizers"], CHAIN)


def test_the_big_path_gives_the_standard_paths_bytes(proves):
    assert proves["big"][0] == proves["standard"][0] != b""
    assert proves["stark"].verify(proves["big"][0], proves["boundary"])


def test_the_plain_reference_accepts_the_big_proof_and_the_trace(proves):
    ref = _reference()
    assert (ref.o, ref.f) == (1 << 11, F)
    assert ref.verify(proves["big"][0], proves["output"])
    assert ref.air.trace_faults(proves["trace"], INPUT, CHAIN) == 0
    assert ref.air.output(proves["trace"]) == proves["output"]


@pytest.mark.parametrize("judge", ["program", "reference"])
def test_a_corrupted_host_copy_of_one_quotient_chunk_is_rejected(proves, judge):
    proof = proves["corrupted"][0]
    assert proof != proves["big"][0]
    if judge == "program":
        assert not proves["stark"].verify(proof, proves["boundary"])
    else:
        assert not _reference().verify(proof, proves["output"])


def _big_calls(stark, standard_report) -> dict:
    """{span: {dotted name: calls}} a big prove opens: w F/blk + 2 copies to
    the host, 3 F/(2 blk) chunk adds, F/blk excluded-row factors, and the
    standard path's commits with the boundary quotients' one commit replaced
    by a merkle-commit around each of its F/(2 blk) adds and its finish."""
    f, w = stark.fri_domain_length, stark.num_registers
    chunks, pairs = f // BLK, f // BLK // 2
    commits = _calls(standard_report, "merkle-commit")
    del commits["prove.bq-commit.merkle-commit"]
    return {
        "to-host": {"prove.boundary-quotients.to-host": w * chunks, "prove.host-offload.to-host": 1,
                    "prove.fri.to-host": 1},
        "chunk-commit": {f"{tree}.merkle-commit.chunk-commit": pairs for tree in
                         ("prove.zk-randomizer", "prove.boundary-quotients", "prove.fri")},
        "excluded-factor": {"prove.quotients-combination.excluded-factor": chunks},
        "merkle-commit": {**commits, "prove.boundary-quotients.merkle-commit": pairs + 1},
    }


@pytest.mark.parametrize("span", BIG_ONLY + ("merkle-commit",))
def test_the_big_prove_opens_each_span_the_expected_number_of_times(proves, span):
    expected = _big_calls(proves["stark"], proves["standard"][1])[span]
    assert _calls(proves["big"][1], span) == expected
    w, f = proves["stark"].num_registers, proves["stark"].fri_domain_length
    total = {"to-host": w * f // BLK + 2, "chunk-commit": 3 * f // (2 * BLK), "excluded-factor": f // BLK}
    if span in total:
        assert sum(expected.values()) == total[span]


@pytest.mark.parametrize("span", BIG_ONLY)
def test_a_standard_prove_opens_none_of_the_big_paths_spans(proves, span):
    assert _calls(proves["standard"][1], span) == {}
    assert "prove.host-offload" not in proves["standard"][1]
