"""The cell rescue-prod80.f28, the program's chunked big-domain path at
F = 2^28: its shape as the reference derives it, the readers of the spans
only that path opens (d2h_ms, chunk_commit_ms, excluded_factor_ms), and a
whole run of the harness on the CPU with the big path forced at a small
size: sound, it is correct; with one quotient chunk's host copy altered, it
is not."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import harness

CELL = "rescue-prod80.f28"
READERS = ("d2h_ms", "chunk_commit_ms", "excluded_factor_ms")
SEED = 2**31 + 2801
#: the cut of the CPU run: O = 2^11, F = 2^15, chunks of 2^13 columns (two
#: mirrored chunk pairs a tree, ChunkedPairCommit adds of 2^13 leaves)
SMALL_LOG2, SMALL_CHUNK = 11, 1 << 13


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_the_cells_shape_as_the_reference_derives_it():
    from benchmark.airs import rescue_prime as program_side
    from stark_anatomy_tpu_torch.iop.stark import Stark

    cell = harness.resolve(CELL)
    assert cell.chips == 1 and cell.traffic["trace_domain_log2"] == 24 and cell.traffic["statements"] == 3
    plan = harness.make_plan(cell, SEED)
    ref = harness.reference_verifier(cell.config, plan)
    assert plan.length == 524283 and ref.rows == 16777057 and ref.rows + 128 <= 1 << 24
    assert (ref.o, ref.f, ref.degree_target + 1, ref.fri_rounds) == (1 << 24, 1 << 28, 1 << 26, 21)
    stark = Stark(program_side.build(cell.config["air"], plan.length), device="cpu", **cell.config["stark"])
    assert (stark.omicron_domain_length, stark.fri_domain_length, stark.fri.num_rounds) == (ref.o, ref.f, 21)
    assert stark._big and stark._big_chunk_len() == 1 << 22  # 64 chunks, 32 mirrored pairs a tree
    assert {m["name"] for m, _ in cell.per_layer} == set(READERS)


def test_the_configuration_states_the_statement_the_cell_proves():
    cell = harness.resolve(CELL)
    plan = harness.make_plan(cell, SEED)
    ref = harness.reference_verifier(cell.config, plan)
    s = cell.config["statement"]
    assert (s["chain_length"], s["rows"]) == (plan.length, ref.rows)
    assert (1 << s["trace_domain_log2"], 1 << s["fri_domain_log2"]) == (ref.o, ref.f)
    assert s["trace_domain_log2"] == cell.traffic["trace_domain_log2"]
    # the production-80 deployment of the other cells, at this statement
    prod80 = harness.resolve("rescue-prod80.f24").config
    assert cell.config["name"] != prod80["name"]
    assert {k: v for k, v in cell.config.items() if k not in ("name", "source", "statement")} == {
        k: v for k, v in prod80.items() if k not in ("name", "source")}


def _ctx(phases, proves=2):
    return {"phases": phases, "proves": proves}


def test_readers_of_a_big_window_with_the_device_clock():
    phases = {
        "prove.boundary-quotients.to-host@device": 4.0, "prove.boundary-quotients.to-host": 4.4,
        "prove.host-offload.to-host@device": 1.5, "prove.fri.to-host@device": 1.5,
        "prove.fri.to-host-tail@device": 9.0,  # the host tail's copy: another span
        "prove.zk-randomizer.merkle-commit.chunk-commit@device": 0.1,
        "prove.boundary-quotients.merkle-commit.chunk-commit@device": 0.3,
        "prove.fri.merkle-commit.chunk-commit@device": 0.2, "prove.fri.merkle-commit@device": 0.4,
        "prove.quotients-combination.excluded-factor@device": 1.6,
        "prove.quotients-combination.excluded-factor": 0.1, "verify.fri": 9.0,
    }
    got = {name: harness._reader(name)(_ctx(phases)) for name in READERS}
    assert got == pytest.approx({"d2h_ms": 3500.0, "chunk_commit_ms": 300.0, "excluded_factor_ms": 800.0})


@pytest.mark.parametrize("phases", [
    # a standard prove, or a program without the spans
    {"prove.trace-lde": 0.5, "prove.bq-commit.merkle-commit@device": 0.02, "prove.fri.to-host-tail@device": 0.01},
    # a big prove on the CPU: host clocks alone
    {"prove.boundary-quotients.to-host": 0.3, "prove.fri.merkle-commit.chunk-commit": 0.1,
     "prove.quotients-combination.excluded-factor": 0.2},
], ids=["no-span", "cpu"])
def test_readers_find_nothing_without_the_device_clock_of_the_spans(phases):
    assert {name: harness._reader(name)(_ctx(phases)) for name in READERS} == dict.fromkeys(READERS)


def _force_big(monkeypatch):
    from stark_anatomy_tpu_torch.iop import stark as stark_mod

    monkeypatch.setattr(stark_mod, "_BIG_F_MIN", 1)
    monkeypatch.setattr(stark_mod, "_BIG_CHUNK", SMALL_CHUNK)


def _altered_chunk_copy(monkeypatch):
    # the host copy of one quotient chunk a prove lands rolled by a column
    from stark_anatomy_tpu_torch.iop import stark as stark_mod

    real, count = stark_mod.copy_to_numpy, []

    def copy(dst, src):
        real(dst, src)
        count.append(1)
        if len(count) % 8 == 3:  # 2 registers x 4 chunks a prove
            dst[:] = np.roll(dst, 1, axis=1)

    monkeypatch.setattr(stark_mod, "copy_to_numpy", copy)


@pytest.mark.parametrize("fault", [None, _altered_chunk_copy], ids=["sound", "altered-chunk-copy"])
def test_a_small_run_on_the_big_path(monkeypatch, fault):
    from stark_anatomy_tpu_torch.iop.stark import Stark

    _force_big(monkeypatch)
    paths = []
    prove_big = Stark._prove_big
    monkeypatch.setattr(Stark, "_prove_big", lambda self, *a: paths.append(self.fri_domain_length) or prove_big(self, *a))
    if fault is not None:
        fault(monkeypatch)
    cell = harness.resolve(CELL)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "trace_domain_log2": SMALL_LOG2})
    result, _ = harness.run(cell, SEED, 0.5, False, device="cpu", workers=1)
    assert result["attempted"] >= 1 and paths == [1 << 15] * (harness.WARMUP_PROVES + result["attempted"])
    if fault is None:
        assert result["correct"] and result["failed"] == 0
        assert all(c["value"] == 0 for c in result["checks"].values())
        assert set(result["metrics"]) == {"prove_s", "prove_p90_s", "setup_s"}  # no device memory on the CPU
    else:
        assert not result["correct"] and result["failed"] == result["attempted"]
        assert result["checks"]["proofs_rejected"]["value"] == result["attempted"]
