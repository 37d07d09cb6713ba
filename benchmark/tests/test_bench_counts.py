"""The work counts against hand counts, the device-trace reduction, and the
end-to-end statistics."""

import json
import statistics

import pytest

from benchmark import devtrace, generator, harness, work

TEST_PROFILE = {"expansion_factor": 4, "num_colinearity_checks": 2, "grinding_bits": 0, "num_randomizers": 8}
AIR = json.load(open(harness.os.path.join(harness.BENCH_DIR, "configs", "rescue-prod80.json")))["air"]


def _shape(stark: dict, chain: int):
    return harness.reference_verifier({"air": AIR, "stark": stark}, generator.Plan(0, chain, (1,)))


def test_shapes_of_the_cells_and_of_the_small_proof():
    small = _shape(TEST_PROFILE, 1)  # 33 rows + 8 randomizers: O = 64, F = 1024
    assert (small.o, small.f, small.degree_target + 1, small.fri_rounds) == (64, 1024, 256, 7)
    prod = json.load(open(harness.os.path.join(harness.BENCH_DIR, "configs", "rescue-prod80.json")))["stark"]
    big = _shape(prod, 32763)
    assert (big.o, big.f, big.fri_rounds) == (1 << 20, 1 << 24, 17)


def test_ntt_counts_by_hand():
    # F = 1024: 2 iNTTs of 64 (32 * 6 butterflies), 2 extensions and the zk
    # evaluation onto 1024 (512 * 10)
    assert work.ntt_work(2, 64, 1024, 256) == (2 * 192 + 3 * 5120, 16 * (2 * 128 + 2 * 1088 + 1280))
    # F = 2^24: 2 * 2^19 * 20 + 3 * 2^23 * 24
    butterflies, _ = work.ntt_work(2, 1 << 20, 1 << 24, 1 << 22)
    assert butterflies == 20_971_520 + 603_979_776


def test_blake2b_counts_by_hand():
    # F = 1024, 7 FRI rounds: the boundary-quotient and zk trees 512 leaves
    # + 511 nodes each; FRI round r: (1024 >> r) / 2 leaves + as many - 1 nodes
    compressions, _ = work.blake2b_work(2, 1024, 7)
    assert compressions == 1023 + 1023 + (1024 + 512 + 256 + 128 + 64 + 32 + 16 - 7)
    # F = 2^24 under production-80 (17 rounds): 2^24 - 1 twice, sum over FRI
    compressions, _ = work.blake2b_work(2, 1 << 24, 17)
    assert compressions == 2 * ((1 << 24) - 1) + sum((1 << 24 >> r) - 1 for r in range(17))
    # a leaf of 5 registers' pairs (160 B) takes two blocks
    assert work._tree(4, 160)[0] == 4 * 2 + 3


def test_least_time_is_the_larger_bound():
    assert work.least_s(33.5e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 3.35e12) == pytest.approx(1.0)
    least = work.prove_work(_shape(TEST_PROFILE, 1))
    assert least["ntt"] == pytest.approx(15744 * 84 / 33.5e12)


def test_union_does_not_count_overlaps_twice():
    assert devtrace.union_length([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
    assert devtrace.idle_gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [(0, 2), (6, 8), (9, 10)]


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction(tmp_path):
    events = [
        _x(devtrace.PROVE_SPAN, "user_annotation", 0, 100),
        _x("prove.fri", "user_annotation", 40, 60),
        _x("host-tail", "user_annotation", 70, 20),
        _x("void ntt_stage_kernel<true>(unsigned*, long)", "kernel", 10, 20),
        _x("ntt_block_kernel(unsigned const*, long)", "kernel", 20, 20),  # overlaps the first
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 50, 5),
        _x("void blake2b_planes_kernel(unsigned const*)", "kernel", 95, 10),  # runs past the window
        _x("aten::add", "cpu_op", 0, 1),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = devtrace.reduce(str(path))
    assert r["proves"] == 1 and r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((30 + 5 + 5) * 1e-6)
    assert r["launches"] == 3
    assert r["kernels"] == pytest.approx({"ntt_stage_kernel": 20e-6, "ntt_block_kernel": 20e-6,
                                          "blake2b_planes_kernel": 5e-6})
    # idle: 0-10 outside any phase, 40-50,
    # 55-70 and 90-95 in prove.fri, 70-90 in host-tail
    assert r["gaps"] == pytest.approx({"outside any prove phase": 10e-6, "prove.fri": 30e-6,
                                       "host-tail": 20e-6})
    assert devtrace.kernel_base("void ns::k<1>(int)") == "k"
    # the program's kernels, as the profiler names them on the card
    assert devtrace.kernel_base("(anonymous namespace)::ntt_stage_kernel(unsigned int*, long, int)") == "ntt_stage_kernel"
    assert devtrace.kernel_base("void (anonymous namespace)::fp_binary_kernel<0>(unsigned int const*)") == "fp_binary_kernel"
    assert devtrace.kernel_base("void at::native::vectorized_elementwise_kernel<4, at::native::Op>(int, Op)") \
        == "vectorized_elementwise_kernel"


def _ctx(**kw):
    ctx = {"proves": 4, "window_s": 2.0, "walls": [0.4, 0.5, 0.5, 0.6], "setup_s": 9.0, "peak_bytes": 8e9,
           "phases": {}, "profile": None, "work": {"ntt": 1e-3, "blake2b": 5e-3}, "kernel_metric": {}}
    ctx.update(kw)
    return ctx


def test_prove_p90_is_over_all_proves():
    walls = [0.1 * k for k in range(1, 11)] + [3.0]
    read = harness._reader("prove_p90_s")
    assert read(_ctx(walls=walls)) == pytest.approx(statistics.quantiles(walls, n=10, method="inclusive")[-1])
    assert read(_ctx(walls=[0.7])) == 0.7
    assert harness._reader("prove_s")(_ctx()) == 0.5
    assert harness._reader("peak_mem_gb")(_ctx()) == 8.0


def test_device_metrics_from_a_profile():
    prof = {"proves": 2, "window_s": 3.0, "busy_s": 0.3, "launches": 3000,
            "kernels": {"ntt_stage_kernel": 0.004, "ntt_block_kernel": 0.001, "blake2b_planes_kernel": 0.02}}
    ctx = _ctx(profile=prof, kernel_metric=harness.kernel_metrics())
    assert harness._reader("device_idle")(ctx) == pytest.approx(70.0)  # 0.15 s busy of 0.5 s
    assert harness._reader("launches_per_prove")(ctx) == 1500
    assert harness._reader("device_busy_ms")(ctx) == pytest.approx(150.0)
    assert harness._reader("ntt_roofline")(ctx) == pytest.approx(40.0)  # 1 ms of 2.5 ms a prove
    assert harness._reader("blake2b_roofline")(ctx) == pytest.approx(50.0)
    assert harness._reader("ntt_roofline")(_ctx()) is None  # no trace: nothing to read
    ctx = _ctx(phases={"prove.fri": 0.4, "prove.fri.host-tail": 0.1, "prove.fri.grind": 0.2})
    assert harness._reader("fri_ms")(ctx) == pytest.approx(25.0)
    assert harness._reader("grind_ms")(ctx) == pytest.approx(50.0)
    assert harness._reader("lde_ms")(ctx) is None
