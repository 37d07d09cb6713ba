"""PyTorch port, telemetry (utils/telemetry.py): the spans a prove opens,
their device clock (CUDA timing events read lazily, no synchronise), the
host's waits on the device (device-wait) and the profiler ranges.

CPU tests run a chain-1 Rescue-Prime prove with FRI's host tail at 64, so
that four FRI rounds run (and commit) on the prover's device. Tests marked
`cuda` need an NVIDIA card and skip inside their fixture without one:

    python -m pytest --noconftest tests/test_torch_telemetry.py -m cuda -q
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

from stark_anatomy_tpu_torch.iop.stark import Stark
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir
from stark_anatomy_tpu_torch.parallel.mesh import make_mesh
from stark_anatomy_tpu_torch.utils import telemetry

INPUT = 20260817
TAIL = 64  # FRI codewords of at most 64 values finish on the host
#: the spans the benchmark's per-layer metrics read, with their meaning
BENCHMARK_SPANS = ("prove.trace-lde", "prove.zk-randomizer", "prove.quotients-combination",
                   "prove.fri", "prove.fri.host-tail", "prove.fri.grind")
#: the calls-only entry under prove.trace-lde: the trace laid out on the device
LDE_LAYOUT_COUNT = "lde-layout.device"


def _setup(device: str):
    rp = RescuePrime()
    air = RescuePrimeAir(rp, chain_length=1)
    stark = Stark(air, expansion_factor=4, num_colinearity_checks=2, grinding_bits=2,
                  fri_host_tail_n=TAIL, device=device)
    return rp, stark, air.boundary_constraints(rp.hash(INPUT))


def _prove(device: str) -> dict:
    """report() of one chain-1 prove on `device` (the proof verified)."""
    rp, stark, boundary = _setup(device)
    telemetry.reset()
    proof = stark.prove(rp.trace(INPUT), boundary, randomizer_seed=b"telemetry")
    rep = telemetry.report()
    assert stark.verify(proof, boundary)
    return rep


def _device_rounds(stark) -> int:
    """FRI rounds committed on the prover's device: those longer than the tail."""
    n, rounds = stark.fri_domain_length, 0
    while rounds < stark.fri.num_rounds and n > stark.fri_host_tail_n:
        n //= 2
        rounds += 1
    return rounds


def _waits(rep: dict) -> int:
    return sum(v["calls"] for k, v in rep.items() if k.split(".")[-1] == telemetry.DEVICE_WAIT)


# -- the CPU prove ------------------------------------------------------------


def test_a_cpu_prove_opens_every_span_the_expected_number_of_times():
    rep = _prove("cpu")
    _, stark, _ = _setup("cpu")
    rounds = _device_rounds(stark)
    assert rounds == 4
    for name in BENCHMARK_SPANS:
        assert rep[name]["calls"] == 1 and rep[name]["seconds"] > 0
    w = stark.num_registers
    calls = {k: v["calls"] for k, v in rep.items() if k.startswith("prove.") and k.count(".") > 1}
    assert calls == {
        "prove.trace-lde.lde-layout.device": 1,
        "prove.trace-lde.lde-host": 1,
        "prove.trace-lde.lde-upload": 1,
        "prove.trace-lde.lde-layout": 1,
        "prove.trace-lde.lde-ntt": w,
        "prove.bq-commit.merkle-commit": 1,
        "prove.zk-randomizer.zk-draw": 1,
        "prove.zk-randomizer.zk-ntt": 1,
        "prove.zk-randomizer.merkle-commit": 1,
        "prove.fri.merkle-commit": rounds,
        "prove.fri.fri-fold": rounds,
        "prove.fri.to-host-tail": 1,
        "prove.fri.host-tail": 1,
        "prove.fri.grind": 1,
        "prove.fri.queries": 1,
        "prove.fri.queries.query-gather": 1,
    }
    # nothing waits on a device on the CPU, and nothing has a device clock
    assert _waits(rep) == 0
    assert not [k for k in rep if k.endswith(telemetry.DEVICE_SUFFIX)]


@pytest.mark.parametrize("mesh", [False, True], ids=["no mesh", "mesh"])
@pytest.mark.parametrize("as_bytes", [True, False], ids=["byte trace", "int trace"])
def test_the_trace_lde_counts_where_the_trace_was_laid_out(as_bytes, mesh):
    """A byte trace, and an int trace once encoded, is uploaded once and laid
    out in one lde-layout span on the prover's device, with a mesh or
    without; then one lde-ntt a column. Every form gives the same proof."""
    rp, stark, boundary = _setup("cpu")
    if mesh:
        stark = Stark(stark.air, expansion_factor=4, num_colinearity_checks=2, grinding_bits=2,
                      fri_host_tail_n=TAIL, mesh=make_mesh(4, "cpu"))
    trace = rp.trace_bytes(INPUT) if as_bytes else rp.trace(INPUT)
    telemetry.reset()
    proof = stark.prove(trace, boundary, randomizer_seed=b"telemetry")
    rep = telemetry.report()
    w = stark.num_registers
    lde = {k[len("prove.trace-lde."):]: v["calls"] for k, v in rep.items() if k.startswith("prove.trace-lde.")}
    assert lde == {LDE_LAYOUT_COUNT: 1, "lde-host": 1, "lde-upload": 1, "lde-layout": 1, "lde-ntt": w}
    assert rep["prove.trace-lde.lde-host"]["seconds"] > 0
    assert proof == _setup("cpu")[1].prove(rp.trace_bytes(INPUT), boundary, randomizer_seed=b"telemetry")


def test_a_cpu_prove_makes_no_cuda_call(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call on the CPU path")

    for name in ("Event", "current_stream", "synchronize", "is_available", "current_device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    rep = _prove("cpu")
    assert "prove.fri" in rep and not [k for k in rep if "@" in k or "device-wait" in k]


# -- the device clock, with a fake event class ----------------------------------


class FakeClock:
    """A device timeline: FakeEvent.record() stamps the current time."""

    def __init__(self):
        self.now = 0.0
        self.done = float("inf")  # the device has run what was recorded up to this time
        self.events = 0
        self.waits = 0


def fake_events(monkeypatch) -> FakeClock:
    clock = FakeClock()

    class FakeEvent:
        def __init__(self, enable_timing=False):
            assert enable_timing
            clock.events += 1
            self.t = None

        def record(self, stream=None):
            self.t = clock.now

        def query(self):
            return self.t <= clock.done

        def elapsed_time(self, end):
            if not end.query():
                raise RuntimeError("CUDA error: device not ready")
            return (end.t - self.t) * 1e3  # milliseconds, as torch's

        def synchronize(self):
            clock.waits += 1
            clock.done = float("inf")

    def refuse(*args, **kwargs):
        raise AssertionError("telemetry synchronised the device")

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(telemetry, "_idle_events", {})
    telemetry.reset()
    return clock


def test_device_entries_sum_the_elapsed_pairs_and_nothing_synchronises(monkeypatch):
    clock = fake_events(monkeypatch)
    cuda = torch.device("cuda")
    for step in (0.5, 0.25):
        with telemetry.device_phase("outer", cuda):
            clock.now += 1.0
            with telemetry.phase("inner"):  # inherits the device clock
                clock.now += step
            with telemetry.device_phase("host", "cpu"):  # a CPU span stops it
                clock.now += 2.0
    rep = telemetry.report()
    assert rep["outer@device"] == {"seconds": pytest.approx(1.0 + 0.5 + 2.0 + 1.0 + 0.25 + 2.0), "calls": 2}
    assert rep["outer.inner@device"] == {"seconds": pytest.approx(0.75), "calls": 2}
    assert "outer.host@device" not in rep and rep["outer.host"]["calls"] == 2
    assert set(rep) == {"outer", "outer.inner", "outer.host", "outer@device", "outer.inner@device"}
    assert clock.waits == 1  # report() waited on the last event alone


def test_pairs_are_read_after_each_device_wait_and_events_are_reused(monkeypatch):
    clock = fake_events(monkeypatch)
    cuda = torch.device("cuda")
    for _ in range(1000):
        with telemetry.device_phase("round", cuda):
            clock.now += 0.001
            with telemetry.phase("commit"):
                clock.now += 0.001
            with telemetry.device_wait(cuda):
                with telemetry.device_wait(cuda):  # does not nest
                    pass
        assert len(telemetry._pending) <= 2
    assert clock.events <= 8  # the read events are recorded again
    rep = telemetry.report()
    assert rep["round.device-wait"]["calls"] == 1000 and "round.device-wait.device-wait" not in rep
    assert "round.device-wait@device" not in rep  # a wait has the host clock alone
    assert rep["round.commit@device"]["seconds"] == pytest.approx(1.0)
    assert rep["round@device"]["seconds"] == pytest.approx(2.0)
    assert clock.waits <= 1


def test_unread_pairs_stay_bounded_without_a_wait(monkeypatch):
    clock = fake_events(monkeypatch)
    for _ in range(5 * telemetry._MAX_PENDING):
        with telemetry.device_phase("span", "cuda"):
            clock.now += 1.0
        assert len(telemetry._pending) <= telemetry._MAX_PENDING + 1
    assert clock.events <= 2 * (telemetry._MAX_PENDING + 2)
    assert telemetry.report()["span@device"] == {"seconds": pytest.approx(5 * telemetry._MAX_PENDING),
                                                 "calls": 5 * telemetry._MAX_PENDING}


def test_a_pair_not_done_after_a_wait_is_read_later(monkeypatch):
    # a span on a stream the wait did not drain: elapsed_time refuses, and
    # the pairs that are done are read by query
    clock = fake_events(monkeypatch)
    with telemetry.device_phase("early", "cuda"):
        clock.now += 1.0
    clock.done = clock.now
    with telemetry.device_phase("late", "cuda"):
        clock.now += 2.0
    with telemetry.device_wait("cuda"):
        pass
    assert [p[0] for p in telemetry._pending] == ["late@device"]
    rep = telemetry.report()
    assert rep["early@device"]["seconds"] == pytest.approx(1.0) and rep["late@device"]["seconds"] == pytest.approx(2.0)
    assert clock.waits == 1

def test_a_count_adds_calls_alone_under_the_open_span(monkeypatch):
    clock = fake_events(monkeypatch)
    with telemetry.device_phase("outer", "cuda"):
        with telemetry.phase("to-host"):
            events = clock.events
            telemetry.count("pinned")
            telemetry.count("pinned")
            assert clock.events == events  # no device event
        telemetry.count("pageable")
    telemetry.count("bare")
    rep = telemetry.report()
    assert {k: v for k, v in rep.items() if k.endswith(("pinned", "pageable", "bare"))} == {
        "outer.to-host.pinned": {"seconds": 0.0, "calls": 2}, "outer.pageable": {"seconds": 0.0, "calls": 1},
        "bare": {"seconds": 0.0, "calls": 1}}
    assert set(rep) == {"outer", "outer@device", "outer.to-host", "outer.to-host@device",
                        "outer.to-host.pinned", "outer.pageable", "bare"}


def test_device_wait_is_nothing_on_the_cpu():
    telemetry.reset()
    with telemetry.phase("outer"):
        with telemetry.device_wait("cpu"), telemetry.device_wait(torch.device("cpu")):
            pass
    assert set(telemetry.report()) == {"outer"}


# -- profiler ranges and the log ----------------------------------------------------


class CountingRange:
    entered = 0

    def __init__(self, name):
        self.inner = torch.autograd.profiler.record_function(name)

    def __enter__(self):
        CountingRange.entered += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


def test_no_profiler_range_is_entered_without_a_profiler(monkeypatch):
    monkeypatch.setattr(telemetry, "record_function", CountingRange)
    CountingRange.entered = 0
    rep = _prove("cpu")
    assert sum(v["calls"] for v in rep.values()) > 20 and CountingRange.entered == 0


def test_under_a_profiler_every_span_is_a_range_under_its_name(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rep = _prove("cpu")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges[e["name"]] = ranges.get(e["name"], 0) + 1
    opened = {}
    for name, v in rep.items():
        if name.endswith(LDE_LAYOUT_COUNT):  # a count, not a span: no range
            continue
        short = name.split(".")[-1] if not name.startswith("prove.") or name.count(".") > 1 else name
        opened[short] = opened.get(short, 0) + v["calls"]
    assert opened == {k: ranges.get(k, 0) for k in opened}
    assert opened["merkle-commit"] == 2 + 4 and opened["prove.trace-lde"] == 1


def test_the_log_setting_is_read_once_and_its_lines_are_host_clock(monkeypatch, capsys):
    monkeypatch.setenv("STARK_ANATOMY_LOG", "1")
    with telemetry.phase("quiet"):  # the setting was read at import, unset
        pass
    assert capsys.readouterr().err == ""
    monkeypatch.setattr(telemetry, "_LOG", True)
    with telemetry.phase("outer"):
        with telemetry.phase("inner"):
            pass
    lines = [json.loads(line) for line in capsys.readouterr().err.splitlines()]
    assert [line["phase"] for line in lines] == ["outer.inner", "outer"]
    assert all(set(line) == {"phase", "seconds"} for line in lines)


def test_the_cli_prints_host_and_device_seconds_side_by_side(monkeypatch, capsys):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from stark_anatomy_tpu_torch.prove_rescue import main

    split = {"prove.fri": {"seconds": 1.5, "calls": 1}, "prove.fri@device": {"seconds": 0.25, "calls": 1},
             "verify.fri": {"seconds": 0.125, "calls": 1}}
    monkeypatch.setattr(telemetry, "report", lambda: split)
    assert main(["--input", str(INPUT), "--chain", "1", "--checks", "2", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "  prove.fri: 1.50s host, 0.25s device\n" in printed and "  verify.fri: 0.12s\n" in printed
    assert "prove.fri@device" not in printed
    assert chip_smoke.cli_numbers(printed)["split_s"] == {"prove.fri": 1.5, "verify.fri": 0.12}


# -- on the card ---------------------------------------------------------------------


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA timing events and kernels have no CPU mode: needs an NVIDIA GPU")


@pytest.mark.cuda
def test_the_device_clock_of_a_transform_matches_a_plain_event_pair(card):
    from stark_anatomy_tpu_torch.ops import ntt as nttmod
    from stark_anatomy_tpu_torch.ops import ntt_kernels
    from stark_anatomy_tpu_torch.ops.limbs import random_felt_words, to_tensor

    n = 1 << 20
    x = to_tensor(random_felt_words(np.random.default_rng(7), n), "cuda")
    tw = nttmod._twiddles(n, False, "cuda")
    ntt_kernels.transform(x, tw)  # loads the kernels
    plain, spanned = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        ntt_kernels.transform(x, tw)
        b.record()
        b.synchronize()
        plain.append(a.elapsed_time(b))
        torch.cuda.synchronize()
        telemetry.reset()
        with telemetry.device_phase("transform", "cuda"):
            ntt_kernels.transform(x, tw)
        spanned.append(telemetry.report()["transform@device"]["seconds"] * 1e3)
    plain_ms, spanned_ms = sorted(plain)[2], sorted(spanned)[2]
    assert abs(spanned_ms - plain_ms) <= 0.1 * plain_ms, (plain, spanned)


@pytest.mark.cuda
def test_every_synchronising_operation_of_a_prove_is_inside_a_device_wait(card, monkeypatch):
    """Every operation that torch reports as synchronising (its sync debug
    mode), and every explicit synchronise, runs inside a device-wait: one at
    each phase's end, one in each device commit, one at the switch to the
    host tail, one for each gather (its index uploads and its copy back)."""
    _prove("cuda")  # builds the kernels and fills the tables
    explicit, implicit = [], []
    synchronize = torch.cuda.synchronize

    def counted(device=None):
        explicit.append(telemetry._state.full)
        torch.cuda.set_sync_debug_mode(0)
        try:
            synchronize(device)
        finally:
            torch.cuda.set_sync_debug_mode(1)

    def show(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            implicit.append(telemetry._state.name)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        monkeypatch.setattr(warnings, "showwarning", show)
        torch.cuda.set_sync_debug_mode(1)
        try:
            rep = _prove("cuda")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert implicit and set(implicit) == {telemetry.DEVICE_WAIT}
    phases = ("trace-lde", "boundary-quotients", "bq-commit", "zk-randomizer", "quotients-combination",
              "fri", "open")
    assert explicit == [f"prove.{p}.device-wait" for p in phases]
    # a gather's index uploads and its copy back are one wait
    assert len(explicit) < _waits(rep) < len(implicit) + len(explicit)
    for commit in ("prove.bq-commit.merkle-commit", "prove.zk-randomizer.merkle-commit",
                   "prove.fri.merkle-commit"):
        assert rep[commit + ".device-wait"]["calls"] == rep[commit]["calls"]
    assert rep["prove.fri.to-host-tail.device-wait"]["calls"] == 1
    assert rep["prove.fri.queries.query-gather.device-wait"]["calls"] == 1
    for name in BENCHMARK_SPANS + ("prove.zk-randomizer.zk-draw", "prove.trace-lde.lde-upload"):
        assert rep[name + telemetry.DEVICE_SUFFIX]["seconds"] > 0


def test_a_prove_runs_with_every_phase_replaced_by_a_one_argument_wrapper(monkeypatch):
    # a profiler harness may rebind every module attribute that is
    # telemetry.phase to a wrapper of one argument, the name
    original, seen = telemetry.phase, []

    def wrapper(name):
        seen.append(name)
        return original(name)

    for mod_name, mod in list(sys.modules.items()):
        if mod_name.split(".")[0] == "stark_anatomy_tpu_torch" and mod is not None:
            for attr, value in list(vars(mod).items()):
                if value is original:
                    monkeypatch.setattr(mod, attr, wrapper)
    rep = _prove("cpu")
    assert "prove.fri.queries.query-gather" in rep and "merkle-commit" in seen and "lde-host" in seen
