"""The per-layer metrics that read the program's sub-spans: lde_host_ms,
h2d_ms, zk_draw_ms, commit_ms and host_wait_ms, from a window's phases, on
the CPU."""

import pytest

from benchmark import harness

READERS = ("lde_host_ms", "h2d_ms", "zk_draw_ms", "commit_ms", "host_wait_ms")


def _ctx(phases, proves=2):
    return {"phases": phases, "proves": proves}


def test_readers_of_a_window_with_the_device_clock():
    phases = {
        "prove.trace-lde": 0.5, "prove.trace-lde.lde-host": 0.2, "prove.trace-lde.lde-upload": 0.08,
        "prove.trace-lde.lde-upload@device": 0.04, "prove.zk-randomizer.zk-draw": 0.01,
        "prove.zk-randomizer.zk-draw@device": 0.15,
        "prove.bq-commit.merkle-commit@device": 0.02, "prove.zk-randomizer.merkle-commit@device": 0.02,
        "prove.fri.merkle-commit@device": 0.01, "prove.fri.merkle-commit": 0.5,
        "prove.trace-lde.device-wait": 0.1, "prove.fri.queries.query-gather.device-wait": 0.02,
        "prove.bq-commit.merkle-commit.device-wait": 0.01, "verify.fri": 9.0,
    }
    got = {name: harness._reader(name)(_ctx(phases)) for name in READERS}
    assert got == pytest.approx({"lde_host_ms": 100.0, "h2d_ms": 20.0, "zk_draw_ms": 75.0,
                                 "commit_ms": 25.0, "host_wait_ms": 65.0})


def test_readers_find_nothing_in_a_program_without_the_spans():
    phases = {"prove.trace-lde": 0.5, "prove.zk-randomizer": 0.3, "prove.fri": 1.0}
    assert {name: harness._reader(name)(_ctx(phases)) for name in READERS} == dict.fromkeys(READERS)


def test_on_the_cpu_only_the_host_clock_of_the_lde_is_read():
    # a CPU prove's window: no device clock, no device-wait
    phases = {"prove.trace-lde": 0.5, "prove.trace-lde.lde-host": 0.2, "prove.trace-lde.lde-upload": 0.01,
              "prove.zk-randomizer.zk-draw": 0.1, "prove.fri.merkle-commit": 0.2}
    got = {name: harness._reader(name)(_ctx(phases, proves=4)) for name in READERS}
    assert got == {"lde_host_ms": pytest.approx(50.0), "h2d_ms": None, "zk_draw_ms": None,
                   "commit_ms": None, "host_wait_ms": None}
