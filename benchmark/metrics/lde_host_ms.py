"""Milliseconds a prove spends in the host side of the trace LDE, on the
host's clock: the pad rows' draws, the bytes -> word-plane conversion and
the concatenation (span prove.trace-lde.lde-host). None where the program
has no such span."""

from benchmark.harness import phase_ms


def read(ctx):
    return phase_ms(ctx, "prove.trace-lde.lde-host")
