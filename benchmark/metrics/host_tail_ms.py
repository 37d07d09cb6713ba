"""Milliseconds a prove spends in prove.fri.host-tail: the FRI rounds
whose codewords finish on the host."""

from benchmark.harness import phase_ms


def read(ctx):
    return phase_ms(ctx, "prove.fri.host-tail")
