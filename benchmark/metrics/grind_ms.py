"""Milliseconds a prove spends in prove.fri.grind: the proof-of-work search
on the host (profiles with grinding bits only)."""

from benchmark.harness import phase_ms


def read(ctx):
    return phase_ms(ctx, "prove.fri.grind")
