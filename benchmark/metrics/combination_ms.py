"""Milliseconds a prove spends in prove.quotients-combination (the AIR
constraints, the transition zerofier and the weighted combination)."""

from benchmark.harness import phase_ms


def read(ctx):
    return phase_ms(ctx, "prove.quotients-combination")
