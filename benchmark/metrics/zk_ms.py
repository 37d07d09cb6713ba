"""Milliseconds a prove spends in prove.zk-randomizer (the threefry draw of
the zk coefficients, their coset NTT and the commit)."""

from benchmark.harness import phase_ms


def read(ctx):
    return phase_ms(ctx, "prove.zk-randomizer")
