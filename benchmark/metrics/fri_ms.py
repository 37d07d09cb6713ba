"""Milliseconds a prove spends in prove.fri less its host tail and its
grinding: the device fold-and-commit rounds, the query gather and the
transcript work around them."""

from benchmark.harness import phase_ms


def read(ctx):
    return phase_ms(ctx, "prove.fri", minus=("prove.fri.host-tail", "prove.fri.grind"))
