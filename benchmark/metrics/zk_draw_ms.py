"""Milliseconds a prove spends drawing the zk randomizer's coefficients, on
the device's clock: threefry, the packing and the Montgomery lift (span
prove.zk-randomizer.zk-draw, its CUDA timing events). None on the CPU, or
where the program has no such span."""

from benchmark.harness import phase_ms


def read(ctx):
    return phase_ms(ctx, "prove.zk-randomizer.zk-draw@device")
