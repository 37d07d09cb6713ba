"""Milliseconds a prove's trace columns take to reach the device, on the
device's clock: the extent on the device stream of the column uploads (span
prove.trace-lde.lde-upload, its CUDA timing events). None on the CPU, or
where the program has no such span."""

from benchmark.harness import phase_ms


def read(ctx):
    return phase_ms(ctx, "prove.trace-lde.lde-upload@device")
