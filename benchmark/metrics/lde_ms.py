"""Milliseconds a prove spends in the program's span prove.trace-lde
(iop/stark.py _trace_lde: pad and upload, inverse NTT, coset NTT to F)."""

from benchmark.harness import phase_ms


def read(ctx):
    return phase_ms(ctx, "prove.trace-lde")
