"""Percent of the NTT kernels' device time in the profiled proves that the
least time of the transforms a prove needs would take (work.py ntt_work);
the kernels are those that kernels/*.json attribute to this metric."""

from benchmark.harness import roofline


def read(ctx):
    return roofline(ctx, "ntt_roofline", "ntt")
