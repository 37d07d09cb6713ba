"""Percent of the Blake2b kernels' device time in the profiled proves
that the least time of the compressions of every commit of a prove would
take (work.py blake2b_work)."""

from benchmark.harness import roofline


def read(ctx):
    return roofline(ctx, "blake2b_roofline", "blake2b")
