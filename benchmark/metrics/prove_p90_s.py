"""The 90th percentile of the wall times of all proves of the window."""

from benchmark.harness import p90


def read(ctx):
    return p90(ctx["walls"])
