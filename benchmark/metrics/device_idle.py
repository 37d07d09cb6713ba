"""Percent of a prove in which the device runs nothing: 1 less the union of
the device operations per profiled prove over the wall time per prove of
the window's unprofiled proves."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["proves"] / (ctx["window_s"] / ctx["proves"]))
