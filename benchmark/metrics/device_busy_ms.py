"""Milliseconds a profiled prove keeps the device running an operation: the
union of its kernels and copies. Steadier than prove_s, which the host's
speed moves; a kernel's gain shows here before it shows end to end."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or prof["busy_s"] <= 0:
        return None
    return prof["busy_s"] / prof["proves"] * 1e3
