"""Kernel launches the device trace holds per profiled prove."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or not prof["launches"]:
        return None
    return prof["launches"] / prof["proves"]
