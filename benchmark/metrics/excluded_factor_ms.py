"""Milliseconds a prove spends on the transition zerofier's inverse in the
big path's chunked combination, on the device's clock: the sum over every
excluded-factor span of the prove (the excluded-row factor by Horner at
each chunk's points, times the tiled denominator inverse). None on the CPU,
or where the program has no such span (the standard path opens none)."""

SUFFIX = ".excluded-factor@device"


def read(ctx):
    phases = ctx["phases"]
    seconds = [s for name, s in phases.items() if name.startswith("prove.") and name.endswith(SUFFIX)]
    if not seconds:
        return None
    return sum(seconds) / ctx["proves"] * 1e3
