"""Milliseconds a prove spends copying codewords from the device into host
numpy, on the device's clock: the sum over every to-host span of the prove
(the big path's boundary-quotient chunks, its zk codeword and FRI round 0).
The span's first event fires once the work queued before it is done, so it
times the copy, not what the copy waits for. None on the CPU, or where the
program has no such span (the standard path opens none)."""

SUFFIX = ".to-host@device"


def read(ctx):
    phases = ctx["phases"]
    seconds = [s for name, s in phases.items() if name.startswith("prove.") and name.endswith(SUFFIX)]
    if not seconds:
        return None
    return sum(seconds) / ctx["proves"] * 1e3
