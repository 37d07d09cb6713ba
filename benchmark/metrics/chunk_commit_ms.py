"""Milliseconds a prove spends in the chunk adds of its chunked Merkle
commits, on the device's clock: the sum over every chunk-commit span of the
prove (each ChunkedPairCommit add of the big path's three trees: leaf hash,
reduction to the chunk's root, the kept levels' copy to the host). None on
the CPU, or where the program has no such span (the standard path opens
none)."""

SUFFIX = ".chunk-commit@device"


def read(ctx):
    phases = ctx["phases"]
    seconds = [s for name, s in phases.items() if name.startswith("prove.") and name.endswith(SUFFIX)]
    if not seconds:
        return None
    return sum(seconds) / ctx["proves"] * 1e3
