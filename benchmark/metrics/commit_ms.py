"""Milliseconds a prove spends in its Merkle commits, on the device's clock:
the sum over every merkle-commit span of the prove (the boundary quotients',
the zk codeword's and each FRI round's committed on the device), leaf and
level hashing and the top level's trip to the host. None on the CPU, or
where the program has no such span."""

SUFFIX = ".merkle-commit@device"


def read(ctx):
    phases = ctx["phases"]
    seconds = [s for name, s in phases.items() if name.startswith("prove.") and name.endswith(SUFFIX)]
    if not seconds:
        return None
    return sum(seconds) / ctx["proves"] * 1e3
