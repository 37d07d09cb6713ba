"""Milliseconds a prove's host spends blocked on the device, on the host's
clock: the sum over every device-wait span of the prove (the synchronise at
each phase's end, each copy to the host, each copy from pageable host
memory). While blocked the host launches nothing. None on the CPU, where
nothing waits on a device, or where the program has no such span."""

SUFFIX = ".device-wait"


def read(ctx):
    phases = ctx["phases"]
    seconds = [s for name, s in phases.items() if name.startswith("prove.") and name.endswith(SUFFIX)]
    if not seconds:
        return None
    return sum(seconds) / ctx["proves"] * 1e3
