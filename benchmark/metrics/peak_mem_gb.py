"""torch.cuda.max_memory_allocated() over the window (reset after the
warm-up proves), in units of 1e9 bytes."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9 if ctx["peak_bytes"] else None
