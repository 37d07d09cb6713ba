"""Seconds of the window over the proves completed in it: proves run back
to back, each a Stark.prove with the device drained on both sides."""


def read(ctx):
    return ctx["window_s"] / ctx["proves"]
