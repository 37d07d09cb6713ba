"""Seconds from the start of the process to the start of the window:
imports, the kernels built or loaded, the statement's trace generated, and the
warm-up proves."""


def read(ctx):
    return ctx["setup_s"]
