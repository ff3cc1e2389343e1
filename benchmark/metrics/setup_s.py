"""Seconds from the process's start to the window's: torch and CUDA, the
kernel library, create_engine's tables, the warm-up, the PRP driver's
preamble. End to end, host clock."""


def read(ctx):
    return ctx["setup_s"]
