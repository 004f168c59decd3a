"""Seconds from the process's start to the window's first epoch: imports,
the inputs, ``Reconstructor(...)``, and the warm-up steps (with the first
run in a checkout, the kernels' build)."""


def read(ctx):
    return ctx.setup_s
