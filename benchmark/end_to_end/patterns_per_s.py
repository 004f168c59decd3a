"""Diffraction patterns of the window's whole epochs over the window's
wall time, from the first ``run_epoch`` call to the last one's return (each
epoch ends in its blocking loss fetch, so the host clock covers the
card's work)."""


def read(ctx):
    if ctx.window_wall_s <= 0:
        return None
    return ctx.patterns / ctx.window_wall_s
