"""Share of an untraced epoch's wall (the window's mean) in which the card
has nothing to do: one minus the union of the device's kernels, copies and
fills over one traced epoch, over that wall.  The busy time comes from the
trace and the wall from the untraced window, so that the profiler's own
host cost does not read as idle."""


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.epoch_s:
        return None
    return 100.0 * (1.0 - s.busy_s / ctx.epoch_s)
