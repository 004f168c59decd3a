"""Share of a rank's traced epoch (over the epoch's own span, begun on
every rank together) in which its card has nothing to do: one minus the
union of the device's kernels, copies and fills over the span; the ranks'
readings are averaged.  A collective's kernel runs while its rank waits
for the others, so a wait on a slower rank reads as busy here and shows
in ``collective_ms_per_angle``.  The traced epoch's own span is the base,
not the untraced window's epoch (as ``device_idle_pct`` takes it): on a
mesh the profiler's cost lengthens the epoch and the collectives' waits
fill it, so that base would read below nought."""


def read(ctx):
    s = ctx.summary
    if s is None or not s.window_s:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
