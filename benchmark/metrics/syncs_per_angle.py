"""Host waits on the card in the traced epochs (stream, device and event
synchronizes, copies that return only when done), over their angle
steps."""


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.n_angles:
        return None
    return s.syncs / ctx.n_angles
