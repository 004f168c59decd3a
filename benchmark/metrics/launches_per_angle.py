"""Operations the host put on the card (kernels, copies and fills, each a
device event of the trace) in the traced epoch, over its angle steps."""


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.n_angles:
        return None
    return s.launches / ctx.n_angles
