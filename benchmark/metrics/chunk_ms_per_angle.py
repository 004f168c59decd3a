"""Stream time an angle of the gradient chunks (the program's span
``chunk``: extraction, model, loss, backward and the scatter) in the
traced epoch, from the program's own span records; None off the card or
in a program without them."""

from benchmark import program_spans


def read(ctx):
    return program_spans.stream_ms_per_angle(('chunk',))
