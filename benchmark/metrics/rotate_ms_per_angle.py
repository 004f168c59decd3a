"""Stream time an angle of the rotation (the program's spans ``rotate``:
rotate, pad and bin z, and ``rotate_back``: crop, expand in z and rotate
the gradient back) in the traced epoch, from the program's own span
records; None off the card or in a program without them."""

from benchmark import program_spans


def read(ctx):
    return program_spans.stream_ms_per_angle(('rotate', 'rotate_back'))
