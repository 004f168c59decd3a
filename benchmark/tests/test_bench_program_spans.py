"""The per-layer metrics read from the program's own span records
(``rotate_ms_per_angle``, ``chunk_ms_per_angle``, ``update_ms_per_angle``)
on a registry filled by hand: the stream ms an angle on the card, None
off it, with no traced epoch, or in a program without the registry."""

import types

import pytest

from benchmark import harness

from conftest import REPO

METRICS = REPO / 'benchmark' / 'metrics'
CTX = types.SimpleNamespace()


def _registry(stream):
    """The first traced epoch of 4 angles: per angle a rotate (2 ms), a
    rotate_back (1 ms), two chunks (3 ms each) and an update (0.5 ms) on
    the stream, or with no stream time (``stream`` False: off the card)."""
    from adorym_tpu_torch.utils import profiling
    reg = profiling.Registry()
    ep = profiling.Epoch(7)
    for a in range(4):
        ep.angles += 1
        for name, ms in (('rotate', 2.0), ('chunk', 3.0), ('chunk', 3.0),
                         ('rotate_back', 1.0), ('update', 0.5),
                         ('angle', 10.0)):
            ep.records.append(profiling.Record(
                name, 'epoch' if name == 'angle' else 'angle', a, ms + 1.0,
                stream_ms=ms if stream else None))
    reg.first = ep
    return reg


@pytest.mark.parametrize('stream', [True, False])
def test_readers_on_a_registry(monkeypatch, stream):
    from adorym_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, 'REGISTRY', _registry(stream))
    got = {n: harness.load_reader(METRICS / f'{n}.py')(CTX)
           for n in ('rotate_ms_per_angle', 'chunk_ms_per_angle',
                     'update_ms_per_angle')}
    want = ({'rotate_ms_per_angle': 3.0, 'chunk_ms_per_angle': 6.0,
             'update_ms_per_angle': 0.5} if stream
            else dict.fromkeys(got))
    assert got == want


def test_readers_with_nothing_to_read(monkeypatch):
    from adorym_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, 'REGISTRY', profiling.Registry())
    read = harness.load_reader(METRICS / 'chunk_ms_per_angle.py')
    assert read(CTX) is None
    # A program without the registry (the spans' parent version).
    monkeypatch.delattr(profiling, 'REGISTRY')
    assert read(CTX) is None
