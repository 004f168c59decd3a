"""The program's own span records (``adorym_tpu_torch.utils.profiling``'s
registry), read by the per-layer metrics of program phases: the stream
time an angle of named spans in the first epoch the program ran under a
profiler, which is the harness's first traced epoch."""

from typing import Iterable, Optional


def stream_ms_per_angle(names: Iterable[str]) -> Optional[float]:
    """The summed stream ms an angle of the spans ``names`` in the first
    traced epoch; None where the program keeps no registry (a version
    without spans), traced no epoch of angles, opened none of these spans,
    or timed them on no card's stream."""
    try:
        from adorym_tpu_torch.utils import profiling
        pa = profiling.REGISTRY.per_angle()
    except (ImportError, AttributeError):
        return None
    if not pa or not pa.get('angles'):
        return None
    found = [pa['spans'][n] for n in names if n in pa['spans']]
    if not found or any(s['stream_ms'] is None for s in found):
        return None
    return sum(s['stream_ms'] for s in found)
