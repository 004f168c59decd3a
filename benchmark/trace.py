"""The reduction of a torch.profiler trace to what the per-layer metrics
read: the traced window, the union of the device's busy intervals, device
time by operation, launches, host waits and the idle gaps by the host
operation open during each.

Events are plain tuples ``(name, category, start_ns, end_ns)`` so that the
reduction runs on synthetic events in the CPU tests.  Categories are the
profiler's activity types: ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
run on the device; ``cuda_runtime`` and ``cuda_driver`` are the host's
calls into CUDA; ``cpu_op`` and ``user_annotation`` are host operations
and spans.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

Event = Tuple[str, str, int, int]

DEVICE = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')
#: Host calls that wait for the device: every synchronize, and the
#: copies that return only once done (``cudaMemcpy`` without ``Async``).
SYNC_NAMES = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize', 'cuStreamSynchronize',
              'cuCtxSynchronize', 'cuEventSynchronize')
#: Gaps shorter than the longest this many go into one line.
MAX_GAPS = 20000
NAME_CHARS = 160


def is_sync(name: str) -> bool:
    if name in SYNC_NAMES:
        return True
    return (name.startswith(('cudaMemcpy', 'cuMemcpy'))
            and 'Async' not in name)


def category(event) -> str:
    """The activity type of one ``torch.profiler`` kineto event, in the
    names above: the device type decides device against host, the
    profiler's activity type the rest."""
    act = getattr(event, 'activity_type', None)
    act = str(act() if callable(act) else (act or '')).lower()
    name = event.name()
    if str(event.device_type()).endswith('CUDA'):
        if 'annotation' in act:
            return 'gpu_user_annotation'
        if 'memcpy' in act or name.startswith('Memcpy'):
            return 'gpu_memcpy'
        if 'memset' in act or name.startswith('Memset'):
            return 'gpu_memset'
        return 'kernel'
    if 'annotation' in act:
        return 'user_annotation'
    if 'driver' in act:
        return 'cuda_driver'
    if 'runtime' in act or (not act and name.startswith('cuda')):
        return 'cuda_runtime'
    return 'cpu_op'


def from_profiler(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        out.append((e.name(), category(e), start,
                    start + int(e.duration_ns())))
    return mark_annotations(out)


def mark_annotations(events: List[Event]) -> List[Event]:
    """Device events that carry a host event's name are the device-side
    copies of ``record_function`` ranges, whatever activity type the
    profiler gave them: they span kernels and are no work of their own."""
    host = {e[0] for e in events if e[1] not in DEVICE}
    return [(n, 'gpu_user_annotation', a, b) if c in DEVICE and n in host
            else (n, c, a, b) for n, c, a, b in events]


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, merged intervals."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def clip(intervals, t0: int, t1: int):
    return [(max(a, t0), min(b, t1)) for a, b in intervals
            if b > t0 and a < t1]


def gaps(busy: List[Tuple[int, int]], t0: int, t1: int):
    """The stretches of ``[t0, t1]`` that ``busy`` (merged, clipped)
    leaves uncovered."""
    out, at = [], t0
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if t1 > at:
        out.append((at, t1))
    return out


@dataclasses.dataclass
class Summary:
    window_ns: int
    busy_ns: int
    device_ops: Dict[str, int]        # name -> device ns
    launches: int                     # device operations issued
    syncs: int                        # host waits
    idle_by_host_op: Dict[str, int]   # host op open in a gap -> gap ns
    n_device_events: int

    @property
    def window_s(self) -> float:
        return self.window_ns / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9


def _innermost(host, starts, mid: int, spans) -> str:
    """The host event open at ``mid`` that started last (the innermost),
    else the span open there, else ``(no host op)``."""
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(-1, i - 4000), -1):
        if host[j][3] >= mid:
            return host[j][0]
    for name, _, a, b in spans:
        if a <= mid <= b:
            return name
    return '(no host op)'


def summarize(events: List[Event],
              window_span: Optional[str] = None) -> Optional[Summary]:
    """The summary over the host spans named ``window_span`` (first start to
    last end) or, with None, over the host's CUDA calls (first start to
    last end: a trace of the card's activity alone, taken over the window,
    whose last call waits for the card); None when the trace holds no such
    span or no device operation in it."""
    if window_span is None:
        spans = [e for e in events if e[1] in ('cuda_runtime', 'cuda_driver')]
    else:
        spans = [e for e in events if e[0] == window_span
                 and e[1] in ('user_annotation', 'cpu_op')]
    if not spans:
        return None
    t0 = min(e[2] for e in spans)
    t1 = max(e[3] for e in spans)
    dev = [e for e in events if e[1] in DEVICE and e[3] > t0 and e[2] < t1]
    if not dev:
        return None
    busy = clip(union((e[2], e[3]) for e in dev), t0, t1)
    ops: Dict[str, int] = collections.Counter()
    for name, _, a, b in dev:
        ops[name] += min(b, t1) - max(a, t0)
    host = sorted((e for e in events if e[1] in HOST and e[0] != window_span),
                  key=lambda e: e[2])
    syncs = sum(1 for e in host if e[1] in ('cuda_runtime', 'cuda_driver')
                and t0 <= e[2] < t1 and is_sync(e[0]))
    starts = [e[2] for e in host]
    idle: Dict[str, int] = collections.Counter()
    all_gaps = sorted(gaps(busy, t0, t1), key=lambda g: g[0] - g[1])
    for a, b in all_gaps[:MAX_GAPS]:
        idle[_innermost(host, starts, (a + b) // 2,
                        spans if window_span else [])] += b - a
    rest = sum(b - a for a, b in all_gaps[MAX_GAPS:])
    if rest:
        idle['(shorter gaps)'] += rest
    return Summary(window_ns=t1 - t0, busy_ns=sum(b - a for a, b in busy),
                   device_ops=dict(ops), launches=len(dev), syncs=syncs,
                   idle_by_host_op=dict(idle), n_device_events=len(dev))


def top(counts: Dict[str, int], n: int = 10):
    """``[[name, seconds], ...]`` of the ``n`` largest, names cut to
    :data:`NAME_CHARS`."""
    items = sorted(counts.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:NAME_CHARS], v / 1e9] for k, v in items]
