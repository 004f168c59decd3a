"""The program's spans and counters, device memory, and the memory budget
of the Reconstructor's working-set heuristics
(``adorym_tpu/utils/profiling.py``).

Spans (:func:`span`) mark the program's layers on the per-angle path:
``epoch`` (the dispatch) and ``epoch.fetch`` (the loss copy); ``angle``
with its ``stage``, ``rotate``, ``layout``, ``chunk`` (``extract``,
``model``, ``scatter``), ``reg``, ``rotate_back`` and ``update``; one span
a step on the other paths.  They are on exactly while a ``torch.profiler``
runs (:func:`profiler_trace` is the documented way): each is then a
``record_function`` range ``adorym.<name>`` in the profiler's trace, and
the registry keeps its host time, its time on the card's stream (a pair
of CUDA events, resolved once the card has passed them, with no wait of
their own) and the host waits counted inside it.  Off, a span is one flag
check.

The capacity comes from the card (``torch.cuda.get_device_properties``);
on the CPU the JAX package's 16e9 default keeps the heuristics, and so the
gradient chunking, identical to the reference package's CPU runs.  The
reserves keep the JAX package's formulas: they scale with the capacity
and are capped at absolute sizes tied to the program's working set, not
to the device.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
import warnings
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: Prefix of the spans' ranges in the profiler's trace.
PREFIX = 'adorym.'
#: Text of PyTorch's warning at a synchronizing CUDA call (sync debug mode).
SYNC_WARNING = 'called a synchronizing CUDA operation'
#: Epochs whose records the registry keeps besides the first traced one.
KEEP_EPOCHS = 3

_OFF = contextlib.nullcontext()


def span(name: str, epoch: Optional['Epoch'] = None, label=None):
    """A span of the program's layer ``name`` (a context manager; on entry
    it gives the open span, whose ``epoch`` is its epoch's record).  Off
    (no profiler running) the shared no-op, which gives None.  An
    ``'epoch'`` span starts a new epoch's record, named ``label``;
    ``epoch`` puts a span into that record (the loss fetch, which may
    follow the next epoch's dispatch) in place of the open one's."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return REGISTRY.open(name, epoch, label)


class Record:
    """One closed span: name, parent's name, the angle's ordinal in its
    epoch (-1 outside an angle), host ms, stream ms (None until resolved,
    and off the card), host waits counted inside it."""

    __slots__ = ('name', 'parent', 'angle', 'host_ms', 'stream_ms',
                 'syncs', 'events')

    def __init__(self, name, parent, angle, host_ms, stream_ms=None,
                 syncs=0, events=None):
        self.name, self.parent, self.angle = name, parent, angle
        self.host_ms, self.stream_ms = host_ms, stream_ms
        self.syncs, self.events = syncs, events


class Epoch:
    """The records of one traced epoch (``label``: the program's epoch
    index, None for spans opened outside an epoch); ``pending``, those
    whose stream time is still to be read from their events."""

    def __init__(self, label=None):
        self.label = label
        self.angles = 0
        self.records: List[Record] = []
        self.pending: List[Record] = []


class _Span:
    __slots__ = ('reg', 'name', 'epoch', 'parent', 'angle', 'syncs', 'rf',
                 't0', 'ev0')

    def __init__(self, reg: 'Registry', name: str, epoch: Epoch, parent,
                 angle: int):
        self.reg, self.name, self.epoch = reg, name, epoch
        self.parent, self.angle, self.syncs = parent, angle, 0

    def __enter__(self):
        reg = self.reg
        if not reg.stack:
            reg.count_syncs(True)
        reg.stack.append(self)
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.ev0 = reg.event()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        reg = self.reg
        t1 = time.perf_counter()
        ev1 = reg.event()
        self.rf.__exit__(*exc)
        reg.stack.pop()
        timed = self.ev0 is not None and ev1 is not None
        rec = Record(self.name, self.parent, self.angle,
                     (t1 - self.t0) * 1e3, syncs=self.syncs,
                     events=(self.ev0, ev1) if timed else None)
        self.epoch.records.append(rec)
        if timed:
            self.epoch.pending.append(rec)
        if not reg.stack:
            reg.count_syncs(False)
        return False


class Registry:
    """The program's spans and counters: records of the first traced
    epoch and of the last :data:`KEEP_EPOCHS`, each span's host wall,
    stream time and host waits (``syncs.<span>``: each synchronizing
    CUDA call, as PyTorch's sync debug mode warns of it, against the
    innermost open span)."""

    def __init__(self):
        self.stack: List[_Span] = []
        self.first: Optional[Epoch] = None
        self.recent: collections.deque = collections.deque(
            maxlen=KEEP_EPOCHS)
        self.loose: Optional[Epoch] = None
        self.pool: List[torch.cuda.Event] = []
        self._sync_state = None

    # -- spans -----------------------------------------------------------
    def open(self, name: str, epoch: Optional[Epoch] = None,
             label=None) -> _Span:
        top = self.stack[-1] if self.stack else None
        if name == 'epoch':
            epoch = self._new_epoch(label)
            self.loose = None
        elif epoch is None and top is not None:
            epoch = top.epoch
        elif epoch is None:
            # Outside any epoch (a step called directly, or a profiler
            # started inside an epoch): a record of their own.
            if self.loose is None:
                self.loose = self._new_epoch()
            epoch = self.loose
        if name == 'angle':
            epoch.angles += 1
            angle = epoch.angles - 1
        else:
            angle = top.angle if top is not None else -1
        return _Span(self, name, epoch, None if top is None else top.name,
                     angle)

    def _new_epoch(self, label=None) -> Epoch:
        ep = Epoch(label)
        if self.first is None:
            self.first = ep
        else:
            self.recent.append(ep)
        return ep

    def event(self) -> Optional[torch.cuda.Event]:
        """A timing event recorded on the current stream, from the pool;
        None where CUDA is not in use."""
        if not torch.cuda.is_initialized():
            return None
        ev = self.pool.pop() if self.pool else torch.cuda.Event(
            enable_timing=True)
        ev.record()
        return ev

    def count_syncs(self, on: bool):
        """PyTorch's sync debug mode set to warn, its warnings counted
        against the innermost open span and not shown (``on``); the
        previous mode and warning state back (off)."""
        if on:
            if not torch.cuda.is_initialized():
                return
            cw = warnings.catch_warnings()
            cw.__enter__()
            shown = warnings.showwarning
            stack = self.stack

            def hook(message, category, filename, lineno, file=None,
                     line=None):
                if SYNC_WARNING in str(message) and stack:
                    stack[-1].syncs += 1
                else:
                    shown(message, category, filename, lineno, file, line)

            warnings.showwarning = hook
            warnings.filterwarnings('always', message=SYNC_WARNING)
            self._sync_state = (cw, torch.cuda.get_sync_debug_mode())
            torch.cuda.set_sync_debug_mode('warn')
        elif self._sync_state is not None:
            cw, mode = self._sync_state
            self._sync_state = None
            torch.cuda.set_sync_debug_mode(mode)
            cw.__exit__(None, None, None)

    # -- reading ---------------------------------------------------------
    def resolve(self, ep: Epoch):
        """Stream times of the epoch's records whose events the card has
        passed (a query, never a wait); their events go back to the
        pool.  Read once the epoch's loss fetch has waited for the card,
        so that nothing of it is left pending; an epoch dropped unread
        leaves its events to the garbage collector."""
        keep = []
        for r in ep.pending:
            a, b = r.events
            if b.query() and a.query():
                r.stream_ms = a.elapsed_time(b)
                r.events = None
                self.pool += (a, b)
            else:
                keep.append(r)
        ep.pending = keep

    def per_angle(self, epoch: Optional[Epoch] = None) -> Optional[Dict]:
        """The spans an angle of ``epoch`` (the first traced one by
        default): ``{'epoch': label, 'angles': n, 'syncs': waits an angle,
        'spans': {name: {'stream_ms', 'host_ms', 'count', 'syncs'}}}``,
        each summed over the epoch's spans of that name and divided by its
        angles (by 1 in an epoch of no angle); stream ms None where a span
        has none (off the card, or not yet passed).  None with no traced
        epoch."""
        ep = self.first if epoch is None else epoch
        if ep is None:
            return None
        self.resolve(ep)
        n = max(1, ep.angles)
        out: Dict[str, Dict] = {}
        for r in ep.records:
            s = out.setdefault(r.name, {'stream_ms': 0.0, 'host_ms': 0.0,
                                        'count': 0, 'syncs': 0})
            s['host_ms'] += r.host_ms
            s['count'] += 1
            s['syncs'] += r.syncs
            if r.stream_ms is None or s['stream_ms'] is None:
                s['stream_ms'] = None
            else:
                s['stream_ms'] += r.stream_ms
        for s in out.values():
            for k in ('host_ms', 'count', 'syncs'):
                s[k] /= n
            if s['stream_ms'] is not None:
                s['stream_ms'] /= n
        return {'epoch': ep.label, 'angles': ep.angles,
                'syncs': sum(s['syncs'] for s in out.values()),
                'spans': out}

    def summary(self, epoch: Optional[Epoch] = None) -> str:
        """One line: each span's stream ms (host ms off the card) and its
        waits, an angle, of ``epoch`` (the first traced one by default)."""
        pa = self.per_angle(epoch)
        if pa is None:
            return ''
        parts = []
        for name, s in pa['spans'].items():
            ms = s['stream_ms'] if s['stream_ms'] is not None else s['host_ms']
            waits = f' {s["syncs"]:.3g} syncs' if s['syncs'] else ''
            parts.append(f'{name} {ms:.3f}{waits}')
        clock = ('stream' if all(s['stream_ms'] is not None
                                 for s in pa['spans'].values()) else 'host')
        return (f'spans ({clock} ms an angle, {pa["angles"]} angles): '
                + ', '.join(parts))


#: The process's registry.
REGISTRY = Registry()


def device_memory_stats(device=None) -> Optional[Dict[str, float]]:
    """A CUDA device's memory in MB: in use, the peak since the last
    ``torch.cuda.reset_peak_memory_stats``, and the capacity; None off the
    card."""
    device = torch.device('cuda' if device is None else device)
    if device.type != 'cuda' or not torch.cuda.is_available():
        return None
    return {'bytes_in_use_mb': torch.cuda.memory_allocated(device) / 2 ** 20,
            'peak_bytes_mb': torch.cuda.max_memory_allocated(device) / 2 ** 20,
            'bytes_limit_mb': torch.cuda.get_device_properties(
                device).total_memory / 2 ** 20}

#: Capacity assumed off the card (the JAX package's CPU default).
DEFAULT_DEVICE_BYTES = 16e9

#: How many ranks of a mesh share this process's card (set when the
#: process joins a process group, :mod:`..parallel.bootstrap`).
_RANKS_PER_DEVICE = {'n': 1}


def set_ranks_per_device(n: int):
    """Record that ``n`` ranks share this process's card: each then
    budgets ``1/n`` of its memory."""
    _RANKS_PER_DEVICE['n'] = max(1, int(n))


def ranks_per_device() -> int:
    return _RANKS_PER_DEVICE['n']


def hbm_limit_bytes(device=None) -> float:
    """Memory capacity in bytes of ``device`` for this process: a CUDA
    card's total memory over the ranks that share it; for the CPU
    :data:`DEFAULT_DEVICE_BYTES` (per rank, as on the JAX package's virtual
    CPU devices)."""
    device = torch.device('cpu' if device is None else device)
    if device.type == 'cuda':
        return float(torch.cuda.get_device_properties(device).total_memory
                     ) / _RANKS_PER_DEVICE['n']
    return DEFAULT_DEVICE_BYTES


def xla_reserve_bytes(hbm: float) -> float:
    """Memory held back from the gradient-chunk budget for temporaries and
    fragmentation (the JAX package's name and formula: 6 GB, or 3/8 of a
    smaller device)."""
    return min(6e9, 0.375 * hbm)


def data_headroom_bytes(hbm: float) -> float:
    """Headroom kept free when deciding whether the measured data lives on
    the device (1.5 GB, or 3/32 of a smaller device)."""
    return min(1.5e9, 0.09375 * hbm)


def obj_offload_auto_bytes(hbm: float) -> float:
    """The object size in bytes above which ``offload_object='auto'`` keeps
    the object on the host (the JAX package's boundary): the resident path
    holds the object, its update and two moment arrays beside the reserve,
    so the object fits while it is at most ``(hbm - reserve) / 3``, less a
    5% margin (25.0e9 bytes on an 85.0e9-byte H100, ~1460^3)."""
    return 0.95 * (hbm - xla_reserve_bytes(hbm)) / 3


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace of the block (host ops, and the
    card's kernels where CUDA is available) and write it to ``log_dir`` as
    a Chrome trace (``trace_<pid>_<time>.json``, viewable in
    chrome://tracing or Perfetto); a no-op at ``None``
    (``adorym_tpu/utils/profiling.py:94``)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f'trace_{os.getpid()}_{time.strftime("%Y%m%d_%H%M%S")}.json'))


def host_memory_rss_mb() -> Optional[float]:
    """The process's resident host memory in MB (the reference's CPU
    memory probe); None where ``/proc`` is not there."""
    try:
        with open('/proc/self/statm') as f:
            pages = int(f.read().split()[1])
    except OSError:
        return None
    return pages * os.sysconf('SC_PAGE_SIZE') / 2 ** 20


def stream_rotation_auto_bytes(hbm: float) -> float:
    """The object size in bytes above which ``stream_rotation='auto'``
    streams the per-angle rotation (the JAX package's boundary, 1.5/16 of
    the capacity: 7.97 GB of object on an 85.0e9-byte H100, ~980^3): the
    bulk rotation's corner-gather temporaries are each object-sized."""
    return hbm * (1.5 / 16)
