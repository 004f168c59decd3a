"""Timers, device memory, and the memory budget of the Reconstructor's
working-set heuristics (``adorym_tpu/utils/profiling.py``).

The capacity comes from the card (``torch.cuda.get_device_properties``);
on the CPU the JAX package's 16e9 default keeps the heuristics, and so the
gradient chunking, identical to the reference package's CPU runs.  The
reserves keep the JAX package's formulas: they scale with the capacity
and are capped at absolute sizes tied to the program's working set, not
to the device.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class Timers:
    """Accumulating named wall-clock timers.  A phase that does not end in
    a host sync measures the time to queue its kernels; the epoch's loss
    fetch is the sync that makes epoch-level numbers whole."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> str:
        return '; '.join(
            f'{name}: {self.total[name]:.3f}s ({self.count[name]}x, '
            f'{self.total[name] / self.count[name] * 1e3:.1f}ms avg)'
            for name in sorted(self.total))

    def reset(self):
        self.total.clear()
        self.count.clear()


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
