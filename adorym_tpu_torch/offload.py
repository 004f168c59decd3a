"""Out-of-core pieces of the Reconstructor: page-locked host blocks, the
copies between them and the card, and the measured data's stager
(``adorym_tpu/recon.py``'s host-staged data, offloaded optimizer state and
offloaded object).

Host blocks are plain host allocations registered with
``cudaHostRegister``: PyTorch's pinned allocator rounds a block up to a
power of two (a 5e9-byte block held 8.6e9 bytes of the process's RSS on the
card's host, ``tools/host_link_torch.py``), which at out-of-core sizes
doubles the host's bill.  A registration that fails raises.  On the CPU a
host block is an ordinary tensor and every copy is synchronous.

Ordering on the card: uploads run on the compute stream; downloads run on
one copy stream after the compute stream's work so far, so a slab's
download overlaps the next slab's update.  :meth:`HostMover.wait` puts the
compute stream after every download (before host blocks are read again),
:meth:`HostMover.sync` the host (before it reads them).  The stager copies
host-staged rows on its own stream; the compute stream waits on each copy's
event.

A sharded checkpoint takes the object and its state slab by slab as they
lie (:func:`checkpoint_slabs`, :func:`slabs_of`): a host slab is written
from its block's memory, a device slab is brought down on its own, and no
whole array is made.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class HostArena:
    """Host blocks for one run, page-locked with ``cudaHostRegister`` when the
    run is on a card; each block is unregistered when the arena goes."""

    def __init__(self, device: torch.device):
        self.device = device
        self._blocks: List[torch.Tensor] = []

    def empty(self, shape, dtype=torch.float32) -> torch.Tensor:
        t = torch.empty(tuple(shape), dtype=dtype)
        if self.device.type == 'cuda' and t.nbytes:
            err = int(torch.cuda.cudart().cudaHostRegister(t.data_ptr(),
                                                           t.nbytes, 0))
            if err != 0:
                raise RuntimeError(f'cudaHostRegister of {t.nbytes} bytes '
                                   f'failed: CUDA error {err}')
            self._blocks.append(t)
        return t

    def zeros(self, shape, dtype=torch.float32) -> torch.Tensor:
        return self.empty(shape, dtype).zero_()

    def copy_of(self, t: torch.Tensor) -> torch.Tensor:
        return self.empty(t.shape, t.dtype).copy_(t)

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self._blocks)

    def __del__(self):
        if not self._blocks:
            return
        try:
            torch.cuda.synchronize(self.device)
            cudart = torch.cuda.cudart()
            for t in self._blocks:
                cudart.cudaHostUnregister(t.data_ptr())
        except Exception:
            pass
        self._blocks = []


class HostMover:
    """Copies between host blocks and the device: :meth:`up` on the compute
    stream, :meth:`down` on the copy stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == 'cuda'
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def up(self, host: torch.Tensor) -> torch.Tensor:
        """``host`` on the device (on the CPU, ``host`` itself)."""
        if not self.cuda:
            return host
        return host.to(self.device, non_blocking=True)

    def down(self, host: torch.Tensor, dev: torch.Tensor):
        """Copy ``dev`` into the host block ``host`` once the compute
        stream's work so far is done."""
        if not self.cuda:
            if dev is not host:
                host.copy_(dev)
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            host.copy_(dev, non_blocking=True)
        dev.record_stream(self.stream)

    def wait(self):
        """The compute stream after every download so far."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def sync(self):
        """The host after every download so far."""
        if self.cuda:
            self.stream.synchronize()


def slab_ranges(ny: int, k: int) -> Tuple[List[str], List[Tuple[int, int]]]:
    """The y slabs of the offloaded object and its moments: ``min(k, ny)``
    slabs on ``np.linspace(0, ny, k + 1)``, keyed ``s00``, ``s01``, ...;
    returns ``(keys, [(start, size), ...])``."""
    k = min(int(k), int(ny))
    bounds = np.linspace(0, ny, k + 1).astype(int)
    return ([f's{i:02d}' for i in range(k)],
            [(int(bounds[i]), int(bounds[i + 1] - bounds[i]))
             for i in range(k)])


def slab_views(whole: torch.Tensor, keys, ranges) -> Dict[str, torch.Tensor]:
    """Views of ``whole``'s y slabs, by key."""
    return {key: whole[st:st + sz] for key, (st, sz) in zip(keys, ranges)}


def checkpoint_slabs(ny: int, n_op: int, op: int, k: int):
    """The y slabs of a sharded checkpoint of an object of ``ny`` rows
    split into ``n_op`` rank slabs, each rank's rows cut into ``k`` slabs
    by :func:`slab_ranges` (the offload slabs of an offloaded object).
    Returns ``(table, mine)``: every slab's rows ``[y0, y1)`` of the whole
    object, ``[n_slabs, 2]`` in y order (slab ``i`` is keyed
    ``s{i:02d}``), and rank ``op``'s slabs as ``(key, start, size)``
    within its own rows."""
    own = ny // n_op
    local = slab_ranges(own, k)[1]
    table = np.asarray([(o * own + st, o * own + st + sz)
                        for o in range(n_op) for st, sz in local], np.int64)
    mine = [(f's{op * len(local) + i:02d}', st, sz)
            for i, (st, sz) in enumerate(local)]
    return table, mine


def slabs_of(v, mine) -> Dict[str, torch.Tensor]:
    """``v``'s checkpoint slabs by key (``mine`` from
    :func:`checkpoint_slabs`): a slab dict's own tensors (host blocks
    under offload), else views of ``v``'s rows; nothing is copied."""
    if isinstance(v, dict):
        return {key: v[key] for key, _, _ in mine}
    return {key: v[st:st + sz] for key, st, sz in mine}


class _Slot:
    """One host staging buffer and the event of the copy that reads it."""

    def __init__(self):
        self.host: Optional[torch.Tensor] = None
        self.event = None


class DataStager:
    """Every read of the measured data, ``[n_theta, n_pos, h, w]`` held as
    an ndarray or a :class:`~.io.fastloader.FastLoader`.  Where the dataset
    fits on the device beside the working set (``resident``) it lives
    there and rows are indexed in place; else each request gathers its
    rows on the host into one of two staging buffers (page-locked on a
    card) and copies them up on a copy stream.  A request returns a
    pending copy; :meth:`take` makes the compute stream wait for it."""

    def __init__(self, data: Optional[np.ndarray], loader,
                 device: torch.device, resident: bool, arena: HostArena):
        if resident and data is None:
            raise ValueError('a loader-backed dataset stays on the host')
        self.data = data
        self.loader = loader
        self.device = device
        self.resident = resident
        self.frame = tuple((data.shape if data is not None
                            else loader.shape)[2:])
        self._arena = arena
        self._dev = None
        self._cuda = device.type == 'cuda'
        self._stream = (torch.cuda.Stream(device)
                        if self._cuda and not resident else None)
        self._slots = [_Slot(), _Slot()]
        self._next_slot = 0
        #: Rows gathered on the host and copied up, by request.
        self.staged_rows = 0

    def dataset(self) -> torch.Tensor:
        """The device-resident dataset (moved there on first use)."""
        if not self.resident:
            raise RuntimeError('the dataset is staged from the host')
        if self._dev is None:
            self._dev = torch.as_tensor(self.data, device=self.device)
        return self._dev

    # -- host buffers ---------------------------------------------------
    def _buffer(self, n: int) -> Tuple[_Slot, np.ndarray, torch.Tensor]:
        """The next staging buffer, at least ``n`` rows, once the copy that
        last read it is done."""
        slot = self._slots[self._next_slot]
        self._next_slot ^= 1
        if slot.event is not None:
            slot.event.synchronize()
            slot.event = None
        if slot.host is None or slot.host.shape[0] < n:
            slot.host = (self._arena.empty((n,) + self.frame)
                         if self._cuda else torch.empty((n,) + self.frame))
        host = slot.host[:n]
        return slot, host.numpy(), host

    def _up(self, slot: _Slot, host: torch.Tensor, shape):
        """The staged rows on the device: a copy on the stager's stream on
        a card (pending until :meth:`take`), else a copy on the CPU."""
        self.staged_rows += host.shape[0]
        if not self._cuda:
            return host.clone().reshape(shape)
        with torch.cuda.stream(self._stream):
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            dev.copy_(host, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        slot.event = ev
        return (dev.reshape(shape), ev)

    def take(self, pending) -> torch.Tensor:
        """The rows of a request, ordered after their copy."""
        if not isinstance(pending, tuple):
            return pending
        dev, ev = pending
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ev)
        dev.record_stream(cur)
        return dev

    # -- requests ---------------------------------------------------------
    def rows(self, i_theta: int, idx) -> torch.Tensor:
        """The rows ``idx`` (any shape) of angle ``i_theta`` on the device,
        ``idx.shape + (h, w)``, now."""
        return self.take(self.request(i_theta, idx))

    def request(self, i_theta: int, idx):
        """The rows ``idx`` of angle ``i_theta``: indexed on the device, or
        gathered on the host (``FastLoader.gather`` or numpy) and copied
        up."""
        idx = np.asarray(idx)
        shape = idx.shape + self.frame
        if self.resident:
            i = torch.as_tensor(idx.reshape(-1), device=self.device)
            return self.dataset()[i_theta][i].reshape(shape)
        flat = idx.reshape(-1).astype(np.int64)
        slot, out, host = self._buffer(len(flat))
        if self.loader is not None:
            self.loader.gather(i_theta, flat, out=out)
        else:
            np.take(self.data[i_theta], flat, axis=0, out=out)
        return self._up(slot, host, shape)

    def feed(self, rows: Sequence[Tuple[int, np.ndarray]]):
        """Batch ``i``'s rows ``rows[i] = (i_theta, idx)`` in order (from
        any first batch): :meth:`_Feed.take` gives batch ``i`` and
        :meth:`_Feed.ahead` stages batch ``i + 1`` while batch ``i``
        computes (through the loader's double-buffered prefetch where
        there is a loader)."""
        return _Feed(self, rows)


class _Feed:
    def __init__(self, stager: DataStager, rows):
        self.s = stager
        self.rows = rows
        self._pending: Dict[int, object] = {}
        self._queued = set()

    def take(self, i: int) -> torch.Tensor:
        self.ahead(i)
        return self.s.take(self._pending.pop(i))

    def ahead(self, i: int):
        if i >= len(self.rows) or i in self._pending:
            return
        s = self.s
        i_theta, idx = self.rows[i]
        if s.resident or s.loader is None:
            self._pending[i] = s.request(i_theta, idx)
            return
        # The loader's two slots: batch i in slot i % 2, batch i + 1
        # gathered into the other on the worker thread meanwhile.
        ld = s.loader
        if i not in self._queued:
            ld.prefetch(i % 2, i_theta, idx)
        if i + 1 < len(self.rows) and i + 1 not in self._queued:
            ld.prefetch((i + 1) % 2, *self.rows[i + 1])
            self._queued.add(i + 1)
        idx = np.asarray(idx)
        slot, out, host = s._buffer(idx.size)
        ld.get(i % 2, idx.size, out=out)
        self._pending[i] = s._up(slot, host, idx.shape + s.frame)
