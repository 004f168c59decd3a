"""The collectives of a (dp, op) mesh over ``torch.distributed``.

The JAX package runs its meshes as one program over many devices and lets
GSPMD and ``shard_map`` place the ``psum``s and ``ppermute``s.  The port
runs one process a device, so every collective is written out here: sums
over the data axis, the object axis or both, the ring shift of the object
axis (the ``ppermute`` of a ring), the all-gather of the object's y
slabs, and the barriers of a sharded checkpoint's commit.  The
collectives that ``torch.distributed.checkpoint`` runs itself are counted
by call (:meth:`Comm.note`), not by bytes.

Every call is recorded by kind, axis, shape and bytes in
:attr:`Comm.records`, with the seconds it took (host clock, including the
wait for the operand).  Tests read the records where the JAX tests grep
the compiled program's collectives.

Backends: ``nccl`` where every rank has a card of its own; ``gloo`` where
ranks share a card, or run on the CPU.  Gloo takes CUDA tensors for
``all_reduce`` only; the ring shift and the all-gather of CUDA tensors go
through page-locked host buffers, counted in :attr:`Comm.host_copies`.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def ranks_per_card(world: int, local_world: Optional[int] = None) -> int:
    """How many ranks of this host share one card: the host's ranks
    (``local_world``, else the whole world) over its cards."""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    local = world if local_world is None else local_world
    if n_cards == 0:
        return 1
    return max(1, -(-local // n_cards))


def check_backend(backend: str, device: torch.device, per_card: int):
    """Raise where ``backend`` cannot serve ranks on ``device``: nccl off
    the card, or nccl with several ranks on one card (NCCL refuses a
    duplicate GPU).  Nothing switches backend on its own."""
    if backend == 'nccl' and device.type != 'cuda':
        raise ValueError('the nccl backend needs CUDA devices; use gloo on '
                         'the CPU')
    if backend == 'nccl' and per_card > 1:
        raise ValueError(f'the nccl backend needs one card a rank, but '
                         f'{per_card} ranks share a card here; use gloo')
    if backend not in ('nccl', 'gloo'):
        raise ValueError(f'unknown backend {backend!r}')


def default_backend(device: torch.device, per_card: int) -> str:
    """nccl where every rank has a card of its own, else gloo."""
    return 'nccl' if device.type == 'cuda' and per_card == 1 else 'gloo'


class Comm:
    """This rank's place in a ``n_dp x n_op`` mesh laid over the whole
    process group, ``dp`` the outer axis (rank = dp * n_op + op), and its
    collectives.  Every rank builds its Comm at the same point (the
    sub-groups are made collectively)."""

    def __init__(self, n_dp: int, n_op: int, device):
        if not dist.is_initialized():
            raise RuntimeError('a mesh needs a process group: call '
                               'parallel.bootstrap.initialize_distributed '
                               'first (or launch with torchrun)')
        world = dist.get_world_size()
        if world != n_dp * n_op:
            raise ValueError(f'the mesh needs data_axis * object_axis = '
                             f'{n_dp} * {n_op} ranks, the process group '
                             f'has {world}')
        self.n_dp, self.n_op = int(n_dp), int(n_op)
        self.rank = dist.get_rank()
        self.world = world
        self.dp, self.op = divmod(self.rank, self.n_op)
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.groups: Dict[str, object] = {}
        for d in range(self.n_dp):
            g = dist.new_group([d * self.n_op + o for o in range(self.n_op)])
            if d == self.dp:
                self.groups['op'] = g
        for o in range(self.n_op):
            g = dist.new_group([d * self.n_op + o for d in range(self.n_dp)])
            if o == self.op:
                self.groups['dp'] = g
        self.groups['dp', 'op'] = None             # the whole world
        self.records: List[dict] = []
        self.host_copies: List[dict] = []
        self._pinned: Dict[Tuple, torch.Tensor] = {}

    # -- bookkeeping --------------------------------------------------------
    def size(self, axes) -> int:
        axes = self._axes(axes)
        n = 1
        for a in axes:
            n *= self.n_dp if a == 'dp' else self.n_op
        return n

    @staticmethod
    def _axes(axes) -> Tuple[str, ...]:
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(sorted(set(axes)))
        for a in axes:
            if a not in ('dp', 'op'):
                raise ValueError(f'unknown mesh axis {a!r}')
        return axes

    def _group(self, axes):
        axes = self._axes(axes)
        return self.groups[axes[0]] if len(axes) == 1 else self.groups[axes]

    def _record(self, kind, axes, t, t0, **extra):
        self.records.append(dict(kind=kind, axis='+'.join(axes),
                                 shape=tuple(t.shape),
                                 bytes=t.numel() * t.element_size(),
                                 seconds=time.perf_counter() - t0, **extra))

    def reset(self):
        """Forget the records and the host copies."""
        self.records.clear()
        self.host_copies.clear()

    def summary(self) -> Dict[str, dict]:
        """``{kind@axis: {'count', 'bytes', 'seconds'}}`` of the records,
        and ``host_copy`` for the page-locked copies."""
        out: Dict[str, dict] = defaultdict(lambda: dict(count=0, bytes=0,
                                                        seconds=0.0))
        for r in self.records:
            s = out[f"{r['kind']}@{r['axis']}"]
            s['count'] += 1
            s['bytes'] += r['bytes']
            s['seconds'] += r['seconds']
        for r in self.host_copies:
            s = out['host_copy']
            s['count'] += 1
            s['bytes'] += r['bytes']
        return dict(out)

    # -- host staging -------------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        """Whether a ring shift or an all-gather of ``t`` goes through the
        host (gloo runs ``all_reduce`` on CUDA tensors, not these)."""
        return self.backend == 'gloo' and t.device.type == 'cuda'

    def _to_host(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        key = (slot, tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        buf.copy_(t)
        self.host_copies.append(dict(slot=slot, bytes=t.numel()
                                     * t.element_size()))
        return buf

    def _from_host(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        self.host_copies.append(dict(slot='up', bytes=h.numel()
                                     * h.element_size()))
        return h.to(like.device, non_blocking=False)

    # -- collectives ----------------------------------------------------------
    def all_reduce(self, t: torch.Tensor, axes=('dp', 'op'),
                   op: str = 'sum') -> torch.Tensor:
        """Sum (or ``op='max'``) ``t`` over ``axes``, in place where ``t``
        is contiguous; returns the result.  A size-1 axis is no
        collective."""
        axes = self._axes(axes)
        if self.size(axes) == 1:
            return t
        t0 = time.perf_counter()
        if not t.is_contiguous():
            t = t.contiguous()
        rop = dist.ReduceOp.SUM if op == 'sum' else dist.ReduceOp.MAX
        dist.all_reduce(t, op=rop, group=self._group(axes))
        self._record('all_reduce', axes, t, t0, op=op)
        return t

    def ring_shift(self, t: torch.Tensor, axis: str = 'op',
                   direction: int = 1) -> torch.Tensor:
        """The ``ppermute`` of a ring over ``axis``: this rank's ``t`` goes
        to the rank ``direction`` steps on (circularly), and the result is
        what the rank ``direction`` steps back sent.  On a size-1 axis the
        rank receives its own ``t``."""
        axes = self._axes(axis)
        n = self.size(axes)
        if n == 1:
            return t.clone()
        t0 = time.perf_counter()
        me = self.op if axes == ('op',) else self.dp

        def glob(i):
            i %= n
            return (self.dp * self.n_op + i if axes == ('op',)
                    else i * self.n_op + self.op)

        src = t.contiguous()
        staged = self._staged(src)
        if staged:
            src = self._to_host(src, 'send')
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, glob(me + direction)),
               dist.P2POp(dist.irecv, out, glob(me - direction))]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        if staged:
            out = self._from_host(out, t)
        self._record('ring_shift', axes, t, t0, direction=direction)
        return out

    def all_gather(self, t: torch.Tensor, axis: str = 'op') -> torch.Tensor:
        """The ranks' ``t`` over ``axis`` joined along dim 0, in axis
        order (the object's y slabs into the whole object)."""
        axes = self._axes(axis)
        n = self.size(axes)
        if n == 1:
            return t
        t0 = time.perf_counter()
        src = t.contiguous()
        staged = self._staged(src)
        if staged:
            src = self._to_host(src, 'all_gather')
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self._group(axes))
        out = torch.cat(parts, 0)
        if staged:
            out = self._from_host(out, t)
        self._record('all_gather', axes, out, t0)
        return out

    def barrier(self, failed: bool = False) -> bool:
        """Wait for every rank of the world (a step of a sharded
        checkpoint's commit) and return whether any rank passed
        ``failed``, so that a step that failed on one rank raises on all.
        A max over one flag; recorded as its own kind, ``barrier``."""
        t0 = time.perf_counter()
        dev = self.device if self.backend == 'nccl' else 'cpu'
        t = torch.tensor([1.0 if failed else 0.0], device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        out = bool(t.item() > 0)
        self._record('barrier', ('dp', 'op'), t, t0)
        return out

    def note(self, kind: str, seconds: float):
        """Record a call of another library that runs its own collectives
        over the world's group (``dcp_save``: the plan exchange of
        ``torch.distributed.checkpoint``): its count and seconds; its
        bytes, metadata-sized, are not measured and recorded as 0."""
        self.records.append(dict(kind=kind, axis='dp+op', shape=(),
                                 bytes=0, seconds=seconds))

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (a host decision, such as a
        wall-time stop, taken the same way everywhere)."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        return bool(self.all_reduce(t, ('dp', 'op'), op='max').item() > 0)


def flat_all_reduce(comm: Comm, tensors: Sequence[torch.Tensor],
                    axes: Iterable[str]) -> List[torch.Tensor]:
    """Sum several tensors over ``axes`` in one collective (packed into
    one f32 vector); returns them in their own shapes and dtypes."""
    tensors = list(tensors)
    if comm.size(axes) == 1 or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    flat = comm.all_reduce(flat, axes)
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i:i + n].reshape(t.shape).to(t.dtype))
        i += n
    return out
