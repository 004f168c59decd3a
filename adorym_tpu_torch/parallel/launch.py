"""Ranks on one host: a world of processes, each joined to one process
group, that run the functions sent to them.  Tests and ``chip_smoke.py``
use it where ``torchrun`` would start a run: ``RankPool(4, 'cpu')`` gives
four gloo ranks on the CPU, ``RankPool(4, 'cuda:0')`` four gloo ranks that
share one card.  A function runs on every rank with the same arguments;
:meth:`RankPool.run` returns each rank's result and raises with the
traceback of any rank that failed.

The ranks are forked from multiprocessing's fork server, which imports
the caller's main module and the port (torch with it) once, before any
thread or device exists: a rank does not import torch again, and a pool
after the first starts in a fraction of a second.  The fork server (and
multiprocessing's resource tracker) outlive every pool: a program that
must leave no process behind calls :func:`shutdown` when its last pool
is closed."""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import os
import queue
import traceback
from typing import Any, List

from .bootstrap import free_port


def _rank_main(rank, world, port, device, threads, timeout_s, tasks,
               results):
    os.environ.setdefault('OMP_NUM_THREADS', str(threads))
    import torch
    torch.set_num_threads(threads)
    from .bootstrap import initialize_distributed
    try:
        initialize_distributed(f'tcp://localhost:{port}', world, rank,
                               backend='gloo', device=device,
                               local_world=world, timeout_s=timeout_s)
        results.put((rank, True, None))
    except Exception:                                    # noqa: BLE001
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            out = fn(*args, **kwargs)
            results.put((rank, True, out))
        except BaseException:                            # noqa: BLE001
            results.put((rank, False, traceback.format_exc()))
    import torch.distributed as dist
    dist.destroy_process_group()


class RankPool:
    """``world`` ranks in one gloo process group on ``device``
    (``'cpu'``, or ``'cuda:0'`` for ranks sharing a card), each with
    ``threads`` intra-op threads.  Close it (or use it as a context
    manager) to stop the processes."""

    def __init__(self, world: int, device: str = 'cpu', threads: int = 1,
                 timeout_s: float = 300.0):
        self.world, self.device, self.timeout_s = world, device, timeout_s
        ctx = mp.get_context('forkserver')
        ctx.set_forkserver_preload(['__main__', __name__])
        port = free_port()
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, world, port, device, threads,
                                         timeout_s, self._tasks[r],
                                         self._results), daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self._collect('joining the process group')

    def _collect(self, what) -> List[Any]:
        import time
        out = [None] * self.world
        errors = []
        for _ in range(self.world):
            t0 = time.monotonic()
            while True:
                try:
                    rank, ok, val = self._results.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if not p.is_alive()]
                    late = time.monotonic() - t0 > self.timeout_s
                    if dead or late:
                        self.close()
                        why = (f'ranks {dead} exited' if dead
                               else 'ranks timed out')
                        raise RuntimeError(f'{why} {what}') from None
            if ok:
                out[rank] = val
            else:
                errors.append(f'rank {rank}:\n{val}')
        if errors:
            self.close()
            raise RuntimeError(f'ranks failed {what}:\n' + '\n'.join(errors))
        return out

    def run(self, fn, *args, **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank; the ranks' results in rank
        order."""
        if not self._procs:
            raise RuntimeError('the pool is closed')
        for q in self._tasks:
            q.put((fn, args, kwargs))
        return self._collect(f'running {getattr(fn, "__name__", fn)}')

    def close(self):
        for q in self._tasks:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._procs = []
        # The queues' semaphores are unregistered from the resource tracker
        # as they are collected.
        self._tasks, self._results = [], None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def shutdown():
    """Stop the fork server and the resource tracker and wait for both, so
    that no process of the pools outlives the caller.  Close every pool
    first; a later pool starts them again."""
    mp.forkserver._forkserver._stop()
    mp.resource_tracker._resource_tracker._stop()
