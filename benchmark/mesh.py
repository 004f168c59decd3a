"""One run of a cell on several ranks: a cell whose traffic file has a
``parallel`` object (``data_axis``, ``object_axis``, ``backend``) runs on
``data_axis * object_axis`` ranks, one process and one card each, joined in
one process group, each driving the port's mesh path
(``Reconstructor(..., mesh=...)``, ``recon_mesh.mc_angle_step``) on its own
share of the object.

The process that ``run.py`` starts supervises: it starts the ranks, takes
rank 0's result through a pipe and prints it once every rank has ended
well.  A rank that fails, or a run past its deadline, ends every rank and
the run exits nonzero with no result.

A rank runs what ``harness.run_cell`` runs, with these differences:

* inputs: every rank makes all of ``inputs.make(config, traffic, seed)``
  on its card with the same generator calls and keeps its own rows of the
  object (the other rows of the array it hands the program are never
  written: pages that cost no memory) and the whole of the measured data,
  whose rows the program's layout picks;
* the window: each epoch ends in its loss fetch; rank 0's clock decides
  the last epoch and one flag summed over the ranks tells every rank;
  ``patterns`` counts every position of every angle once, the wall is
  rank 0's, the peak the largest rank's;
* the per-layer metrics: one epoch is traced, host operations and all,
  begun on every rank together; each rank reads its own trace of it over
  the epoch's span, and rank 0 combines the ranks' readings (the reader's
  ``combine``, else their mean); the breakdown is rank 0's;
* ``correct``: the program's first gradient (Adam's first moment) and
  change are reduced on each rank to sums of squares over its slab and
  summed over the object axis, never gathered; the reference
  (``reference/rows.py``) follows, on each rank, the rows of its own slab
  from the starting object over the rows its steps read, and each
  minibatch's loss is reported by the rank holding the first row of its
  window.  The row form exists for ``reference/ptycho.py`` alone: a
  configuration that names another reference is refused.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import multiprocessing as mp
import socket
import sys
import time
import traceback
import types
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, faults, guard, harness, inputs as inputs_lib, trace, work
from .reference import rows as rows_lib

#: A run's ranks are ended past this many seconds (a first run in a
#: checkout builds the kernels).
DEADLINE_S = 1150.0
#: The process group's own timeout for a collective that never completes.
GROUP_TIMEOUT_S = 150.0


def parallel(cell) -> Optional[dict]:
    """The cell's ``parallel`` object, or None for a one-card cell."""
    return cell.traffic.get('parallel')


def check_reference(cell) -> None:
    """Refuse a cell whose configuration names a reference other than
    ``ptycho``: the ranks follow rows with ``reference/rows.py``, which is
    ``ptycho``'s row form."""
    if cell.reference.stem != harness.DEFAULT_REFERENCE:
        raise ValueError(
            f"configuration {cell.config.get('name')!r}: \"reference\" "
            f'{cell.reference.stem!r} ({cell.reference}): the mesh path '
            'follows rows with reference/rows.py, the row form of ptycho '
            'alone')


def world_of(cell) -> int:
    p = parallel(cell)
    return int(p['data_axis']) * int(p['object_axis'])


# -- supervision -----------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child(rank, world, port, target, args, conn, wall0):
    """One rank's process: ``target(rank, world, port, t0, send, *args)``,
    ``t0`` the supervising process's start on this process's clock,
    ``send`` rank 0's pipe to the supervisor (None elsewhere).  Exit 4 on
    a loaded JAX, 1 on any other failure."""
    t0 = time.perf_counter() - (time.time() - wall0)
    send = conn.send if conn is not None else None
    try:
        target(rank, world, port, t0, send, *args)
    except guard.Violation as e:
        print(f'rank {rank}: loaded: {e}', file=sys.stderr, flush=True)
        sys.exit(4)
    except BaseException:                                # noqa: BLE001
        print(f'rank {rank} failed:\n{traceback.format_exc()}',
              file=sys.stderr, flush=True)
        sys.exit(1)
    finally:
        if conn is not None:
            conn.close()


def supervise(world: int, target: Callable, args: tuple, wall0: float,
              deadline_s: float = DEADLINE_S,
              on_message: Optional[Callable] = None,
              err=None) -> int:
    """Run ``target`` on ``world`` ranks (fresh processes) and wait for
    them; each message rank 0 sends goes to ``on_message``.  Returns 0
    when every rank ended with 0, else a nonzero code, once every rank
    has been ended: on the first rank that fails, or at ``deadline_s``."""
    err = err or (lambda *a: print(*a, file=sys.stderr, flush=True))
    ctx = mp.get_context('spawn')
    port = _free_port()
    recv, send = ctx.Pipe(duplex=False)
    procs = [ctx.Process(target=_child,
                         args=(r, world, port, target, args,
                               send if r == 0 else None, wall0))
             for r in range(world)]
    for p in procs:
        p.start()
    send.close()
    end = time.monotonic() + deadline_s
    code = 0
    open_pipe = True
    while True:
        while open_pipe and recv.poll(0.2):
            try:
                msg = recv.recv()
            except (EOFError, OSError):
                open_pipe = False
                break
            if on_message is not None:
                on_message(msg)
        codes = [p.exitcode for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            err(f'rank {bad[0][0]} exited with {bad[0][1]}; ending the run')
            code = bad[0][1] if bad[0][1] > 0 else 5
            break
        if all(c == 0 for c in codes):
            break
        if time.monotonic() > end:
            err(f'ranks still running after {deadline_s} s; ending the run')
            code = 6
            break
        if not open_pipe:
            time.sleep(0.2)
    if open_pipe:
        while code == 0 and recv.poll(0):
            try:
                msg = recv.recv()
            except (EOFError, OSError):
                break
            if on_message is not None:
                on_message(msg)
    for p in procs:
        if p.exitcode is None:
            p.terminate()
    for p in procs:
        p.join(timeout=10)
        if p.exitcode is None:
            p.kill()
            p.join()
    recv.close()
    return code


def _join(rank, world, port, backend, devices, pcfg):
    """Join the process group and make the mesh; returns it."""
    from adorym_tpu_torch.config import ParallelConfig
    from adorym_tpu_torch.parallel.bootstrap import initialize_distributed
    from adorym_tpu_torch.parallel.mesh import make_mesh
    dev = initialize_distributed(f'tcp://localhost:{port}', world, rank,
                                 backend=backend, device=devices[rank],
                                 local_world=world,
                                 timeout_s=GROUP_TIMEOUT_S)
    return make_mesh(ParallelConfig(data_axis=int(pcfg['data_axis']),
                                    object_axis=int(pcfg['object_axis'])),
                     device=dev)


def _leave():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _gather(obj) -> list:
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# -- set-up ----------------------------------------------------------------

def reconstructor_config(cell, seed: int):
    """``harness.reconstructor_config`` (its ``settings`` too) with the
    cell's mesh."""
    import adorym_tpu_torch as pt
    p = parallel(cell)
    return harness.reconstructor_config(cell, seed).replace(
        parallel=pt.ParallelConfig(data_axis=int(p['data_axis']),
                                   object_axis=int(p['object_axis'])))


def _sum_sq(t: torch.Tensor, minus: Optional[torch.Tensor] = None,
            divisor: float = 1.0) -> float:
    """The sum of the squares of ``(t - minus) / divisor`` in float64, by
    row chunks (the f32 difference and quotient first, as ``check`` takes
    them); ``minus`` may live on the host."""
    s = torch.zeros((), dtype=torch.float64, device=t.device)
    for r in range(0, t.shape[0], rows_lib.ROW_CHUNK):
        a = t[r:r + rows_lib.ROW_CHUNK]
        if minus is not None:
            a = a - minus[r:r + rows_lib.ROW_CHUNK].to(t.device)
        if divisor != 1.0:
            a = a / divisor
        s += a.double().square().sum()
    return float(s)


class MeshRecorder:
    """Stands in for ``recon_mesh.mc_angle_step`` through the warm-up: runs
    it, keeps each step's angle, the first ``n_check`` steps' row losses
    (whole on every rank), the sum of squares over this rank's slab of the
    first gradient as the optimizer got it and of the change after the
    last checked step, and raises the stop flag after ``n_warm`` steps."""

    def __init__(self, orig, obj0, b1: float, n_check: int, n_warm: int):
        self.orig, self.obj0, self.b1 = orig, obj0, b1
        self.n_check, self.n_warm = n_check, n_warm
        self.steps: List[dict] = []

    def __call__(self, rec, i_theta, n_b):
        out = self.orig(rec, i_theta, n_b)
        k = len(self.steps)
        st = {'i_theta': int(i_theta)}
        if k < self.n_check:
            st['losses'] = out.detach().double().cpu()
            if k == 0:
                st['grad1_sq'] = _sum_sq(rec.opt_state['obj']['m'],
                                         divisor=1 - self.b1)
            if k == self.n_check - 1:
                st['change_sq'] = _sum_sq(rec.params['obj'], self.obj0)
        self.steps.append(st)
        if len(self.steps) >= self.n_warm:
            rec.stop_requested = True
        return out


def record_steps(rec, obj0, b1: float, n_steps: int,
                 i_epoch: int = 0) -> List[dict]:
    """The first ``n_steps`` angle steps of the program's epoch
    ``i_epoch`` on this rank, through its own ``run_epoch``, stopped by its
    own stop flag; returns what :class:`MeshRecorder` kept of them."""
    from adorym_tpu_torch import recon_mesh
    orig = recon_mesh.mc_angle_step
    recorder = MeshRecorder(orig, obj0, b1, harness.N_CHECK, n_steps)
    recon_mesh.mc_angle_step = recorder
    try:
        rec.run_epoch(i_epoch)
    finally:
        recon_mesh.mc_angle_step = orig
        rec.stop_requested = False
    return recorder.steps


@dataclasses.dataclass
class Setup:
    rec: object                  # this rank's Reconstructor
    steps: List[dict]            # the checked steps (MeshRecorder's)
    obj0: torch.Tensor           # this rank's rows of the start, on the host
    probe0: torch.Tensor
    positions: np.ndarray
    theta: np.ndarray
    rows: tuple                  # this rank's object rows [a, b)
    leaves: List[str]            # the refined leaves: the object
    ref: types.ModuleType        # reference/ptycho.py


def set_up(cell, seed: int, mesh, spans, n_warm: int = harness.N_WARM
           ) -> Setup:
    """Imports, inputs, this rank's Reconstructor on the mesh and
    ``n_warm`` angle steps of its epoch 0, the first
    :data:`harness.N_CHECK` recorded."""
    c, t = cell.config, cell.traffic
    device = mesh.device
    with spans('setup.imports'):
        from adorym_tpu_torch.recon import Reconstructor
        ref = harness.load_module(cell.reference, 'bench_reference')
    # A wrong setting fails here, before any input is made.
    rcfg = reconstructor_config(cell, seed)
    with spans('setup.inputs'):
        inp = inputs_lib.make(c, t, seed, device)
        a, n = mesh.slab(int(c['obj_size'][0]))
        obj0 = inp.obj[a:a + n].cpu()
        # The program reads its own rows; the others are never written.
        obj_init = np.zeros(tuple(inp.obj.shape), np.float32)
        obj_init[a:a + n] = obj0.numpy()
        data_host = inp.data.cpu().numpy()
        probe0 = inp.probe.cpu()
        del inp
        harness._sync(device)
    with spans('setup.reconstructor'):
        rec = Reconstructor(rcfg, data=data_host,
                            probe_pos=inputs_lib.positions(t),
                            theta_ls=inputs_lib.angles(c), obj_init=obj_init,
                            probe_init=probe0.numpy(), device=device,
                            mesh=mesh)
        del data_host, obj_init
    if rec._mc is None:
        raise RuntimeError('the mesh cell does not take the per-angle mesh '
                           f'path: {rec._mc_decline_reasons}')
    with spans('setup.warmup'):
        steps = record_steps(rec, obj0, ref.ADAM_B1,
                             n_warm)[:harness.N_CHECK]
        harness._sync(device)
    return Setup(rec=rec, steps=steps, obj0=obj0, probe0=probe0,
                 positions=inputs_lib.positions(t),
                 theta=inputs_lib.angles(c), rows=(a, a + n),
                 leaves=ref.leaf_names(c), ref=ref)


# -- the comparison --------------------------------------------------------

def scan_batches(traffic: dict) -> List[np.ndarray]:
    """An angle's minibatches as the mesh path runs them: the scan's rows
    in order, the last padded by repeats of its last spot."""
    n = len(inputs_lib.positions(traffic))
    mb = int(traffic['minibatch_size'])
    spots = np.minimum(np.arange(-(-n // mb) * mb), n - 1)
    return [spots[i:i + mb] for i in range(0, len(spots), mb)]


def program_side(steps: List[dict], comm) -> dict:
    """The program's numbers (``check.numbers``' form) from the ranks'
    recorded steps: the row losses as the step returned them, the norms
    from the slabs' sums of squares summed over the object axis."""
    sums = torch.tensor([steps[0]['grad1_sq'], steps[-1]['change_sq']],
                        dtype=torch.float64, device=comm.device)
    sums = comm.all_reduce(sums, 'op').cpu()
    return {'losses': [s['losses'] for s in steps],
            'grad1': {'obj': sums[:1].sqrt()},
            'change': {'obj': sums[1:].sqrt()}}


def follow_reference(cell, su: Setup, seed: int, steps: List[dict], comm,
                     precision: str = 'f32') -> dict:
    """The reference's numbers (``check.numbers``' form) through the
    recorded steps' angles, from the seed's inputs: each rank follows the
    rows of its slab (``reference/rows.py``) and the ranks' losses and sums
    of squares are summed over the object axis."""
    c, t = cell.config, cell.traffic
    dev = comm.device
    batches = scan_batches(t)
    iy, _, pads = su.ref.windows(su.positions, c['probe_size'],
                                 c['obj_size'][:2])
    wins = [rows_lib.batch_rows(iy, pads[0][0], b) for b in batches]
    cone = rows_lib.cones([wins] * len(steps), su.rows,
                          int(c['obj_size'][0]))[0]
    inp = inputs_lib.make(c, t, seed, dev)
    obj_rows = inp.obj[cone[0]:cone[1]].clone()
    ref_steps = [{'theta': float(su.theta[s['i_theta']]), 'batches': batches,
                  'measured': inp.data[s['i_theta']].clone()} for s in steps]
    probe0 = inp.probe.clone()
    del inp
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    out = rows_lib.follow(c, obj_rows, cone, probe0, ref_steps,
                          su.positions, su.rows, precision)
    del obj_rows, ref_steps
    losses = torch.zeros((len(steps), len(batches)), dtype=torch.float64)
    for k, d in enumerate(out['losses']):
        for j, v in d.items():
            losses[k, j] = v
    red = comm.all_reduce(torch.cat([
        losses.reshape(-1), torch.tensor([out['grad1_sq'],
                                          out['change_sq']],
                                         dtype=torch.float64)]).to(dev),
        'op').cpu()
    n = losses.numel()
    return {'losses': list(red[:n].reshape(losses.shape)),
            'grad1': {'obj': red[n:n + 1].sqrt()},
            'change': {'obj': red[n + 1:n + 2].sqrt()},
            'seconds': out['seconds']}


def reference_numbers(cell, su: Setup, seed: int, comm, err,
                      after: Optional[List[dict]] = None
                      ) -> Dict[str, float]:
    """``harness.reference_numbers`` on the mesh: set-up's checked steps
    and, with ``after``, those taken after the window."""
    runs = {'': su.steps}
    if after is not None:
        runs['.after_window'] = after
    values: Dict[str, float] = {}
    for suffix, steps in runs.items():
        ok = len(steps) >= harness.N_CHECK and 'change_sq' in steps[-1]
        # Every rank takes the same branch: the steps are the epoch's.
        if not ok:
            values.update({n + suffix: math.inf for n in check.NUMBERS})
            continue
        t = time.perf_counter()
        prog = program_side(steps, comm)
        ref = follow_reference(cell, su, seed, steps, comm)
        err(f"reference: steps {ref['seconds']} s, in all "
            f'{time.perf_counter() - t:.3f} s')
        values.update({n + suffix: v
                       for n, v in check.numbers(prog, ref).items()})
    return values


# -- one run on one rank ---------------------------------------------------

def combine(mod, values: list):
    """The ranks' readings of one metric: the reader's own ``combine``, or
    the mean of those that read; None where none did."""
    got = [v for v in values if v is not None]
    if not got:
        return None
    if hasattr(mod, 'combine'):
        return mod.combine(values)
    return sum(got) / len(got)


def run_rank(cell, seed: int, seconds: float, traced: bool, mesh,
             t0: float, err=None) -> Optional[dict]:
    """One run on this rank; rank 0 returns ``{'result', 'spans',
    'check_lines'}``, the others None."""
    err = err or (lambda *a: print(*a, file=sys.stderr, flush=True))
    comm = mesh.comm
    lead = mesh.rank == 0
    say = err if lead else (lambda *a: None)
    device = mesh.device
    spans = harness.Spans(t0)
    c, t = cell.config, cell.traffic
    spans.rows.append({'span': 'setup.process', 'parent': 'setup',
                       'start_s': 0.0, 'end_s': time.perf_counter() - t0})
    with spans('setup'):
        su = set_up(cell, seed, mesh, spans)
        comm.barrier()
    rec = su.rec
    route = {k: getattr(rec, k, None) for k in
             ('_grid_scatter_rows', '_fuse_g', '_rowgrid_stride',
              '_data_dev_ok', '_prebin', '_stream_rot')}
    route['mesh'] = [mesh.n_dp, mesh.n_op]
    route['mc'] = {k: rec._mc[k] for k in ('g_rows', 'n_c', 'S_u', 'S_p',
                                           'h1', 'h2', 'prebin')}
    route['K4_BLOCKS_PER_SM'] = harness.k4_blocks_per_sm()
    say(f'route {json.dumps(route, default=str)}')
    setup_s = time.perf_counter() - t0

    # -- the window ------------------------------------------------------
    n_theta, n_pos = rec.n_theta, rec.n_pos
    gc.collect()
    harness._sync(device)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    walls, losses = [], []
    w0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        losses.append(harness._epoch(rec, spans, 1 + len(walls)))
        walls.append(time.perf_counter() - a)
        if comm.any(lead and time.perf_counter() - w0 >= seconds):
            break
    window_wall = time.perf_counter() - w0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else None)
    found = guard.loaded()
    if found:
        raise guard.Violation(found)
    peaks = _gather(peak)
    epochs = len(walls)
    say(f'window: {epochs} epochs, walls {walls} s, losses {losses}; '
        f'peaks by rank {peaks}')
    peak_all = None if None in peaks else max(peaks)
    ctx = types.SimpleNamespace(
        cell=cell.name, config=c, traffic=t, setup_s=setup_s,
        window_wall_s=window_wall, patterns=epochs * n_theta * n_pos,
        n_angles=epochs * n_theta, memory_peak_bytes=peak_all, work=work,
        peaks=None, summary=None, folder=None, epoch_s=window_wall / epochs)
    dev_out = harness.device_info(device)
    dev_out['count'] = mesh.comm.world
    dev_out['memory_peak_bytes'] = peak_all
    result = {'correct': False, 'attempted': epochs * n_theta,
              'failed': sum(n_theta for v in losses if not math.isfinite(v)),
              'metrics': {}, 'device': dev_out}
    next_epoch = 1 + epochs
    if traced:
        summary, wall = traced_epoch(rec, spans, next_epoch, comm, say)
        next_epoch += 1
        say(f"traced epoch {wall} s against the window's "
            f'{ctx.epoch_s} s untraced')
        peaks_tab = json.loads((cell.bench / 'peaks.json').read_text())
        ctx.peaks = peaks_tab.get(dev_out['kind'])
        ctx.summary = summary
        ctx.n_angles = n_theta
        mods, mine = {}, {}
        for m in cell.per_layer:
            ctx.folder = harness._named(cell.bench / 'metrics', m['name'], '')
            mods[m['name']] = harness.load_module(
                harness._named(cell.bench / 'metrics', m['name']))
            mine[m['name']] = mods[m['name']].read(ctx)
        busy = None if summary is None else (summary.busy_s,
                                             summary.window_s)
        ranks = _gather((mine, busy))
        say(f'per-layer readings by rank {json.dumps(ranks)}')
        for m in cell.per_layer:
            v = combine(mods[m['name']], [r[0][m['name']] for r in ranks])
            if v is not None:
                result['metrics'][m['name']] = {'value': v, 'unit': m['unit']}
        busies = [r[1] for r in ranks if r[1] is not None]
        if summary is not None and len(busies) == len(ranks):
            dev_out['busy_s'] = sum(b for b, _ in busies) / len(busies)
            dev_out['window_s'] = sum(w for _, w in busies) / len(busies)
            result['breakdown'] = {
                'device_ops': trace.top(summary.device_ops),
                'idle_gaps': trace.top(summary.idle_by_host_op)}
    elif lead:
        for m in cell.end_to_end:
            v = harness.load_reader(harness._named(cell.bench / 'end_to_end',
                                                   m['name']))(ctx)
            if v is not None:
                result['metrics'][m['name']] = {'value': v, 'unit': m['unit']}

    # -- checked steps again after the window ------------------------------
    with spans('after_window'):
        harness.reset_to_start(rec, su)
        after = record_steps(rec, su.obj0, su.ref.ADAM_B1, harness.N_CHECK,
                             next_epoch)[:harness.N_CHECK]
        harness._sync(device)

    # -- the comparison, once the program's state is freed -----------------
    del rec
    su.rec = None
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    with spans('reference'):
        values = reference_numbers(cell, su, seed, comm, say, after=after)
    if device.type == 'cuda':
        say(f'reference: peaks by rank '
            f'{_gather(torch.cuda.max_memory_allocated(device))}')
    found = guard.loaded()
    if found:
        raise guard.Violation(found)
    if not lead:
        return None
    ok, judged = check.judge(values, cell.limits)
    result['correct'] = ok
    result['check'] = judged
    return {'result': result, 'spans': spans.rows,
            'check_lines': [f"check {n} {v['value']!r} limit {v['limit']!r}"
                            for n, v in judged.items()]}


def traced_epoch(rec, spans, i_epoch: int, comm, err):
    """One epoch under the profiler, the card's activity and the host's
    operations both, begun on every rank together (a barrier once each
    profiler has started: starting one takes seconds, and unevenly);
    returns the summary over the epoch's own span, which the barrier
    precedes, and the epoch's wall."""
    comm.barrier()
    prof = harness._profile(comm.device, host_ops=True)
    try:
        comm.barrier()
        a = time.perf_counter()
        harness._epoch(rec, spans, i_epoch, 'trace.epoch')
        wall = time.perf_counter() - a
    finally:
        prof.__exit__(None, None, None)
    t = time.perf_counter()
    events = trace.from_profiler(prof)
    del prof
    summary = trace.summarize(events, harness.WINDOW_SPAN)
    err(f'trace: {len(events)} events; window found: {summary is not None}'
        f'; reduced in {time.perf_counter() - t:.3f} s')
    return summary, wall


def _run_target(rank, world, port, t0, send, cell, seed, seconds, traced,
                backend, devices, fault):
    mesh = _join(rank, world, port, backend, devices, parallel(cell))
    try:
        with (faults.planted(fault) if fault
              else contextlib.nullcontext()):
            out = run_rank(cell, seed, seconds, traced, mesh, t0)
        if send is not None:
            send(out)
    finally:
        _leave()


def main(cell, seed: int, seconds: float, traced: bool, wall0: float,
         backend: Optional[str] = None, devices: Optional[List[str]] = None,
         fault: Optional[str] = None, deadline_s: float = DEADLINE_S,
         log=print, err=None) -> int:
    """Run the mesh cell on its ranks; print rank 0's spans, its check
    lines (last on standard error) and the result's line, and return 0;
    or return nonzero with no result."""
    err = err or (lambda *a: print(*a, file=sys.stderr, flush=True))
    check_reference(cell)
    p = parallel(cell)
    world = world_of(cell)
    if world != cell.chips:
        err(f'{cell.name}: parallel {p} makes {world} ranks, the cell asks '
            f'for {cell.chips} chips')
        return 2
    backend = backend or p['backend']
    devices = devices or [f'cuda:{r}' for r in range(world)]
    got = []
    code = supervise(world, _run_target,
                     (cell, seed, seconds, traced, backend, devices, fault),
                     wall0, deadline_s, on_message=got.append, err=err)
    if code != 0:
        return code
    if len(got) != 1:
        err(f'rank 0 sent {len(got)} results')
        return 7
    out = got[0]
    found = guard.loaded()
    if found:
        err(f'loaded: {found}')
        return 4
    for row in out['spans']:
        log('span ' + json.dumps(row))
    for line in out['check_lines']:
        err(line)
    log(json.dumps(out['result']))
    return 0


# -- the limits' readings ----------------------------------------------------

def _calibrate_target(rank, world, port, t0, send, cell, seeds, modes,
                      backend, devices):
    mesh_ = _join(rank, world, port, backend, devices, parallel(cell))
    err = (lambda *a: print(*a, file=sys.stderr, flush=True))
    planted = [m for m in modes if m not in ('sound', 'control')]
    try:
        for seed in seeds:
            took = {}
            a = time.perf_counter()
            su = set_up(cell, seed, mesh_, harness.Spans(a),
                        n_warm=harness.N_CHECK)
            prog = {'sound': program_side(su.steps, mesh_.comm)}
            took['sound'] = time.perf_counter() - a
            # Each fault through the same program from set-up's start, as
            # the steps after a run's window are taken.
            for mode in planted:
                a = time.perf_counter()
                with faults.planted(mode):
                    harness.reset_to_start(su.rec, su)
                    steps = record_steps(su.rec, su.obj0, su.ref.ADAM_B1,
                                         harness.N_CHECK)
                if [s['i_theta'] for s in steps] != [
                        s['i_theta'] for s in su.steps]:
                    raise RuntimeError(f'{mode} changed the angles')
                prog[mode] = program_side(steps, mesh_.comm)
                took[mode] = time.perf_counter() - a
            su.rec = None
            gc.collect()
            if mesh_.device.type == 'cuda':
                torch.cuda.empty_cache()
            a = time.perf_counter()
            ref = follow_reference(cell, su, seed, su.steps, mesh_.comm)
            took['reference'] = time.perf_counter() - a
            if 'control' in modes:
                a = time.perf_counter()
                prog['control'] = follow_reference(
                    cell, su, seed, su.steps, mesh_.comm, precision='tf32')
                took['control'] = time.perf_counter() - a
            for mode in modes:
                row = {'cell': cell.name, 'mode': mode, 'seed': seed,
                       **check.numbers(prog[mode], ref),
                       'seconds': took[mode]}
                if send is not None:
                    send(row)
                if mesh_.rank == 0:
                    err(json.dumps(row))
            if mesh_.rank == 0:
                err(f'seed {seed}: reference {took["reference"]:.1f} s')
    finally:
        _leave()


def calibrate(cell, seeds: List[int], modes: List[str], wall0: float,
              backend: Optional[str] = None,
              devices: Optional[List[str]] = None) -> tuple:
    """``calibrate.py``'s readings of a mesh cell: for each seed a sound
    set-up, each planted fault through the same program from its start,
    the reference once, and the control (the reference at TF32), all
    against that reference.  Returns ``(code, rows)``."""
    check_reference(cell)
    p = parallel(cell)
    world = world_of(cell)
    backend = backend or p['backend']
    devices = devices or [f'cuda:{r}' for r in range(world)]
    modes = ['sound'] + [m for m in modes if m != 'sound']
    rows = []
    code = supervise(world, _calibrate_target,
                     (cell, seeds, modes, backend, devices), wall0,
                     deadline_s=3500.0, on_message=rows.append)
    return code, rows
