"""One run of one cell: resolve the cell's files by name, make the inputs
from the seed, build the program's ``Reconstructor``, take its first steps
(checked later against the plain reference) as the warm-up, run whole
epochs for the window, read the metrics, free the program, run the
reference and judge.

Everything that belongs to one configuration, mix or metric is a file
found by name under the benchmark's folder:

* ``configs/<config>.json`` (the ``file`` of the configuration's entry in
  ``BENCHMARK.json``), ``traffic/<traffic>.json``; the configuration's
  ``object_init`` is read by ``inputs.make`` and its ``settings`` by
  :func:`reconstructor_config`;
* ``reference/<name>.py``, ``<name>`` the configuration's ``"reference"``
  (``ptycho`` where it names none): the plain reference that judges the
  cell, loaded as the readers are, a module with
  - ``follow(cfg, obj0, probe0, steps, positions, precision)``: its run
    from ``(obj0, probe0)`` through ``steps`` (each ``{'theta',
    'batches', 'measured'}``) in ``precision``, ``'f32'`` or the
    control's ``'tf32'`` (its matmuls' operands rounded to TF32); returns
    ``{'losses': [each step's per-minibatch losses], 'grad1': {leaf: the
    first step's gradient}, 'change': {leaf: the change after the last
    step}, 'seconds': [each step's]}``;
  - ``leaf_names(cfg)``: the leaves it refines (``'obj'`` first);
  - ``ADAM_B1``: the first moment's decay of the Adam it follows, by
    which the program's first gradient is read from its Adam state;
* ``limits/<cell>.json``: the comparison's limits of the cell;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: each a reader
  ``read(ctx)`` that returns the metric or None (nothing to read), and a
  per-layer metric's folder ``metrics/<metric>/`` for its own data.  A
  metric named ``<base>.<qualifier>`` with no files of its own (one
  quantity under a name of its own in some cells, so that it takes its
  own bound) is read by ``<base>``'s.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import re
import sys
import time
import types
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, guard, inputs as inputs_lib, trace, work
from .work import multislice as _multislice  # noqa: F401 (work.multislice)

BENCH = Path(__file__).resolve().parent
#: Steps the reference follows; the warm-up takes at least this many.
N_CHECK = 3
#: Angle steps of the warm-up (the checked ones first), through the same
#: ``run_epoch`` the window calls, stopped by the program's own stop flag.
N_WARM = 6
WINDOW_SPAN = 'bench.epoch'
#: The reference of a configuration that names none.
DEFAULT_REFERENCE = 'ptycho'
REFERENCE_NAME = re.compile(r'[A-Za-z0-9_]+')


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]
    bench: Path
    reference: Path              # reference/<name>.py


def _entry(items, name, what):
    for it in items:
        if it['name'] == name:
            return it
    raise SystemExit(f'no {what} named {name!r} in BENCHMARK.json')


def _applies(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def load_cell(name: str, root: Path, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    w = _entry(spec['workloads'], name, 'workload')
    c = _entry(spec['configs'], w['config'], 'configuration')
    config = json.loads((root / c['file']).read_text())
    traffic = json.loads((bench / 'traffic' / f"{w['traffic']}.json")
                         .read_text())
    return Cell(name=name, chips=int(w['chips']), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec['end_to_end']
                            if _applies(m, name)],
                per_layer=[m for m in spec['per_layer'] if _applies(m, name)],
                limits=check.load_limits(bench / 'limits' / f'{name}.json'),
                bench=bench,
                reference=reference_path(config, bench, c['file']))


def reference_path(config: dict, bench: Path, file: str) -> Path:
    """``bench/reference/<name>.py`` of the configuration's ``"reference"``
    (``file``: the configuration's file, for the message)."""
    name = config.get('reference', DEFAULT_REFERENCE)
    if not isinstance(name, str) or not REFERENCE_NAME.fullmatch(name):
        raise ValueError(f'{file}: "reference" {name!r} is not a module name '
                         f'([A-Za-z0-9_]+) of {bench / "reference"}')
    path = bench / 'reference' / f'{name}.py'
    if not path.is_file():
        raise ValueError(f'{file}: "reference" {name!r}: there is no {path}')
    return path


def load_module(path: Path, prefix: str = 'bench_reader'):
    """A metric's reader file (or a reference) as a module."""
    spec = importlib.util.spec_from_file_location(
        f'{prefix}_{path.stem}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(path: Path) -> Callable:
    return load_module(path).read


class Spans:
    """Set-up phases and epochs as ``(name, parent, start, end)`` seconds
    since the process started, kept in memory and printed at the end."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.rows: List[dict] = []
        self._open: List[str] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        parent = self._open[-1] if self._open else None
        self._open.append(name)
        a = time.perf_counter()
        try:
            yield
        finally:
            b = time.perf_counter()
            self._open.pop()
            self.rows.append({'span': name, 'parent': parent,
                              'start_s': a - self.t0, 'end_s': b - self.t0})


def reconstructor_config(cell: Cell, seed: int):
    """The Reconstructor's configuration: the fields below from the
    configuration's flat keys, the traffic's minibatch and the seed, then
    each key of the configuration's ``settings`` (``{"geometry": {...},
    "train": {...}, "refine": {...}}``) on its group's dataclass.  A
    setting that the dataclass lacks, or that is one of the fields below,
    fails."""
    import adorym_tpu_torch as pt
    c, t = cell.config, cell.traffic
    groups = {
        'geometry': (pt.Geometry, dict(
            obj_size=tuple(c['obj_size']), probe_size=tuple(c['probe_size']),
            energy_ev=c['energy_ev'], psize_cm=c['psize_cm'],
            free_prop_cm=c['free_prop_cm'], binning=c['binning'])),
        'train': (pt.TrainConfig, dict(
            minibatch_size=t['minibatch_size'],
            learning_rate=c['learning_rate'], optimizer=c['optimizer'],
            rotate_out_of_loop=c['rotate_out_of_loop'],
            update_scheme=c['update_scheme'], unknown_type=c['unknown_type'],
            n_probe_modes=c['n_probe_modes'], seed=int(seed) % (2 ** 32))),
        'refine': (pt.RefineConfig, dict(
            optimize_probe=c['optimize_probe'],
            probe_learning_rate=c.get('probe_learning_rate', 1e-3))),
    }
    settings = c.get('settings', {})
    where = f"configuration {c.get('name')!r}: settings"
    for g in settings:
        if g not in groups:
            raise ValueError(f'{where}.{g}: no such group (geometry, train, '
                             'refine)')
    built = {}
    for g, (cls, flat) in groups.items():
        own = settings.get(g, {})
        fields = {f.name for f in dataclasses.fields(cls)}
        for k in own:
            if k not in fields:
                raise ValueError(f'{where}.{g}.{k}: {cls.__name__} has no '
                                 f'field {k!r}')
            if k in flat:
                raise ValueError(f'{where}.{g}.{k}: set from the '
                                 "configuration's flat keys, the traffic "
                                 'or the seed; give it there alone')
        built[g] = cls(**flat, **own)
    return pt.ReconConfig(**built)


class StepRecorder:
    """Stands in for the Reconstructor's ``angle_step`` through the warm-up:
    runs it, keeps each step's angle and minibatches, the first
    ``n_check`` steps' losses, the first gradient as the optimizer got it
    (Adam's first moment after the first step over ``1 - b1``) and the
    parameters after the last checked one, and raises the program's stop
    flag after ``n_warm`` steps."""

    def __init__(self, rec, leaves, b1: float, n_check: int, n_warm: int):
        self.rec, self.leaves, self.b1 = rec, leaves, b1
        self.n_check, self.n_warm = n_check, n_warm
        self.orig = rec.angle_step
        self.steps: List[dict] = []

    def __call__(self, i_theta, inds_list, measured=None):
        out = self.orig(i_theta, inds_list, measured)
        rec, k = self.rec, len(self.steps)
        st = {'i_theta': int(i_theta),
              'batches': [np.asarray(b).copy() for b in inds_list]}
        if k < self.n_check:
            st['losses'] = out.detach().double().cpu()
            if k == 0:
                st['grad1'] = {n: rec.opt_state[n]['m'].detach().cpu()
                               / (1 - self.b1) for n in self.leaves}
            if k == self.n_check - 1:
                st['params'] = {n: rec.params[n].detach().cpu()
                                for n in self.leaves}
        self.steps.append(st)
        if len(self.steps) >= self.n_warm:
            rec.stop_requested = True
        return out


def record_steps(rec, leaves, b1: float, n_steps: int,
                 i_epoch: int = 0) -> List[dict]:
    """The first ``n_steps`` angle steps of the program's epoch
    ``i_epoch``, through its own ``run_epoch``, stopped by its own stop
    flag; returns what :class:`StepRecorder` kept of them."""
    recorder = StepRecorder(rec, leaves, b1, N_CHECK, n_steps)
    rec.angle_step = recorder
    try:
        rec.run_epoch(i_epoch)
    finally:
        del rec.angle_step
        rec.stop_requested = False
    return recorder.steps


def reset_to_start(rec, su: 'Setup') -> None:
    """The program's parameters, Adam's moments and its step counters back
    to their values at set-up's start, in place; whatever else it keeps
    (caches, staged data, anything the window left) stays as it is."""
    with torch.no_grad():
        rec.params['obj'].copy_(su.obj0)
        if 'probe' in su.leaves:
            rec.params['probe'].copy_(su.probe0)
        for n in su.leaves:
            for a in rec.opt_state[n].values():
                a.zero_()
    rec.i_opt_batch = 0
    rec.global_batch = 0


def k4_blocks_per_sm() -> dict:
    """The port's record of K4's resident blocks an SM by launch shape
    (``ops/cuda_multislice.K4_BLOCKS_PER_SM``), for the route line; empty
    where no K4 launched, None in a version without it."""
    from adorym_tpu_torch.ops import cuda_multislice
    got = getattr(cuda_multislice, 'K4_BLOCKS_PER_SM', None)
    return None if got is None else {str(k): v for k, v in got.items()}


def device_info(device) -> dict:
    if device.type == 'cuda':
        return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
                'count': 1}
    return {'platform': device.type, 'kind': device.type, 'count': 1}


def power_limit() -> Optional[str]:
    import subprocess
    try:
        r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Setup:
    rec: object                  # the program's Reconstructor
    steps: List[dict]            # the checked steps (StepRecorder's)
    obj0: torch.Tensor           # the inputs, on the host
    probe0: torch.Tensor
    positions: np.ndarray
    theta: np.ndarray
    data: np.ndarray             # the measured magnitudes, on the host
    leaves: List[str]
    ref: types.ModuleType        # the cell's reference (reference/<name>.py)


def set_up(cell: Cell, seed: int, device, spans: Spans,
           n_warm: int = N_WARM) -> Setup:
    """Imports, inputs, the Reconstructor, and ``n_warm`` angle steps of
    its epoch 0 with the first :data:`N_CHECK` recorded."""
    c, t = cell.config, cell.traffic
    device = torch.device(device)
    with spans('setup.imports'):
        import adorym_tpu_torch  # noqa: F401
        ref = load_module(cell.reference, 'bench_reference')
    # A wrong setting fails here, before any input is made.
    rcfg = reconstructor_config(cell, seed)
    with spans('setup.inputs'):
        inp = inputs_lib.make(c, t, seed, device)
        data_host = inp.data.cpu().numpy()
        obj0, probe0 = inp.obj.cpu(), inp.probe.cpu()
        inp.data = inp.obj = inp.probe = None
        _sync(device)
    with spans('setup.reconstructor'):
        from adorym_tpu_torch.recon import Reconstructor
        rec = Reconstructor(rcfg, data=data_host, probe_pos=inp.positions,
                            theta_ls=inp.theta, obj_init=obj0.numpy(),
                            probe_init=probe0.numpy(), device=device)
    leaves = ref.leaf_names(c)
    with spans('setup.warmup'):
        steps = record_steps(rec, leaves, ref.ADAM_B1, n_warm)[:N_CHECK]
        _sync(device)
    return Setup(rec=rec, steps=steps, obj0=obj0, probe0=probe0,
                 positions=inp.positions, theta=inp.theta, data=data_host,
                 leaves=leaves, ref=ref)


def _profile(device, host_ops: bool):
    """A started ``torch.profiler`` of the card's activity (kernels, copies,
    fills and the host's CUDA runtime calls) and, with ``host_ops``, of
    the host's operations and ranges too."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if device.type == 'cuda' else []
    if host_ops or not acts:
        acts.append(ProfilerActivity.CPU)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _epoch(rec, spans, i_epoch: int, span: str = 'window.epoch') -> float:
    with spans(span), torch.profiler.record_function(WINDOW_SPAN):
        return rec.run_epoch(i_epoch)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t0: float, log=print, err=None, before_check=None) -> dict:
    """One run; returns the result's object (the last line's), and prints
    the spans and the comparison's lines through ``log`` / ``err``."""
    err = err or (lambda *a: print(*a, file=sys.stderr, flush=True))
    device = torch.device(device)
    spans = Spans(t0)
    c, t = cell.config, cell.traffic
    spans.rows.append({'span': 'setup.process', 'parent': 'setup',
                       'start_s': 0.0, 'end_s': time.perf_counter() - t0})
    with spans('setup'):
        su = set_up(cell, seed, device, spans)
    rec = su.rec
    route = {k: getattr(rec, k, None) for k in
             ('_grid_scatter_rows', '_fuse_g', '_rowgrid_stride',
              '_data_dev_ok', '_prebin', '_stream_rot')}
    route['K4_BLOCKS_PER_SM'] = k4_blocks_per_sm()
    err(f'route {json.dumps(route, default=str)}')
    setup_s = time.perf_counter() - t0

    # -- the window ----------------------------------------------------
    n_theta = rec.n_theta
    n_pos = rec.n_pos
    gc.collect()
    _sync(device)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    walls, losses = [], []
    w0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        losses.append(_epoch(rec, spans, 1 + len(walls)))
        walls.append(time.perf_counter() - a)
        if time.perf_counter() - w0 >= seconds:
            break
    window_wall = time.perf_counter() - w0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else None)
    found = guard.loaded()
    if found:
        raise guard.Violation(found)
    epochs = len(walls)
    err(f'window: {epochs} epochs, walls {walls} s, losses {losses}')
    ctx = types.SimpleNamespace(
        cell=cell.name, config=c, traffic=t, setup_s=setup_s,
        window_wall_s=window_wall, patterns=epochs * n_theta * n_pos,
        n_angles=epochs * n_theta, memory_peak_bytes=peak, work=work,
        peaks=None, summary=None, folder=None, epoch_s=window_wall / epochs)
    dev_out = device_info(device)
    dev_out['memory_peak_bytes'] = peak
    result = {'correct': False, 'attempted': epochs * n_theta,
              'failed': sum(n_theta for v in losses if not math.isfinite(v)),
              'metrics': {}, 'device': dev_out}
    next_epoch = 1 + epochs
    if traced:
        # One epoch after the window, the card's activity and the host's
        # CUDA calls traced (the per-layer metrics), then one with the
        # host's operations traced too (the breakdown's idle gaps alone:
        # tracing host operations slows a host-paced step).
        summary, wall = _traced_epoch(rec, spans, next_epoch, device, None,
                                      err)
        hosted, _ = _traced_epoch(rec, spans, next_epoch + 1, device,
                                  WINDOW_SPAN, err)
        next_epoch += 2
        err(f'traced epoch {wall} s against the window\'s '
            f'{ctx.epoch_s} s untraced')
        peaks = json.loads((cell.bench / 'peaks.json').read_text())
        ctx.peaks = peaks.get(dev_out['kind'])
        ctx.summary = summary
        ctx.n_angles = n_theta
        for m in cell.per_layer:
            ctx.folder = _named(cell.bench / 'metrics', m['name'], '')
            v = load_reader(_named(cell.bench / 'metrics', m['name']))(ctx)
            if v is not None:
                result['metrics'][m['name']] = {'value': v, 'unit': m['unit']}
        if summary is not None:
            dev_out['busy_s'] = summary.busy_s
            dev_out['window_s'] = summary.window_s
            result['breakdown'] = {
                'device_ops': trace.top(summary.device_ops),
                'idle_gaps': trace.top((hosted or summary).idle_by_host_op)}
    else:
        for m in cell.end_to_end:
            v = load_reader(_named(cell.bench / 'end_to_end', m['name']))(ctx)
            if v is not None:
                result['metrics'][m['name']] = {'value': v, 'unit': m['unit']}

    # -- checked steps again after the window: set-up's start, the first
    # -- angles of an epoch not run yet, the program's other state as the
    # -- window left it ------------------------------------------------
    with spans('after_window'):
        reset_to_start(rec, su)
        after = record_steps(rec, su.leaves, su.ref.ADAM_B1, N_CHECK,
                             next_epoch)[:N_CHECK]
        _sync(device)

    # -- the comparison, once the program's state is freed ---------------
    del rec
    su.rec = None
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    if before_check is not None:
        before_check()
    with spans('reference'):
        values = reference_numbers(cell, su, device, err, after=after)
    ok, judged = check.judge(values, cell.limits)
    result['correct'] = ok
    result['check'] = judged
    found = guard.loaded()
    if found:
        raise guard.Violation(found)
    for row in spans.rows:
        log('span ' + json.dumps(row))
    for n, v in judged.items():
        err(f"check {n} {v['value']!r} limit {v['limit']!r}")
    return result


def _traced_epoch(rec, spans, i_epoch: int, device, window_span, err):
    """One epoch under the profiler: with ``window_span`` None the card's
    activity and the host's CUDA calls, else the host's operations and
    ranges too; returns the trace's summary and the epoch's wall."""
    prof = _profile(device, host_ops=window_span is not None)
    try:
        a = time.perf_counter()
        _epoch(rec, spans, i_epoch, 'trace.epoch')
        wall = time.perf_counter() - a
    finally:
        prof.__exit__(None, None, None)
    t = time.perf_counter()
    events = trace.from_profiler(prof)
    del prof
    summary = trace.summarize(events, window_span)
    kinds = collections.Counter(e[1] for e in events)
    err(f'trace: {len(events)} events {dict(kinds)}; window found: '
        f'{summary is not None}; reduced in {time.perf_counter() - t:.3f} s')
    return summary, wall


def _named(folder: Path, name: str, suffix: str = '.py') -> Path:
    """``folder/<name><suffix>``, or where there is none and ``name`` is
    ``<base>.<qualifier>`` (one quantity reported under a name of its own
    in some cells), ``folder/<base><suffix>``."""
    own = folder / f'{name}{suffix}'
    if own.exists() or '.' not in name:
        return own
    return folder / f"{name.split('.')[0]}{suffix}"


def reference_numbers(cell: Cell, su: Setup, device, err=None,
                      after: Optional[List[dict]] = None) -> Dict[str, float]:
    """The comparison's numbers of the recorded steps against the
    reference; with ``after`` (the steps taken after the window) those
    steps' numbers too, under ``<number>.after_window``."""
    runs = {'': su.steps}
    if after is not None:
        runs['.after_window'] = after
    values: Dict[str, float] = {}
    for suffix, steps in runs.items():
        if len(steps) < N_CHECK or 'params' not in steps[-1]:
            values.update({n + suffix: math.inf for n in check.NUMBERS})
            continue
        t = time.perf_counter()
        ref = follow_reference(cell, su, device, steps=steps)
        if err is not None:
            err(f"reference: steps {ref['seconds']} s, in all "
                f'{time.perf_counter() - t:.3f} s')
        prog = check.program_side(steps, su.obj0, su.probe0, su.leaves)
        values.update({n + suffix: v
                       for n, v in check.numbers(prog, ref).items()})
    return values


def follow_reference(cell: Cell, su: Setup, device, precision: str = 'f32',
                     steps: Optional[List[dict]] = None) -> dict:
    """The reference's run through the recorded steps' angles and
    minibatches (set-up's, or ``steps``), from the same inputs, in
    ``precision``."""
    ref_steps = [{'theta': float(su.theta[s['i_theta']]),
                  'batches': s['batches'],
                  'measured': torch.from_numpy(su.data[s['i_theta']])
                  .to(device)}
                 for s in (su.steps if steps is None else steps)]
    return su.ref.follow(cell.config, su.obj0.to(device),
                         su.probe0.to(device), ref_steps, su.positions,
                         precision)
