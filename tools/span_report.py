"""One traced run of a benchmark cell with the program's spans read out.

    python tools/span_report.py --workload cone256_db.per_angle \
        --seed 1234567891 [--root CHECKOUT] [--seconds 30] [--out FILE]

Runs ``benchmark/run.py``'s cell of the checkout ``--root`` (this one by
default) in this process with ``--trace 1`` and prints its result line,
then one JSON object (also written to ``--out``): the traced epochs'
walls beside the untraced window's mean epoch; the spans an angle of the
first traced epoch (stream ms, host ms, count, host waits) from
``adorym_tpu_torch.utils.profiling``'s registry, where the checkout has
one; the whole idle-gap table of the epoch traced with host operations,
by the innermost host range open at each gap; and the device time of
each kernel by the ``adorym.*`` span that launched it (the launch's
correlation id to its host call, the call's time to the innermost span
open), with the index gathers (``index_elementwise``) summed by span.
"""

import argparse
import collections
import json
import os
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
DEVICE = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _by_span(prof, trace):
    """Device ns by (innermost adorym.* span at launch, kernel name), and
    host waits by (innermost adorym.* span, call name)."""
    evs = list(prof.profiler.kineto_results.events())
    launch = {}
    marks = []
    kernels = []
    waits = []
    for e in evs:
        c = trace.category(e)
        name = e.name()
        if name.startswith(('adorym.', 'bench.')):
            # A span: its host range; its device-side copy is no work.
            if c not in DEVICE:
                a = e.start_ns()
                marks.append((a, 0, name))
                marks.append((a + e.duration_ns(), 2, name))
        elif c in ('cuda_runtime', 'cuda_driver'):
            launch[e.correlation_id()] = e.start_ns()
            if trace.is_sync(name):
                waits.append((e.start_ns(), name))
        elif c in DEVICE:
            kernels.append((e.correlation_id(), name, e.duration_ns()))
    points = list(marks)
    for i, (corr, _, _) in enumerate(kernels):
        t = launch.get(corr)
        if t is not None:
            points.append((t, 1, i))
    for j, (t, _) in enumerate(waits):
        points.append((t, 1, -1 - j))
    points.sort(key=lambda p: (p[0], p[1]))
    owner = {}
    stack = []
    for t, kind, x in points:
        if kind == 0:
            stack.append(x)
        elif kind == 2:
            if x in stack:
                stack.reverse()
                stack.remove(x)
                stack.reverse()
        else:
            owner[x] = next((m for m in reversed(stack)
                             if m.startswith('adorym.')), '(no span)')
    out = collections.Counter()
    for i, (_, name, ns) in enumerate(kernels):
        out[(owner.get(i, '(no launch)'), name[:90])] += ns
    synced = collections.Counter(
        f'{owner.get(-1 - j)} {name}' for j, (_, name) in enumerate(waits))
    return out, synced


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--root', default=str(Path(__file__).resolve().parents[1]))
    p.add_argument('--seconds', type=float, default=30.0)
    p.add_argument('--out')
    p.add_argument('--device', default='cuda:0')
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    out = Path(args.out).resolve() if args.out else None
    for var, d in (('PYTORCH_KERNEL_CACHE_PATH', 'torch_kernels'),
                   ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton')):
        os.environ[var] = str(root / 'build' / d)
    for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
        os.environ[var] = '1'
    sys.path.insert(0, str(root))
    os.chdir(root)

    import torch
    from benchmark import harness, trace

    profs, summaries, walls = [], [], []
    profile, summarize = harness._profile, trace.summarize
    traced_epoch = harness._traced_epoch

    def keep_profile(device, host_ops):
        prof = profile(device, host_ops)
        profs.append((host_ops, prof))
        return prof

    def keep_summary(events, window_span=None):
        s = summarize(events, window_span)
        summaries.append(s)
        return s

    def keep_epoch(*a, **k):
        out = traced_epoch(*a, **k)
        walls.append(out[1])
        return out

    harness._profile = keep_profile
    trace.summarize = keep_summary
    harness._traced_epoch = keep_epoch
    window = {}
    err_lines = []

    def err(*a):
        line = ' '.join(str(x) for x in a)
        err_lines.append(line)
        if line.startswith('traced epoch'):
            window['line'] = line
        print(line, file=sys.stderr, flush=True)

    cell = harness.load_cell(args.workload, root)
    result = harness.run_cell(cell, args.seed, args.seconds, True,
                              args.device, T0, log=lambda *a: None, err=err)
    print(json.dumps(result), flush=True)

    report = {'root': str(root), 'workload': args.workload,
              'seed': args.seed, 'card': harness.device_info(
                  torch.device(args.device))['kind'],
              'power': harness.power_limit(), 'correct': result['correct'],
              'metrics': {k: v['value'] for k, v in result['metrics'].items()},
              'traced_walls_s': walls, 'window_line': window.get('line')}
    for line in err_lines:
        if line.startswith('window:'):
            report['window_line_epochs'] = line[:200]
    try:
        from adorym_tpu_torch.utils import profiling
        reg = profiling.REGISTRY
        first = reg.per_angle()
        report['spans_first'] = first
        report['spans_second'] = reg.per_angle(reg.recent[0]
                                               if reg.recent else None)
    except (ImportError, AttributeError):
        report['spans_first'] = None
    if first := report.get('spans_first'):
        s = first['spans']
        n = first['angles']
        angle = s.get('angle', {}).get('stream_ms')
        report['angle_stream_s'] = None if angle is None else angle * n / 1e3
        parts = [s[k]['stream_ms'] for k in ('rotate', 'rotate_back',
                                             'chunk', 'update') if k in s]
        if angle is not None and None not in parts:
            report['rest_of_angle_ms'] = angle - sum(parts)
    hosted = [s for s in summaries if s is not None]
    if len(hosted) >= 2:
        idle = hosted[1].idle_by_host_op
        report['idle_gaps_s'] = sorted(
            ([k[:120], v / 1e9] for k, v in idle.items()),
            key=lambda kv: -kv[1])[:40]
        report['idle_total_s'] = sum(idle.values()) / 1e9
        report['hosted_window_s'] = hosted[1].window_s
        report['first_busy_s'] = hosted[0].busy_s
        report['first_window_s'] = hosted[0].window_s
    for host_ops, prof in profs:
        if not host_ops:
            report['waits_by_name_first'] = dict(collections.Counter(
                e.name() for e in prof.profiler.kineto_results.events()
                if trace.category(e) in ('cuda_runtime', 'cuda_driver')
                and trace.is_sync(e.name())))
            continue
        try:
            by, synced = _by_span(prof, trace)
        except Exception as e:     # an older profiler's event fields
            report['kernel_by_span_error'] = repr(e)
            continue
        per_span = collections.Counter()
        gathers = collections.Counter()
        for (sp, name), ns in by.items():
            per_span[sp] += ns
            if 'index_elementwise' in name:
                gathers[sp] += ns
        report['device_s_by_span'] = {k: v / 1e9 for k, v in
                                      per_span.most_common()}
        report['gathers_s_by_span'] = {k: v / 1e9 for k, v in
                                       gathers.most_common()}
        report['waits_by_span_second'] = dict(synced)
        report['top_kernels_by_span'] = [
            [sp, name, ns / 1e9] for (sp, name), ns in by.most_common(40)]
    line = json.dumps(report)
    print('SPAN_REPORT ' + line, flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
