"""Split K6's call into host and device time at the four row shapes its
paths give it, beside K2's kernel at ``rows=1``, ``F.fold`` and the plain
version, on one CUDA card.

    python tools/probe_k6.py [--reps 200] [--only k2]

Shapes (one grid row of 23 patches of 72^2 at stride 8 into a band
accumulator [72, 260, *tr]):
  zmajor-f32 / zmajor-bf16: the immediate flagship's z-major gradient
    [32, 2, 23, 72, 72] read in place (delta_beta);
  real_imag: patch-major [23, 72, 72, 256, 2] f32 (the real_imag band
    step, whose band is not binned in z);
  8e: patch-major [23, 72, 72, 2, 2] f32 (sparse slices).

Routes: ``k6``, ``scatter_rowgrid_add_kernel`` (what the band step calls)
and ``k6-scalar``, its scalar instantiation;
``k2``, ``scatter_grid2d_add(acc, cot, 0, 0, 8, 1)`` (K2's kernel and
wrapper for one row, K6's route before it had a kernel of its own) and
``k2-scalar``, its scalar instantiation; ``fold``, ``F.fold`` of the row on
a pre-permuted f32 input (a yardstick the port never calls); ``plain``,
``scatter_rowgrid_add``.  For each: ``host_us``, the wall per call over a
loop of ``--reps`` calls with no synchronisation; ``call_ms``, CUDA events
around such a loop over the count (chip_smoke's ``ms``); ``device_ms``,
the device time a call from torch.profiler (every kernel and memset the
call runs); ``graph_ms``, CUDA events around the replay of a CUDA graph
that captured ``--reps`` calls, over the count.  ``--only k2`` leaves
out K6's routes.  Prints the card's name and power limit first and one JSON
line a shape.  ``--host-parts`` instead splits K6's call at sparse slices'
row into its parts' host time (:func:`host_parts`).
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from adorym_tpu_torch.ops import cuda_scatter_grid as csg  # noqa: E402

#: The card's peak memory rate (bytes/s), as chip_smoke's bound.
PEAK_BYTES_PER_S = 3.35e12
SHAPES = ('zmajor-f32', 'zmajor-bf16', 'real_imag', '8e')


def operands(shape, seed=17):
    """(acc, cot, trailing channels) of one row shape on the card."""
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    cols, n = 23, 72
    if shape.startswith('zmajor'):
        dtype = torch.bfloat16 if shape.endswith('bf16') else torch.float32
        cot = torch.randn((32, 2, cols, n, n), device=dev,
                          generator=gen).to(dtype).permute(2, 3, 4, 0, 1)
        tr = (32, 2)
    else:
        tr = (256, 2) if shape == 'real_imag' else (2, 2)
        cot = torch.randn((cols, n, n) + tr, device=dev, generator=gen)
    acc = torch.randn((n, 260) + tr, device=dev, generator=gen)
    return acc, cot, tr


def fold_input(cot):
    """The row as ``F.fold``'s input, channels first, f32."""
    cols, n = cot.shape[0], cot.shape[1]
    c = cot.float().reshape(cols, n * n, -1).permute(2, 1, 0)
    return c.reshape(1, -1, cols).contiguous()


def host_us(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def call_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Device time a call (every CUDA kernel and memory operation) and
    device operations a call, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if str(getattr(e, 'device_type', '')).endswith('CUDA')]
    return (sum(e.self_device_time_total for e in evs) / 1e3 / reps,
            sum(e.count for e in evs) / reps,
            sorted({e.key[:60] for e in evs}))


def graph_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def probe(shape, reps, routes):
    acc0, cot, tr = operands(shape)
    n = cot.shape[1]
    tx = (cot.shape[0] - 1) * 8 + n
    fin = fold_input(cot)
    fns = {
        'k6': lambda acc: csg.scatter_rowgrid_add_kernel(acc, cot, 0, 0, 8),
        'k2': lambda acc: csg.scatter_grid2d_add(acc, cot, 0, 0, 8, 1),
        'k6-scalar': lambda acc: csg._launch_rowgrid(acc, cot, 0, 0, 8,
                                                     vec=1),
        'k2-scalar': lambda acc: csg._launch_scatter(acc, cot, 0, 0, 8, 1,
                                                     vec=1),
        'fold': lambda acc: torch.nn.functional.fold(
            fin, (n, tx), (n, n), stride=8),
        'plain': lambda acc: csg.scatter_rowgrid_add(acc, cot, 0, 0, 8),
    }
    ref = csg.scatter_rowgrid_add(acc0.clone(), cot, 0, 0, 8)
    out = {'shape': shape, 'cot': list(cot.shape), 'dtype': str(cot.dtype),
           'bound_ms': csg.bytes_moved(cot.shape, 8, 1, cot.element_size())
           / PEAK_BYTES_PER_S * 1e3}
    for name in routes:
        fn = fns[name]
        acc = acc0.clone()
        rec = {}
        if name not in ('fold', 'plain'):
            got = fn(acc0.clone())
            torch.cuda.synchronize()
            rec['max_abs_err'] = float((got - ref).abs().max())
            if name != 'k6' and 'k6' in routes:
                rec['equal_k6'] = bool(torch.equal(got, fns['k6'](
                    acc0.clone())))
        r = reps if name != 'plain' else max(reps // 10, 5)
        rec['host_us'] = host_us(lambda: fn(acc), r)
        rec['call_ms'] = call_ms(lambda: fn(acc), r)
        rec['device_ms'], rec['device_ops'], rec['kernels'] = device_ms(
            lambda: fn(acc), r)
        if name != 'plain':
            try:
                rec['graph_ms'] = graph_ms(lambda: fn(acc), r)
            except Exception as e:  # a route that cannot be captured
                rec['graph_ms'] = f'not captured: {type(e).__name__}: {e}'
        out[name] = rec
        torch.cuda.synchronize()
    return out


def host_parts(reps=2000, loops=5):
    """Host microseconds a call of each part of K6's call at sparse slices'
    row (the median of ``loops`` loops of ``reps`` calls, no sync): the
    plan's lookup, the stream (PyTorch's raw accessor and the public
    Stream object), the C entry point alone with its arguments ready,
    the whole wrapper, and ``F.fold`` for comparison."""
    from adorym_tpu_torch.utils import cuda_build
    acc, cot, _ = operands('8e')
    n, tx = cot.shape[1], (cot.shape[0] - 1) * 8 + cot.shape[1]
    fin = fold_input(cot)
    plan = csg.rowgrid_plan(acc, cot, 8)
    fn = csg.K6.function()
    pc, pa = cot.data_ptr(), acc.data_ptr()
    st = cuda_build.stream_ptr(0)
    parts = {
        'plan lookup': lambda: csg.rowgrid_plan(acc, cot, 8),
        'raw stream': lambda: cuda_build.stream_ptr(0),
        'public stream': lambda: torch.cuda.current_stream().cuda_stream,
        'C entry alone': lambda: fn(plan.kind, pc, pa, plan.row_ptr, 0, 0,
                                    st),
        'wrapper': lambda: csg.scatter_rowgrid_add_kernel(acc, cot, 0, 0, 8),
        'F.fold': lambda: torch.nn.functional.fold(fin, (n, tx), (n, n),
                                                   stride=8),
    }
    out = {}
    for name, f in parts.items():
        times = []
        for _ in range(loops):
            f()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                f()
            times.append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
        out[name] = sorted(times)[loops // 2]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--reps', type=int, default=200)
    ap.add_argument('--only', default=None)
    ap.add_argument('--host-parts', action='store_true')
    args = ap.parse_args()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda}',
          flush=True)
    routes = ['k6', 'k6-scalar', 'k2', 'k2-scalar', 'fold', 'plain']
    if args.only == 'k2':
        routes = routes[2:]
    if args.host_parts:
        print(json.dumps({'host_us': host_parts()}), flush=True)
        return 0
    for shape in SHAPES:
        print(json.dumps(probe(shape, args.reps, routes)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
