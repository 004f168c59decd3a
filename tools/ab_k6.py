"""Time K6, one grid row's scatter (``adorym_tpu_torch/csrc/
rowgrid_scatter.cu``), of two or more copies of the kernel sources, in
turns, on one CUDA card, and check that their outputs are equal bit for
bit.

    python tools/ab_k6.py CSRC_DIR [CSRC_DIR ...] [--reps 100]

Each ``CSRC_DIR`` holds a copy of ``adorym_tpu_torch/csrc``; each copy's
``rowgrid_scatter.cu`` is built with nvcc into ``build/ab_k6/``
(registers and spills printed) and called through the C entry point
``k6_rowgrid_scatter_add`` with the instantiation and geometry that the
package's plan (``cuda_scatter_grid.rowgrid_plan``) gives the operands.
At K6's four row shapes (tools/probe_k6.py's: the immediate flagship's
z-major row in f32 and bf16, the real_imag band row, sparse slices' row),
every copy adds the same cotangents into a copy of the same accumulator
and the results are compared with the first copy's; then each copy's
device time a launch (torch.profiler, over ``--reps`` launches) is taken,
the copies in turns (forward order, then reversed), beside the bound
(``bytes_moved`` at 3.35 TB/s).  Prints the card's name and power limit
first.
"""

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / 'tools'))
from adorym_tpu_torch.ops import cuda_scatter_grid as csg  # noqa: E402
from adorym_tpu_torch.utils import cuda_build  # noqa: E402
from probe_k6 import (PEAK_BYTES_PER_S, SHAPES, device_ms,  # noqa: E402
                      operands)

OUT = REPO / 'build' / 'ab_k6'
_I, _P = ctypes.c_int, ctypes.c_void_p


def build(dirs):
    """One library per copy, all nvcc processes at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, d in enumerate(dirs):
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, '-Xptxas', '-v',
               '-o', str(OUT / f'k6_{i}.so'),
               str(Path(d) / 'rowgrid_scatter.cu')]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    fns = []
    for i, (d, p) in enumerate(zip(dirs, procs)):
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(log)
        for fn, regs in re.findall(r"entry function '(\w+)'.*?Used (\d+) "
                                   r"registers", log, re.S):
            print(f'{d}: {fn[-60:]} {regs} registers', flush=True)
        print(f'{d}: spills', sorted(set(re.findall(
            r'(\d+) bytes spill stores', log))), flush=True)
        fn = ctypes.CDLL(str(OUT / f'k6_{i}.so')).k6_rowgrid_scatter_add
        fn.argtypes = [_I, _P, _P, _P, _I, _I, _P]
        fn.restype = _I
        fns.append(fn)
    return fns


def launcher(fn, cot):
    """A closure adding ``cot`` at the origin of a given accumulator with
    this copy's kernel."""
    def run(acc):
        plan = csg.rowgrid_plan(acc, cot, 8)
        err = fn(plan.kind, cot.data_ptr(), acc.data_ptr(), plan.row_ptr, 0,
                 0, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f'launch failed: CUDA error {err}'
        return acc
    return run


def run_shape(fns, dirs, shape, reps):
    acc0, cot, _ = operands(shape)
    runs = [launcher(fn, cot) for fn in fns]
    outs = [run(acc0.clone()) for run in runs]
    torch.cuda.synchronize()
    for d, out in zip(dirs[1:], outs[1:]):
        print(f'{d} {shape}: equal to {dirs[0]} bit for bit: '
              f'{torch.equal(out, outs[0])}', flush=True)
    del outs
    bound = csg.bytes_moved(cot.shape, 8, 1,
                            cot.element_size()) / PEAK_BYTES_PER_S * 1e3
    acc = acc0.clone()
    order = list(range(len(dirs)))
    for turn in (order, order[::-1]):
        for i in turn:
            ms = device_ms(lambda: runs[i](acc), reps)[0]
            print(f'{dirs[i]} {shape}: device {ms:.5f} ms, bound '
                  f'{bound:.5f} ms ({100 * bound / ms:.1f}%)', flush=True)
    del cot, acc, acc0
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('dirs', nargs='+')
    ap.add_argument('--reps', type=int, default=100)
    args = ap.parse_args()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    fns = build(args.dirs)
    for shape in SHAPES:
        run_shape(fns, args.dirs, shape, args.reps)


if __name__ == '__main__':
    main()
