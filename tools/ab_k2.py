"""Time the complete-grid scatter K2 (``adorym_tpu_torch/csrc/
grid_scatter.cu``) of two or more copies of the kernel sources, in turns,
on one CUDA card, and check that their outputs are equal bit for bit.

    python tools/ab_k2.py CSRC_DIR [CSRC_DIR ...] [--reps 10]

Each ``CSRC_DIR`` holds a copy of ``adorym_tpu_torch/csrc``; each copy's
``grid_scatter.cu`` is built with nvcc into ``build/ab_k2/`` (registers
and spills printed).  A copy whose entry point takes no ``vec`` argument
(before K2's vector instantiation) is called with its own signature; the
others with the instantiation ``cuda_scatter_grid.vector_width`` picks.
At the three flagship shapes (529 patches of 72x72 on a 23x23 grid at
stride 8 into the padded accumulator [260, 260, C/2, 2]):

  delta_beta  C = 64,  the z-major gradient read in place;
  real_imag   C = 512, patch-major;
  multimode   C = 512, the z-major gradient read in place;

in f32 and bf16, every copy adds the same cotangents into a copy of the
same accumulator and the results are compared with the first copy's; then
each copy is timed by CUDA events, the copies in turns (forward order, then
reversed), with the time over the bytes bound (``bytes_moved`` at
3.35 TB/s).  Prints the card's name and power limit first.
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
from adorym_tpu_torch.ops import cuda_scatter_grid as csg  # noqa: E402
from adorym_tpu_torch.utils import cuda_build  # noqa: E402

OUT = REPO / 'build' / 'ab_k2'
PEAK_BYTES_PER_S = 3.35e12
_I, _P = ctypes.c_int, ctypes.c_void_p
#: (name, channels, z-major) of each flagship shape.
SHAPES = (('delta_beta', 64, True), ('real_imag', 512, False),
          ('multimode', 512, True))


def build(dirs):
    """One library per copy, all nvcc processes at once; returns (library,
    whether its entry point takes ``vec``) per copy."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, d in enumerate(dirs):
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, '-Xptxas', '-v',
               '-o', str(OUT / f'k2_{i}.so'), str(Path(d) / 'grid_scatter.cu')]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    libs = []
    for i, (d, p) in enumerate(zip(dirs, procs)):
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(log)
        for fn, regs in re.findall(r"entry function '(\w+)'.*?Used (\d+) "
                                   r"registers", log, re.S):
            print(f'{d}: {fn[-60:]} {regs} registers', flush=True)
        print(f'{d}: spills', sorted(set(re.findall(
            r'(\d+) bytes spill stores', log))), flush=True)
        src = (Path(d) / 'grid_scatter.cu').read_text()
        params = re.search(r'k2_grid_scatter_add\(([^)]*)\)', src).group(1)
        with_vec = 'int vec' in params
        lib = ctypes.CDLL(str(OUT / f'k2_{i}.so'))
        lib.k2_grid_scatter_add.argtypes = (
            [_I, _I] + ([_I] if with_vec else []) + [_P, _P] + [_I] * 9
            + [_P])
        libs.append((lib, with_vec))
    return libs


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launcher(lib, with_vec, cot, cm, rows=23, s=8):
    """A closure adding ``cot`` into a given accumulator with this copy's
    kernel."""
    n, py, px = cot.shape[:3]
    C = cot.shape[3] * cot.shape[4]
    dtype = 0 if cot.dtype == torch.float32 else 1

    def run(acc):
        vec = ([csg.vector_width(
            cot.element_size(), C, s, cm, cot.data_ptr(), acc.data_ptr(),
            smem_bytes=csg.bulk_copy_smem_bytes(cot.element_size(),
                                                n // rows, px, s))]
               if with_vec else [])
        err = lib.k2_grid_scatter_add(
            dtype, int(cm), *vec, _P(cot.data_ptr()), _P(acc.data_ptr()),
            rows, n // rows, py, px, C, s, acc.shape[1], 0, 0,
            _P(torch.cuda.current_stream().cuda_stream))
        assert err == 0, f'launch failed: CUDA error {err}'
        return acc
    return run


def run_shape(libs, dirs, name, C, zmajor, dtype, reps):
    dev = torch.device('cuda')
    rows, n, zb = 23, 72, C // 2
    gen = torch.Generator(device=dev).manual_seed(C + zmajor)
    if zmajor:
        cot = torch.randn((zb, 2, rows * rows, n, n), device=dev,
                          generator=gen).to(dtype).permute(2, 3, 4, 0, 1)
    else:
        cot = torch.randn((rows * rows, n, n, zb, 2), device=dev,
                          generator=gen).to(dtype)
    acc0 = torch.randn((260, 260, zb, 2), device=dev, generator=gen)
    runs = [launcher(lib, v, cot, zmajor) for lib, v in libs]
    outs = [run(acc0.clone()) for run in runs]
    torch.cuda.synchronize()
    tag = f"{name} C={C} {'z-major' if zmajor else 'patch-major'} " \
          f"{str(dtype).split('.')[-1]}"
    for d, out in zip(dirs[1:], outs[1:]):
        print(f'{d} {tag}: equal to {dirs[0]} bit for bit: '
              f'{torch.equal(out, outs[0])}', flush=True)
    del outs
    bound = csg.bytes_moved(cot.shape, 8, rows,
                            cot.element_size()) / PEAK_BYTES_PER_S * 1e3
    acc = acc0.clone()
    order = list(range(len(dirs)))
    for turn in (order, order[::-1]):
        for i in turn:
            ms = time_ms(lambda: runs[i](acc), reps)
            print(f'{dirs[i]} {tag}: {ms:.4f} ms, bound {bound:.4f} ms '
                  f'({100 * bound / ms:.1f}%)', flush=True)
    del cot, acc, acc0
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('dirs', nargs='+')
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(args.dirs)
    for dtype in (torch.float32, torch.bfloat16):
        for name, C, zmajor in SHAPES:
            run_shape(libs, args.dirs, name, C, zmajor, dtype, args.reps)


if __name__ == '__main__':
    main()
