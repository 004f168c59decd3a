"""Time K4 (``adorym_tpu_torch/csrc/multislice_db.cu``) on its FFT and
dense step routes, for one or more copies of the kernel sources, on one
CUDA card.

    python tools/ab_k4_routes.py [CSRC_DIR ...] [--k1-sass PARENT_CSRC]

Each ``CSRC_DIR`` holds a copy of ``adorym_tpu_torch/csrc`` (default: the
checkout's own); each is built with nvcc into ``build/ab_k4_routes/`` (its
registers and spills printed), and its entry points ``k4_fwd``/``k4_bwd``
are timed by CUDA events at the multi-mode flagship chunk (S=256 steps,
M=3 modes, N=529 patches of 72x72, Fraunhofer far field, f32), on both
routes, the sources in turns (forward order, then reversed).  Every
version's FFT-route output is held against the first version's dense
route.  With ``--k1-sass``, the SASS of K1 (``multislice_db_stored.cu``)
built from the checkout is compared, function by function, with the one
built from ``PARENT_CSRC``.  Prints the card's name and power limit first.
"""

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from adorym_tpu_torch.ops import cuda_multislice as cm  # noqa: E402
from adorym_tpu_torch.ops import propagate as prop  # noqa: E402
from adorym_tpu_torch.utils import cuda_build  # noqa: E402

OUT = REPO / 'build' / 'ab_k4_routes'
_F, _I, _P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p


def nvcc(src, out, *extra):
    cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS[:-3], *extra, '-o',
           str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(dirs):
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {d: nvcc(Path(d) / 'multislice_db.cu', OUT / f'k4_{i}.so',
                     '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
             for i, d in enumerate(dirs)}
    libs = []
    for i, (d, p) in enumerate(procs.items()):
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(log)
        for fn, regs in re.findall(r"entry function '(\w+)'.*?Used (\d+) "
                                   r"registers", log, re.S):
            kind = 'fwd' if 'fwd_kernel' in fn else 'bwd'
            print(f'{d}: {kind} {fn[-40:]} {regs} registers', flush=True)
        print(f'{d}: spills', sorted(set(re.findall(
            r'(\d+) bytes spill stores', log))), flush=True)
        lib = ctypes.CDLL(str(OUT / f'k4_{i}.so'))
        lib.k4_fwd.argtypes = [_I, _I] + [_P] * 7 + [_I] * 5 + [_F, _F, _P]
        lib.k4_bwd.argtypes = [_I, _I] + [_P] * 11 + [_I] * 5 + [_F] * 3 + [_P]
        libs.append(lib)
    return libs


def sass(cubin):
    """Function -> SASS lines, the function names read as the template
    arguments K1 instantiates (with or without a trailing false flag) and
    without the anonymous namespace's hash."""
    text = subprocess.run([str(Path(cuda_build.nvcc()).parent / 'cuobjdump'),
                           '-sass', str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            cur = re.sub(r'_GLOBAL__N__\w+?_\d+_', '', m.group(1))
            cur = cur.replace('Lb1ELb0EEE', 'Lb1EEE')
            funcs[cur] = []
        elif cur and '/*' in line:
            funcs[cur].append(re.sub(r'/\*[0-9a-f]{4}\*/', '', line).strip())
    return funcs


def k1_sass(parent):
    cubins = {}
    procs = []
    for tag, d in (('parent', Path(parent)), ('this', cuda_build.CSRC)):
        cubins[tag] = OUT / f'k1_{tag}.cubin'
        procs.append(nvcc(d / 'multislice_db_stored.cu', cubins[tag],
                          '-cubin'))
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(log)
    old, new = sass(cubins['parent']), sass(cubins['this'])
    for name in sorted(set(old) | set(new)):
        same = old.get(name) == new.get(name)
        print(f'K1 SASS {name[:70]}: '
              f"{'identical' if same else 'DIFFERS'} "
              f'({len(old.get(name, []))} / {len(new.get(name, []))} lines)',
              flush=True)


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('dirs', nargs='*', default=[str(cuda_build.CSRC)])
    ap.add_argument('--k1-sass', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('ab_k4_routes: no CUDA device', file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    libs = build(args.dirs)
    if args.k1_sass:
        k1_sass(args.k1_sass)
    S, M, N, n = 256, 3, 529, 72
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(5)
    db = torch.empty((S, 2, N, n, n), device=dev)
    db[:, 0].uniform_(0, 1e-3, generator=gen)
    db[:, 1].uniform_(0, 1e-4, generator=gen)
    wave = torch.randn((M, N, n, n), dtype=torch.complex64, device=dev,
                       generator=gen)
    g = torch.randn_like(wave)
    lmbda = 1240.0 / 5000.0
    k1 = 2 * np.pi / lmbda
    h = prop.fresnel_kernel((n, n), (1., 1., 1.), lmbda, 1.0, device=dev)
    fm = prop.final_prop_mats((n, n), (1., 1., 1.), lmbda, 'inf', device=dev)
    mats = {r: cm.prop_mats(h, *fm, route=r) for r in cm.K4_ROUTES}
    outs = {}
    st = torch.cuda.current_stream().cuda_stream
    shape = (S, M, N, n, n, -k1, -k1)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def entry(lib, route):
        m, code = mats[route], cm.K4_ROUTES[route]
        out = torch.empty_like(wave)
        gdb, gw = torch.empty_like(db), torch.empty_like(wave)
        outs[(lib, route)] = (out, gdb, gw)

        def fwd():
            assert lib.k4_fwd(0, code, ptr(db), ptr(wave), ptr(m['fwd_y']),
                              ptr(m['fwd_x']), ptr(m['ffwd_y']),
                              ptr(m['ffwd_x']), ptr(out), *shape, st) == 0

        def bwd():
            assert lib.k4_bwd(0, code, ptr(db), ptr(out), ptr(g),
                              ptr(m['bwd_y']), ptr(m['bwd_x']),
                              ptr(m['fbwd_y']), ptr(m['fbwd_x']),
                              ptr(m['finv_y']), ptr(m['finv_x']), ptr(gdb),
                              ptr(gw), *shape, k1, st) == 0
        return fwd, bwd

    runs = [(i, r) for i in range(len(libs)) for r in ('fft', 'dense')]
    eps = {key: entry(libs[key[0]], key[1]) for key in runs}
    for fwd, bwd in eps.values():
        fwd()
        bwd()
    torch.cuda.synchronize()
    ref = outs[(libs[0], 'dense')]
    for i, lib in enumerate(libs):
        got = outs[(lib, 'fft')]
        errs = [float((torch.view_as_real(a) if a.is_complex() else a).sub(
            torch.view_as_real(b) if b.is_complex() else b).abs().max()
            / (torch.view_as_real(b) if b.is_complex() else b).abs().max())
            for a, b in zip(got, ref)]
        print(f'{args.dirs[i]}: fft route against the first dense route: '
              f'out {errs[0]:.2e} gdb {errs[1]:.2e} gw {errs[2]:.2e}',
              flush=True)
    for order in (runs, runs[::-1]):
        for i, route in order:
            fwd, bwd = eps[(i, route)]
            print(f'{args.dirs[i]} {route}: K4f '
                  f'{time_ms(fwd, 3):.3f} ms K4b '
                  f'{time_ms(bwd, 3):.3f} ms', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
