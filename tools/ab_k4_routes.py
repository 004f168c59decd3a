"""Time the delta/beta multislice kernels K4 (``adorym_tpu_torch/csrc/
multislice_db.cu``) and K1 (``multislice_db_stored.cu``) on their FFT and
dense step routes, for one or more copies of the kernel sources, on one
CUDA card.

    python tools/ab_k4_routes.py [CSRC_DIR ...] [--sass k1,k4,k5 PARENT_CSRC]
                                 [--kernels k4,k1]

Each ``CSRC_DIR`` holds a copy of ``adorym_tpu_torch/csrc`` (default: the
checkout's own); each is built with nvcc into ``build/ab_k4_routes/`` (its
registers and spills printed), and its entry points are timed by CUDA
events on the FFT route, beside the first copy's dense route, in turns
(forward order, then reversed), f32 with the Fraunhofer far field:

  k4  ``k4_fwd``/``k4_bwd`` at the launch shape of the benchmark cell
      ``cone256_mm.per_angle`` (S=256 steps, M=5 modes, N=460 patches of
      72x72: each of an angle's two gradient chunks of 20 grid rows, the
      second padded to 20 from 3 rows, i.e. N=69), at N=69, and at the
      multi-mode flagship chunk (M=3, N=529), with each copy's resident
      blocks an SM on the FFT route;
  k1  ``k1_fwd``/``k1_bwd`` at the delta_beta flagship chunk (S=32, M=1)
      with N=529 and N=528 patches (529 blocks are 4 full rounds of 132
      SMs and one block more), and at M=3 (the binned multi-mode chunk).

Every version's FFT-route outputs are held against the first version's
dense route.  With ``--sass``, the SASS of each named kernel's source built
from the checkout is compared, function by function, with the one built
from ``PARENT_CSRC`` (k5: ``multislice_fused.cu``); ``--kernels ''`` then
skips the timing.  Prints the card's name, power limit and SM clock first.

Resident blocks an SM come from the copy's ``k4_blocks_per_sm`` entry
point; a copy without one prints none.
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
SOURCES = {'k4': 'multislice_db.cu', 'k1': 'multislice_db_stored.cu'}
SASS_SOURCES = dict(SOURCES, k5='multislice_fused.cu')
#: The entry points' signatures since the global route (a workspace
#: pointer before the stream; copies of ``csrc`` from before it lack it).
ARGTYPES = {
    'k4_fwd': [_I, _I] + [_P] * 7 + [_I] * 5 + [_F, _F, _P, _P],
    'k4_bwd': [_I, _I] + [_P] * 11 + [_I] * 5 + [_F] * 3 + [_P, _P],
    'k1_fwd': [_I, _I] + [_P] * 8 + [_I] * 5 + [_F, _F, _P, _P],
    'k1_bwd': [_I, _I] + [_P] * 9 + [_I] * 5 + [_F] * 3 + [_P, _P],
}


def nvcc(src, out, *extra):
    cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS[:-3], *extra, '-o',
           str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(dirs, kernels):
    """One library per (copy, kernel), all nvcc processes at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {(i, k): nvcc(Path(d) / SOURCES[k], OUT / f'{k}_{i}.so',
                          '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
             for i, d in enumerate(dirs) for k in kernels}
    libs = {}
    for (i, k), p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(log)
        for fn, stack, spill, regs in re.findall(
                r"entry function '(\w+)'.*?(\d+) bytes stack frame, (\d+) "
                r"bytes spill stores.*?Used (\d+) registers", log, re.S):
            print(f'{dirs[i]}: {k} {demangle(fn)}: {regs} registers, '
                  f'{stack} bytes stack, {spill} bytes spilled', flush=True)
        lib = ctypes.CDLL(str(OUT / f'{k}_{i}.so'))
        for sym in (f'{k}_fwd', f'{k}_bwd'):
            getattr(lib, sym).argtypes = ARGTYPES[sym]
        libs[(i, k)] = lib
    return libs


def demangle(name):
    """The kernel's name and template arguments, without its parameters
    and the anonymous namespace's hash."""
    filt = Path(cuda_build.nvcc()).parent / 'cu++filt'
    try:
        name = subprocess.run([str(filt), name], capture_output=True,
                              text=True, timeout=60).stdout.strip() or name
    except OSError:
        return name
    return re.sub(r'\(.*$', '', name.replace('(anonymous namespace)::', ''))


def sass(cubin):
    """Function -> SASS lines, the function names without the anonymous
    namespace's hash, the lines without their address (whose width, and so
    the lines' padding, follows the cubin's size)."""
    text = subprocess.run([str(Path(cuda_build.nvcc()).parent / 'cuobjdump'),
                           '-sass', str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            cur = re.sub(r'_GLOBAL__N__\w+?_\d+_', '', m.group(1))
            funcs[cur] = []
        elif cur and '/*' in line:
            funcs[cur].append(' '.join(
                re.sub(r'/\*[0-9a-f]{4,}\*/', '', line).split()))
    return funcs


def compare_sass(kernel, parent):
    """Prints, for each function of ``kernel``'s source, whether its SASS
    built from the checkout equals the one built from ``parent``."""
    cubins = {}
    procs = []
    for tag, d in (('parent', Path(parent)), ('this', cuda_build.CSRC)):
        cubins[tag] = OUT / f'{kernel}_{tag}.cubin'
        procs.append(nvcc(d / SASS_SOURCES[kernel], cubins[tag],
                          '-cubin'))
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(log)
    old, new = sass(cubins['parent']), sass(cubins['this'])
    for name in sorted(set(old) | set(new)):
        same = old.get(name) == new.get(name)
        print(f'{kernel.upper()} SASS {name[:70]}: '
              f"{'identical' if same else 'DIFFERS'} "
              f'({len(old.get(name, []))} / {len(new.get(name, []))} lines)',
              flush=True)


def blocks_per_sm(libs, dirs, modes=(1, 3, 5)):
    """Prints each copy's resident K4f and K4b blocks an SM on the FFT
    route at 72x72, f32."""
    for i, d in enumerate(dirs):
        lib = libs.get((i, 'k4'))
        if lib is None:
            continue
        if not hasattr(lib, 'k4_blocks_per_sm'):
            print(f'{d}: no k4_blocks_per_sm entry point', flush=True)
            continue
        fn = lib.k4_blocks_per_sm
        fn.argtypes = [_I] * 6 + [ctypes.POINTER(_F)]
        got = {}
        for bwd in (0, 1):
            for m in modes:
                out = _F()
                assert fn(bwd, 0, cm.STEP_ROUTES['fft'], m, 72, 72,
                          ctypes.byref(out)) == 0
                got[f"{'K4b' if bwd else 'K4f'} M={m}"] = round(out.value, 4)
        print(f'{d}: K4 resident blocks an SM (fft, 72x72, f32) {got}',
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


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def operands(S, M, N, n=72, records=False):
    """Physical absorption (the multi-mode chunk's), a 1 nm step at 5 keV
    (8 binned steps at S=32), the Fraunhofer far field and its inverse."""
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(5)
    db = torch.empty((S, 2, N, n, n), device=dev)
    db[:, 0].uniform_(0, 1e-3, generator=gen)
    db[:, 1].uniform_(0, 1e-4, generator=gen)
    wave = torch.randn((M, N, n, n), dtype=torch.complex64, device=dev,
                       generator=gen)
    g = torch.randn_like(wave)
    lmbda = 1240.0 / 5000.0
    h = prop.fresnel_kernel((n, n), (1., 1., 1.), lmbda, 256.0 / S,
                            device=dev)
    fm = prop.final_prop_mats((n, n), (1., 1., 1.), lmbda, 'inf', device=dev)
    mats = {r: cm.prop_mats(h, *fm, route=r) for r in cm.STEP_ROUTES}
    rec = (torch.empty((S, M, N, n, n, 2), device=dev) if records else None)
    return db, wave, g, mats, rec, 2 * np.pi / lmbda


def entries(lib, kernel, route, ops, outs):
    """The forward and backward entry points of ``kernel`` on ``route``
    as closures; their outputs go to ``outs``."""
    db, wave, g, mats, rec, k1 = ops
    m, code = mats[route], cm.STEP_ROUTES[route]
    S, _, N, n, _ = db.shape
    shape = (S, wave.shape[0], N, n, n, -k1, -k1)
    out = torch.empty_like(wave)
    gdb, gw = torch.empty_like(db), torch.empty_like(wave)
    outs.append((out, gdb, gw))
    st = torch.cuda.current_stream().cuda_stream
    if kernel == 'k4':
        def fwd():
            assert lib.k4_fwd(0, code, ptr(db), ptr(wave), ptr(m['fwd_y']),
                              ptr(m['fwd_x']), ptr(m['ffwd_y']),
                              ptr(m['ffwd_x']), ptr(out), *shape, None,
                              st) == 0

        def bwd():
            assert lib.k4_bwd(0, code, ptr(db), ptr(out), ptr(g),
                              ptr(m['bwd_y']), ptr(m['bwd_x']),
                              ptr(m['fbwd_y']), ptr(m['fbwd_x']),
                              ptr(m['finv_y']), ptr(m['finv_x']), ptr(gdb),
                              ptr(gw), *shape, k1, None, st) == 0
    else:
        def fwd():
            assert lib.k1_fwd(0, code, ptr(db), ptr(wave), ptr(m['fwd_y']),
                              ptr(m['fwd_x']), ptr(m['ffwd_y']),
                              ptr(m['ffwd_x']), ptr(out), ptr(rec), *shape,
                              None, st) == 0

        def bwd():
            assert lib.k1_bwd(0, code, ptr(db), ptr(rec), ptr(g),
                              ptr(m['bwd_y']), ptr(m['bwd_x']),
                              ptr(m['fbwd_y']), ptr(m['fbwd_x']), ptr(gdb),
                              ptr(gw), *shape, k1, None, st) == 0
    return fwd, bwd


def rel(a, b):
    a = torch.view_as_real(a) if a.is_complex() else a
    b = torch.view_as_real(b) if b.is_complex() else b
    return float((a - b).abs().max() / b.abs().max())


#: (kernel, S, M, N, repetitions) of each timed case.
CASES = {'k4': [('k4', 256, 5, 460, 3), ('k4', 256, 5, 69, 3),
                ('k4', 256, 3, 529, 3)],
         'k1': [('k1', 32, 1, 529, 10), ('k1', 32, 1, 528, 10),
                ('k1', 32, 3, 529, 5)]}


def run_case(libs, dirs, kernel, S, M, N, reps):
    ops = operands(S, M, N, records=kernel == 'k1')
    runs = [(0, 'dense')] + [(i, 'fft') for i in range(len(dirs))]
    eps, outs = {}, []
    for i, r in runs:
        eps[(i, r)] = entries(libs[(i, kernel)], kernel, r, ops, outs)
    results = dict(zip(runs, outs))
    for fwd, bwd in eps.values():
        fwd()
        bwd()
    torch.cuda.synchronize()
    ref = results[(0, 'dense')]
    tag = f'{kernel.upper()} S={S} M={M} N={N}'
    for i in range(len(dirs)):
        errs = [rel(a, b) for a, b in zip(results[(i, 'fft')], ref)]
        print(f'{dirs[i]} {tag}: fft route against the first dense route: '
              f'out {errs[0]:.2e} gdb {errs[1]:.2e} gw {errs[2]:.2e}',
              flush=True)
    for order in (runs, runs[::-1]):
        for i, route in order:
            fwd, bwd = eps[(i, route)]
            print(f'{dirs[i]} {tag} {route}: {kernel.upper()}f '
                  f'{time_ms(fwd, reps):.3f} ms {kernel.upper()}b '
                  f'{time_ms(bwd, reps):.3f} ms', flush=True)
    del ops, eps, outs, results
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('dirs', nargs='*', default=[str(cuda_build.CSRC)])
    ap.add_argument('--sass', nargs=2, metavar=('KERNELS', 'PARENT_CSRC'),
                    default=None)
    ap.add_argument('--kernels', default='k4,k1')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('ab_k4_routes: no CUDA device', file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit,'
                          'clocks.sm,clocks.max.sm', '--format=csv,noheader'],
                         capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    kernels = [k for k in args.kernels.split(',') if k]
    libs = build(args.dirs, kernels)
    if args.sass:
        for kernel in args.sass[0].split(','):
            compare_sass(kernel, args.sass[1])
    if 'k4' in kernels:
        blocks_per_sm(libs, args.dirs)
    for k in kernels:
        for case in CASES[k]:
            run_case(libs, args.dirs, *case)
    return 0


if __name__ == '__main__':
    sys.exit(main())
