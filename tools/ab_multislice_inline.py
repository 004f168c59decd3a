"""Time the delta/beta multislice kernels (K1, K4) with their propagation
matmuls inline or as calls, on one CUDA card.

    python tools/ab_multislice_inline.py

Builds three variants of ``adorym_tpu_torch/csrc/multislice_db_stored.cu``
and ``multislice_db.cu`` from the sources in the checkout, by text
substitution, into ``build/ab_multislice_inline/``:

  shipped     the sources as they are (forward sweep with calls, backward
              sweeps inline);
  fwd_inline  the forward sweep inline too;
  bwd_call    the backward sweeps with calls too;

then times each kernel entry point by CUDA events at the flagship chunk
(S=32 binned steps, 529 patches of 72x72, M=1 and M=3) and at the
multi-mode chunk (S=256, M=3), K1 and K4 on their dense routes, the
variants in turns.  Prints the card's
name and power limit first.
"""

import ctypes
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

CSRC = REPO / 'adorym_tpu_torch' / 'csrc'
OUT = REPO / 'build' / 'ab_multislice_inline'
SOURCES = ('multislice_common.cuh', 'multislice_db_stored.cu',
           'multislice_db.cu')
FWD_CALL = 'propagate<false, true>(w, scr, may, mbx, ny, nx);'
BWD_SUBS = [('propagate(a, scr', 'propagate<false, true>(a, scr'),
            ('propagate(v, scr', 'propagate<false, true>(v, scr'),
            ('propagate<true>(v, scr', 'propagate<true, true>(v, scr')]
VARIANTS = {'shipped': [],
            'fwd_inline': [(FWD_CALL, 'propagate(w, scr, may, mbx, ny, nx);')],
            'bwd_call': BWD_SUBS}
_F, _I, _P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
DENSE = cm.STEP_ROUTES['dense']   # the matmuls this tool times


def build():
    procs = []
    for name, subs in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for src in SOURCES:
            text = (CSRC / src).read_text()
            for old, new in subs:
                text = text.replace(old, new)
            (d / src).write_text(text)
        for src in SOURCES[1:]:
            cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, '-o',
                   str(d / src.replace('.cu', '.so')), str(d / src)]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(log)
    libs = {}
    for name in VARIANTS:
        k1 = ctypes.CDLL(str(OUT / name / 'multislice_db_stored.so'))
        k1.k1_fwd.argtypes = [_I, _I] + [_P] * 8 + [_I] * 5 + [_F, _F, _P, _P]
        k1.k1_bwd.argtypes = ([_I, _I] + [_P] * 9 + [_I] * 5 + [_F] * 3
                              + [_P, _P])
        k4 = ctypes.CDLL(str(OUT / name / 'multislice_db.so'))
        k4.k4_fwd.argtypes = [_I, _I] + [_P] * 7 + [_I] * 5 + [_F, _F, _P, _P]
        k4.k4_bwd.argtypes = ([_I, _I] + [_P] * 11 + [_I] * 5 + [_F] * 3
                              + [_P, _P])
        libs[name] = (k1, k4)
    return libs


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


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


def entry_points(S, M, records, N=529, n=72):
    """The four entry points as closures over one set of operands (f32,
    Fraunhofer far field; the timing does not depend on the values)."""
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    db = torch.rand((S, 2, N, n, n), device=dev, generator=gen) * 1e-4
    wave = torch.randn((M, N, n, n), dtype=torch.complex64, device=dev,
                       generator=gen)
    g = torch.randn_like(wave)
    lmbda = 0.248
    h = prop.fresnel_kernel((n, n), (1., 1., 1.), lmbda, 1.0, device=dev)
    fm = prop.final_prop_mats((n, n), (1., 1., 1.), lmbda, 'inf', device=dev)
    m = cm.prop_mats(h, *fm)
    out = torch.empty_like(wave)
    rec = (torch.empty((S, M, N, n, n, 2), device=dev) if records
           else torch.empty(1, device=dev))
    gdb, gw = torch.empty_like(db), torch.empty_like(wave)
    k1 = 2 * np.pi / lmbda
    st = torch.cuda.current_stream().cuda_stream
    shape = (S, M, N, n, n, -k1, -k1)
    return {
        'K1f': lambda k1lib, _: k1lib.k1_fwd(
            0, DENSE, ptr(db), ptr(wave), ptr(m['fwd_y']), ptr(m['fwd_x']),
            ptr(m['ffwd_y']), ptr(m['ffwd_x']), ptr(out), ptr(rec), *shape,
            None, st),
        'K1b': lambda k1lib, _: k1lib.k1_bwd(
            0, DENSE, ptr(db), ptr(rec), ptr(g), ptr(m['bwd_y']),
            ptr(m['bwd_x']),
            ptr(m['fbwd_y']), ptr(m['fbwd_x']), ptr(gdb), ptr(gw), *shape,
            k1, None, st),
        'K4f': lambda _, k4lib: k4lib.k4_fwd(
            0, DENSE, ptr(db), ptr(wave), ptr(m['fwd_y']), ptr(m['fwd_x']),
            ptr(m['ffwd_y']), ptr(m['ffwd_x']), ptr(out), *shape, None, st),
        'K4b': lambda _, k4lib: k4lib.k4_bwd(
            0, DENSE, ptr(db), ptr(out), ptr(g), ptr(m['bwd_y']), ptr(m['bwd_x']),
            ptr(m['fbwd_y']), ptr(m['fbwd_x']), ptr(m['finv_y']),
            ptr(m['finv_x']), ptr(gdb), ptr(gw), *shape, k1, None, st),
    }


def main():
    if not torch.cuda.is_available():
        print('ab_multislice_inline: no CUDA device', file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    libs = build()
    names = list(VARIANTS)
    cases = [((32, 1, True), ('K1f', 'K1b'), 10),
             ((32, 3, True), ('K1f', 'K1b'), 5),
             ((256, 3, False), ('K4f', 'K4b'), 2)]
    for (S, M, records), kernels, reps in cases:
        eps = entry_points(S, M, records)
        for order in (names, names[::-1]):
            for name in order:
                times = ' '.join(
                    f'{k} {time_ms(lambda: eps[k](*libs[name]), reps):.4f} ms'
                    for k in kernels)
                print(f'S={S} M={M} {name}: {times}', flush=True)
        del eps
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
