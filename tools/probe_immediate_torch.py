"""Probe the immediate flagship's device work on one CUDA card: K1 across
launch sizes, and the band's exact backward in its two forms.

    python tools/probe_immediate_torch.py [--reps 10]

1. K1 (``csrc/multislice_db_stored.cu``) forward and backward on its FFT
   route at 32 binned steps of 72x72 with the far field, one probe mode,
   for N = 23 (one grid row, the immediate path's launch), 46, 132, 264
   and 529 (a whole angle, the per-angle path's) patches, f32 and bf16:
   the time by CUDA events over ``--reps`` back-to-back launches (the
   launch alone, the step vectors built once) and the kernel's own device
   time from torch.profiler.
2. The band's exact backward at the immediate flagship (a [72, 256, 32, 2]
   binned band accumulator to [72, 256, 256, 2], theta = 0.7): the 9-tap
   gather (``ops.rotate.rotate_adjoint_taps``) and the autograd transpose
   (bins expanded, then ``ops.rotate.rotate_adjoint``), in turns, by CUDA
   events and by the profiler's device time and op count.
3. The band step's phases at the immediate flagship (f32; the
   Reconstructor of chip_smoke's phase 4d on one angle, the middle grid
   row): the band's rotation, binning, padding and z-major extraction;
   the forward model, loss and backward (K1 pair); the band accumulator
   and K6; the band's rotate-back (the path's exact adjoint); the
   object-sized gradient; the optimizer update (Adam) and constraints.
   For each, the host's time to issue it (no synchronisation inside),
   the device time and the kernels a call, from torch.profiler.

Prints the card's name and power limit first.
"""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from adorym_tpu_torch.ops import cuda_multislice as cm  # noqa: E402
from adorym_tpu_torch.ops import propagate as prop  # noqa: E402
from adorym_tpu_torch.ops import rotate as rot  # noqa: E402


def events_ms(fn, reps):
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


def device_ms(fn, reps, match=None):
    """Device time a call from torch.profiler (kernels whose name contains
    ``match``, or all), and device kernels a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if str(getattr(e, 'device_type', '')).endswith('CUDA')
           and (match is None or match in e.key)]
    return (sum(e.self_device_time_total for e in evs) / 1e3 / reps,
            sum(e.count for e in evs) / reps)


def k1_sizes(reps):
    dev = torch.device('cuda')
    S, n = 32, 72
    lmbda = 1240.0 / 5000.0
    k1 = 2 * np.pi / lmbda
    h = prop.fresnel_kernel((n, n), (1.0, 1.0, 1.0), lmbda, 8.0, device=dev)
    fay, fax = prop.final_prop_mats((n, n), (1.0, 1.0, 1.0), lmbda, 'inf',
                                    device=dev)[:2]
    mats = cm.prop_mats(h, fay, fax, route='fft')
    for dtype in (torch.float32, torch.bfloat16):
        for N in (23, 46, 132, 264, 529):
            gen = torch.Generator(device=dev).manual_seed(N)
            db = (torch.rand((S, 2, N, n, n), device=dev, generator=gen)
                  * 0.01).to(dtype).requires_grad_()
            wave = torch.randn((1, N, n, n), dtype=torch.complex64,
                               device=dev, generator=gen).requires_grad_()
            g = torch.randn((1, N, n, n), dtype=torch.complex64, device=dev,
                            generator=gen)
            out = cm.MultisliceDbStored.apply(db, wave, mats, k1, 1.0)

            def fwd():
                with torch.no_grad():
                    cm.MultisliceDbStored.apply(db, wave, mats, k1, 1.0)

            def bwd():
                torch.autograd.grad(out, (db, wave), g, retain_graph=True)
            f_ev, b_ev = events_ms(fwd, reps), events_ms(bwd, reps)
            f_dev, _ = device_ms(fwd, reps, 'fwd_kernel')
            b_dev, _ = device_ms(bwd, reps, 'bwd_kernel')
            print(f'K1 {str(dtype)[6:]} N={N}: forward {f_ev:.4f} ms events, '
                  f'{f_dev:.4f} ms kernel; backward {b_ev:.4f} ms events, '
                  f'{b_dev:.4f} ms kernel', flush=True)
            del db, wave, g, out


def band_adjoint(reps):
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(19)
    acc = torch.randn((72, 260, 32, 2), device=dev, generator=gen)
    gb = acc[:, 4:]
    theta, binning, nz = 0.7, 8, 256

    def taps():
        return rot.rotate_adjoint_taps(gb, theta, binning=binning,
                                       nz_full=nz)

    def transpose():
        full = torch.repeat_interleave(gb, binning, dim=2)[:, :, :nz]
        return rot.rotate_adjoint(full, theta)
    forms = {'taps': taps, 'transpose': transpose}
    ev = {k: [] for k in forms}
    for name in ('taps', 'transpose', 'transpose', 'taps'):
        ev[name].append(events_ms(forms[name], reps))
    for name, fn in forms.items():
        dev_ms, kernels = device_ms(fn, reps)
        print(f'band adjoint {name}: {np.mean(ev[name]):.3f} ms events '
              f'({", ".join(f"{v:.3f}" for v in ev[name])}), '
              f'{dev_ms:.3f} ms device in {kernels:.0f} kernels a call',
              flush=True)


def band_phases(reps):
    import time
    import chip_smoke
    import adorym_tpu_torch as pt
    from adorym_tpu_torch import recon
    from adorym_tpu_torch.ops import cuda_scatter_grid as csg
    from adorym_tpu_torch.ops import patches as patch_ops
    cfg = chip_smoke.flagship_config(False, 'immediate')
    pos = chip_smoke.flagship_positions()
    data = np.random.default_rng(0).random((1, len(pos), 72, 72),
                                           dtype=np.float32)
    rec = pt.Reconstructor(cfg, data=data, probe_pos=pos,
                           theta_ls=np.array([0.7], np.float32),
                           obj_init=np.zeros((256,) * 3 + (2,), np.float32))
    inds = np.arange(11 * 23, 12 * 23)
    row = rec.probe_pos[inds].astype(np.float32)
    y0 = int(np.round(row[0, 0]))
    x0s = np.round(row[:, 1]).astype(np.int64) + 4
    posi = np.stack([np.zeros_like(x0s), x0s], 1)
    measured = rec._dataset()[0][torch.as_tensor(inds, device='cuda')]
    obj = rec.params['obj']
    theta = 0.7
    state = {}

    def fwd():
        rb = recon._band_rotate_fwd(obj[y0:y0 + 72], theta, cfg, 4, 0)
        state['sub'] = patch_ops.extract_patches_zmajor(
            rb.permute(2, 3, 0, 1).contiguous(), posi, (72, 72))

    def model():
        state['g'] = rec._patch_grads(state['sub'].detach(), 0, theta,
                                      measured, True, 1)

    def scatter():
        acc = torch.zeros((72, 260, 32, 2), device='cuda')
        csg.scatter_rowgrid_add_kernel(acc, state['g'][1], 0, int(x0s[0]), 8)
        state['acc'] = acc

    def back():
        state['g_band'] = recon._band_grad_back(state['acc'], theta, cfg, 4,
                                                256, 256)

    def grad():
        g_obj = torch.zeros_like(obj)
        g_obj[y0:y0 + 72] = state['g_band']
        state['g_obj'] = g_obj

    def update():
        rec.apply_step({'obj': state['g_obj']}, 0, 0)

    phases = [('band forward', fwd), ('model + backward (K1)', model),
              ('accumulator + K6', scatter), ('rotate-back', back),
              ('object gradient', grad), ('Adam + constraints', update)]
    total = [0.0, 0.0]
    for name, fn in phases:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        dev_ms, kernels = device_ms(fn, reps)
        total[0] += host
        total[1] += dev_ms
        print(f'band step {name}: host {host:.3f} ms, device {dev_ms:.3f} '
              f'ms in {kernels:.0f} kernels', flush=True)
    print(f'band step, all phases: host {total[0]:.3f} ms, device '
          f'{total[1]:.3f} ms', flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('probe_immediate_torch: no CUDA device', file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    band_adjoint(args.reps)
    band_phases(args.reps)
    k1_sizes(args.reps)
    return 0


if __name__ == '__main__':
    sys.exit(main())
