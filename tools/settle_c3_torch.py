"""Settle ROADMAP C.3: why the adhesin configuration's CUDA and CPU runs
part (the reference's CI configuration, ``demos/multislice_tomography_64.
py``: 64^3, 36 angles of one 64^2 pattern, 64 unfolded slices, reweighted
L1 and TV, Adam 5e-6, minibatch 1).

    python tools/settle_c3_torch.py        # on one CUDA card, ~2 min

1. The first batch, before any update: its loss and the object's gradient
   on CUDA (K1 at one patch, FFT route) and on the CPU (the plain FFT
   scan), each against the same forward evaluated in float64 / complex128
   (the same rotation coordinates, a complex128 multislice with a float64
   transfer function, the regularizers in float64), by autograd.
2. Three epochs through ``reconstruct_ptychography``: the CUDA-CPU gap of
   each epoch's loss against the spread of runs from starts perturbed by
   k 2^-23 = k 1.19e-7 (relative, in delta; k = 1..5, each a distinct f32
   start: 1 + 3e-7 and 1 + 4e-7 round to the same float32), on the CPU
   and on the card.

The data are the port's ``simulate`` of the demo's phantom on the card,
as chip_smoke's phase 6b makes them (so the run needs no ``h5py``).
Prints the card's name and power limit and, last, one JSON line with
every number.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N = 64
KW = dict(obj_size=(N, N, N), learning_rate=5e-6, alpha_d=1e-9 * N ** 3,
          alpha_b=1e-10 * N ** 3, reweighted_l1=True, energy_ev=800,
          psize_cm=0.67e-7, minibatch_size=1, free_prop_cm=0,
          probe_type='plane', probe_pos=[(0, 0)], optimizer='adam',
          use_checkpoint=False)
N_PERTURBED = 5


def phantom():
    """``make_phantom`` of ``demos/multislice_tomography_64.py``."""
    rng = np.random.default_rng(0)
    zz, yy, xx = np.mgrid[:N, :N, :N].astype(np.float32)
    vol = np.zeros((N, N, N), np.float32)
    for _ in range(6):
        c = rng.uniform(0.3 * N, 0.7 * N, 3)
        r = rng.uniform(0.06 * N, 0.16 * N)
        vol += np.exp(-(((zz - c[0]) ** 2 + (yy - c[1]) ** 2
                         + (xx - c[2]) ** 2) / (2 * r ** 2)))
    vol /= vol.max()
    return np.stack([vol * 1e-3, vol * 3e-5], -1).astype(np.float32)


def dataset():
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.io.data import ArrayDataset
    from adorym_tpu_torch.utils.initialize import initialize_probe
    theta = np.linspace(0, 2 * np.pi, 36, endpoint=False)
    cfg = pt.ReconConfig(geometry=pt.Geometry(
        obj_size=(N, N, N), probe_size=(N, N), energy_ev=800.0,
        psize_cm=0.67e-7, free_prop_cm=None))
    data = pt.simulate(cfg, phantom(), initialize_probe((N, N), 'plane'),
                       np.array([[0.0, 0.0]]), theta)
    return ArrayDataset(data, theta=theta, probe_pos_px=np.array([[0., 0.]]),
                        energy_ev=800.0, psize_cm=0.67e-7), data, theta


def config():
    import adorym_tpu_torch as pt
    return pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(N, N, N), probe_size=(N, N),
                             energy_ev=800.0, psize_cm=0.67e-7,
                             free_prop_cm=0),
        loss=pt.LossConfig(alpha_d=KW['alpha_d'], alpha_b=KW['alpha_b'],
                           gamma=1e-6, reweighted_l1=True),
        train=pt.TrainConfig(minibatch_size=1, learning_rate=5e-6,
                             optimizer='adam'))


def truth_loss(rec, obj64, batch, measured):
    """The first batch's loss in float64 / complex128: the port's rotation
    (its f32 coordinates, f64 values), a complex128 multislice through the
    64 slices with a float64 transfer function, the lsq mismatch, and the
    regularizers on the f64 object with f64 reweighting weights."""
    from adorym_tpu_torch.constants import PI, wavelength_nm
    from adorym_tpu_torch.models import regularizers as regs
    from adorym_tpu_torch.ops.rotate import rotate
    geo = rec.cfg.geometry
    rot = rotate(obj64, batch['theta'], method=rec.cfg.train.interpolation)
    delta, beta = rot[..., 0], rot[..., 1]
    lmbda = wavelength_nm(geo.energy_ev)
    voxel = geo.psize_cm * 1e7
    k1 = 2 * PI * voxel / lmbda
    u = np.fft.fftfreq(N) / voxel
    quad = u[:, None] ** 2 + u[None, :] ** 2
    h = torch.tensor(np.exp(-1j * PI * lmbda * voxel * quad),
                     dtype=torch.complex128, device=obj64.device)
    probe = rec.params['probe'].double()
    w = torch.complex(probe[0, ..., 0], probe[0, ..., 1])
    for z in range(N):
        t = torch.polar(torch.exp(-k1 * beta[..., z]), -k1 * delta[..., z])
        w = w * t
        if z < N - 1:
            w = torch.fft.ifft2(torch.fft.fft2(w) * h)
    mis = torch.mean((torch.abs(w) - measured[0].double()) ** 2)
    weight = rec._weight_l1_refresh(obj64.detach())
    return mis + regs.total_regularization(rec.reg_list, obj64,
                                           weight_l1=weight)


def first_batch(data, theta):
    """Loss and object gradient of the first batch on each device, and the
    float64 truth (on the CPU)."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.utils.initialize import initialize_object
    obj0 = initialize_object((N, N, N), seed=0)
    out = {}
    for dev in ('cuda', 'cpu'):
        rec = pt.Reconstructor(config(), data=data,
                               probe_pos=np.array([[0.0, 0.0]]),
                               theta_ls=theta, obj_init=obj0, device=dev)
        i_theta, inds = rec.make_batches(np.random.default_rng(0))[0]
        batch = {'i_theta': i_theta,
                 'theta': float(rec.theta_ls[i_theta]),
                 'pos_batch': rec.probe_pos[inds].astype(np.float32),
                 'ind_batch': np.asarray(inds)}
        measured = rec._dataset()[i_theta][torch.as_tensor(
            inds, device=rec.device)]
        rec.weight_l1 = rec._weight_l1_refresh(rec.params['obj'])
        params = {k: v.detach().requires_grad_(k == 'obj')
                  for k, v in rec.params.items()}
        with torch.enable_grad():
            loss = rec.loss_fn(params, batch, measured)
            g, = torch.autograd.grad(loss, params['obj'])
        out[dev] = (float(loss.detach()), g.detach().double().cpu())
        if dev == 'cpu':
            o64 = rec.params['obj'].double().requires_grad_()
            with torch.enable_grad():
                lt = truth_loss(rec, o64, batch, measured)
                gt, = torch.autograd.grad(lt, o64)
            out['f64'] = (float(lt.detach()), gt.detach())
    lt, gt = out['f64']
    scale = float(gt.abs().max())
    res = {}
    for dev in ('cuda', 'cpu'):
        loss, g = out[dev]
        res[dev] = {'loss_rel': abs(loss - lt) / abs(lt),
                    'grad_rel_max': float((g - gt).abs().max()) / scale}
    res['cuda_vs_cpu'] = {
        'loss_rel': abs(out['cuda'][0] - out['cpu'][0]) / abs(lt),
        'grad_rel_max': float((out['cuda'][1] - out['cpu'][1]).abs().max())
        / scale}
    res['loss_f64'] = lt
    return res


def epochs(ds, work):
    """Per-epoch losses of 3 epochs: CUDA, the CPU, and each from starts
    perturbed by k f32 ulps (k 1.19e-7) in delta (k = 1..N_PERTURBED)."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.utils.initialize import initialize_object
    start = initialize_object((N, N, N), seed=0)
    runs = {}
    for dev in ('cuda', 'cpu'):
        for k in range(N_PERTURBED + 1):
            guess = None if k == 0 else (
                start[..., 0] * np.float32(1 + k * 2.0 ** -23),
                start[..., 1])
            t0 = time.perf_counter()
            res = pt.reconstruct_ptychography(
                fname='d.h5', save_path=str(work), output_folder=None,
                n_epochs=3, device=dev, dataset=ds, initial_guess=guess,
                **KW)
            runs[(dev, k)] = np.asarray(res['loss_history'])
            print(f'{dev} start +{k} ulp: losses {list(runs[(dev, k)])} '
                  f'({time.perf_counter() - t0:.1f} s)', flush=True)
    ref = runs[('cpu', 0)]
    gap = np.abs(runs[('cuda', 0)] - ref) / np.abs(ref)
    spread = {dev: np.max([np.abs(runs[(dev, k)] - runs[(dev, 0)])
                           / np.abs(runs[(dev, 0)])
                           for k in range(1, N_PERTURBED + 1)], axis=0)
              for dev in ('cpu', 'cuda')}
    return {'losses': {f'{d} {k}': list(v) for (d, k), v in runs.items()},
            'cuda_cpu_gap': list(gap),
            'cpu_spread_max': list(spread['cpu']),
            'cuda_spread_max': list(spread['cuda']),
            'gap_inside_cpu_spread': bool(np.all(gap <= spread['cpu']))}


def main():
    if not torch.cuda.is_available():
        print('settle_c3_torch: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ds, data, theta = dataset()
    fb = first_batch(np.abs(data).astype(np.float32), theta)
    print(f'first batch against float64: {fb}', flush=True)
    work = ROOT / 'build'
    work.mkdir(exist_ok=True)
    ep = epochs(ds, work)
    out = {'card': smi, 'first_batch': fb, 'epochs': ep}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
