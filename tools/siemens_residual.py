"""Position refinement at BASELINE #2's size, on the CPU, by either package.

chip_smoke phase 7a's configuration (``demos/2d_ptychography_experimental_
data.py`` at the demo's size: a 256^2 Siemens star, 16 x 16 spots of 72^2
intensities jittered by up to 1.5 px, 5 aperture modes, minibatch 35, Adam,
probe and positions refined): the data are simulated by the port on the
CPU and written to one HDF5 file, which ``--package`` (``torch``, the
port, or ``jax``, the JAX package) reconstructs through its
``reconstruct_ptychography`` with ``save_intermediate``.  Prints the mean
position residual (the demos' ``|correction - true offset|``, offsets less
their mean) and the correlation of the corrections with the true offsets
after every epoch, so the two packages' trajectories can be set side by
side.  ``--delay-epochs`` holds the position updates back that many epochs
(``other_params_update_delay``).  Needs ``h5py``.

    python tools/siemens_residual.py --package torch --epochs 60
    JAX_PLATFORMS=cpu python tools/siemens_residual.py --package jax \
        --epochs 60
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import adorym_tpu_torch as pt  # noqa: E402
from adorym_tpu_torch.utils.initialize import initialize_probe  # noqa: E402

N, PN, STRIDE = 256, 72, 12
ENERGY_EV, PSIZE_CM = 8801.121930115722, 1.32789376566526e-06
#: The demo's keywords (``:93-110``), as chip_smoke's ``SIEMENS_KW``.
KW = dict(
    obj_size=(N, N, 1), two_d_mode=True, free_prop_cm='inf',
    energy_ev=ENERGY_EV, psize_cm=PSIZE_CM, minibatch_size=35,
    random_guess_means_sigmas=(1., 0., 0.001, 0.002),
    probe_type='aperture_defocus', n_probe_modes=5, aperture_radius=10,
    beamstop_radius=5, probe_defocus_cm=0.0069, rescale_probe_intensity=True,
    raw_data_type='intensity', optimizer='adam', learning_rate=1e-3,
    optimize_probe=True, probe_learning_rate=1e-3,
    optimize_all_probe_pos=True, all_probe_pos_learning_rate=1e-2,
    update_scheme='immediate', unknown_type='real_imag',
    loss_function_type='lsq', use_checkpoint=False, save_intermediate=True)


def siemens_star(n, spokes=24):
    from scipy.ndimage import gaussian_filter
    yy, xx = np.mgrid[0:n, 0:n].astype(float) - n / 2
    r = np.hypot(yy, xx)
    star = (np.sin(spokes * np.arctan2(yy, xx)) > 0).astype(float)
    star *= (r > 6) & (r < n * 0.45)
    return gaussian_filter(star, 1.0)


def write_data(path):
    """chip_smoke's ``siemens_data`` on the CPU, into an HDF5 file with the
    nominal grid recorded.  Returns the true offsets less their mean."""
    import h5py
    rng = np.random.default_rng(0)
    xs = np.arange(0, N - PN + 1, STRIDE)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    nominal = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    star = siemens_star(N)
    ph, mag = 0.4 * star, 1.0 - 0.25 * star
    obj = np.stack([mag * np.cos(ph), mag * np.sin(ph)],
                   -1)[:, :, None, :].astype(np.float32)
    probe = initialize_probe(
        (PN, PN), 'aperture_defocus', n_probe_modes=5, energy_ev=ENERGY_EV,
        psize_cm=PSIZE_CM, aperture_radius=10, beamstop_radius=5,
        probe_defocus_cm=0.0069, seed=0)
    prng = np.random.default_rng(1)
    probe = probe + 0.05 * np.abs(probe).max() * prng.normal(
        size=probe.shape).astype(np.float32)
    true = nominal + rng.uniform(-1.5, 1.5, nominal.shape)
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(N, N, 1), probe_size=(PN, PN),
                             energy_ev=ENERGY_EV, psize_cm=PSIZE_CM,
                             free_prop_cm='inf', two_d_mode=True),
        train=pt.TrainConfig(minibatch_size=35, unknown_type='real_imag'))
    data = np.asarray(pt.simulate(cfg, obj, probe, true, device='cpu')) ** 2
    with h5py.File(path, 'w') as f:
        f['exchange/data'] = data
        f['exchange/theta'] = np.zeros(1)
        f['metadata/probe_pos_px'] = nominal
        f['metadata/energy_ev'] = ENERGY_EV
        f['metadata/psize_cm'] = PSIZE_CM
    err = true - nominal
    return err - err.mean(0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--package', choices=('torch', 'jax'), default='torch')
    ap.add_argument('--epochs', type=int, default=60)
    ap.add_argument('--delay-epochs', type=int, default=0)
    ap.add_argument('--threads', type=int, default=3)
    ap.add_argument('--out', default=str(REPO / 'build' / 'siemens_residual'))
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    out = Path(args.out) / f'{args.package}_{args.epochs}_d{args.delay_epochs}'
    out.mkdir(parents=True, exist_ok=True)
    err = write_data(out / 'data.h5')
    kw = dict(KW, fname='data.h5', save_path=str(out), output_folder='out',
              n_epochs=args.epochs,
              other_params_update_delay=8 * args.delay_epochs)
    t0 = time.perf_counter()
    if args.package == 'jax':
        import jax
        jax.config.update('jax_platforms', 'cpu')
        import adorym_tpu
        res = adorym_tpu.reconstruct_ptychography(**kw)
    else:
        res = pt.reconstruct_ptychography(device='cpu', **kw)
    wall = time.perf_counter() - t0
    print(f'{args.package}: {args.epochs} epochs, position updates held '
          f'back {args.delay_epochs}; wall {wall:.1f} s; residual before '
          f'{float(np.abs(err).mean()):.6f} px')
    files = (out / 'out' / 'intermediate' / 'probe_pos').glob(
        'probe_pos_correction_*.txt')
    for f in sorted(files, key=lambda f: int(re.findall(r'_(\d+)\.txt',
                                                        f.name)[0])):
        ep = int(re.findall(r'_(\d+)\.txt', f.name)[0])
        c = np.loadtxt(f).reshape(-1, 2)
        corr = (np.corrcoef(c.ravel(), err.ravel())[0, 1] if np.any(c)
                else 0.0)
        print(f'epoch {ep} residual {np.abs(c - err).mean():.6f} px '
              f'correlation {corr:.4f}')
    print('losses', [float(v) for v in res['loss_history']])


if __name__ == '__main__':
    main()
