#!/usr/bin/env python
"""Simulate a ptychography dataset from a phantom into the Adorym HDF5
layout, on the port (the JAX package's ``tools/create_ptycho_data.py``,
through ``adorym_tpu_torch.simulate_to_file``; needs ``h5py``).

Example:
  python -m adorym_tpu_torch.tools.create_ptycho_data --out data.h5 \\
      --obj-size 64 64 64 --probe-size 32 --stride 8 --n-theta 36 \\
      --energy-ev 5000 --psize-cm 1e-7 --phantom blobs [--device cpu]
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--out', required=True)
    p.add_argument('--obj-size', nargs=3, type=int, required=True)
    p.add_argument('--probe-size', type=int, required=True)
    p.add_argument('--stride', type=int, default=8)
    p.add_argument('--n-theta', type=int, default=1)
    p.add_argument('--energy-ev', type=float, default=5000.0)
    p.add_argument('--psize-cm', type=float, default=1e-7)
    p.add_argument('--free-prop-cm', default='inf')
    p.add_argument('--phantom', choices=['blobs', 'delta-npy'], default='blobs')
    p.add_argument('--delta-npy')
    p.add_argument('--beta-npy')
    p.add_argument('--probe-type', default='gaussian')
    p.add_argument('--probe-mag-sigma', type=float, default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None,
                   help="'cpu' to run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)

    from adorym_tpu_torch import (Geometry, ReconConfig, TrainConfig,
                                  simulate_to_file)
    from adorym_tpu_torch.utils.initialize import initialize_probe

    Y, X, Z = args.obj_size
    pn = args.probe_size
    if args.phantom == 'delta-npy':
        delta = np.load(args.delta_npy)
        beta = np.load(args.beta_npy) if args.beta_npy else delta * 0.03
        obj = np.stack([delta, beta], -1).astype(np.float32)
    else:
        from scipy.ndimage import gaussian_filter
        rng = np.random.default_rng(args.seed)
        vol = gaussian_filter(rng.random((Y, X, Z)), 3)
        vol = (vol - vol.min()) / max(vol.max() - vol.min(), 1e-12)
        obj = np.stack([vol * 1e-3, vol * 3e-5], -1).astype(np.float32)

    fp = args.free_prop_cm if args.free_prop_cm == 'inf' \
        else float(args.free_prop_cm)
    cfg = ReconConfig(
        geometry=Geometry(obj_size=(Y, X, Z), probe_size=(pn, pn),
                          energy_ev=args.energy_ev, psize_cm=args.psize_cm,
                          free_prop_cm=fp, two_d_mode=(Z == 1)),
        train=TrainConfig(minibatch_size=1))
    sigma = args.probe_mag_sigma or pn / 5
    kw = {}
    if args.probe_type == 'gaussian':
        kw = dict(probe_mag_sigma=sigma, probe_phase_sigma=sigma,
                  probe_phase_max=0.4)
    probe = initialize_probe((pn, pn), args.probe_type,
                             energy_ev=args.energy_ev,
                             psize_cm=args.psize_cm, **kw)
    xs = np.arange(0, Y - pn + 1, args.stride)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    theta = np.linspace(0, np.pi, args.n_theta, endpoint=False)
    data = simulate_to_file(args.out, cfg, obj, probe, pos, theta_ls=theta,
                            device=args.device)
    print(f'wrote {args.out}: data shape {data.shape}')
    return data


if __name__ == '__main__':
    main()
