#!/usr/bin/env python
"""Standalone multi-distance CTF phase retrieval from an Adorym-layout
HDF5, on the port (the JAX package's
``tools/phase_retrieval_multidist_ctf.py``, through
``adorym_tpu_torch.conventional.multidistance_ctf``; needs ``h5py``).

    python -m adorym_tpu_torch.tools.phase_retrieval_multidist_ctf data.h5 \\
        --out phase --free-prop-cm 0.05 0.12 0.3 0.7 [--device cpu]
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('data_file')
    p.add_argument('--out', required=True)
    p.add_argument('--free-prop-cm', nargs='+', type=float, required=True)
    p.add_argument('--energy-ev', type=float)
    p.add_argument('--psize-cm', type=float)
    p.add_argument('--kappa', type=float, default=50.0)
    p.add_argument('--safe-zone-width', type=int, default=0)
    p.add_argument('--i-theta', type=int, default=0)
    p.add_argument('--device', default=None,
                   help="'cpu' to run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)

    from adorym_tpu_torch.conventional import multidistance_ctf
    from adorym_tpu_torch.io.data import RawDataset
    from adorym_tpu_torch.io.output import write_tiff

    ds = RawDataset(args.data_file)
    mags = ds.all_magnitudes()[args.i_theta]
    n_dists = len(args.free_prop_cm)
    assert mags.shape[0] % n_dists == 0
    # one block per distance (full-field layout)
    prj = mags[::mags.shape[0] // n_dists] ** 2
    phase = multidistance_ctf(prj, np.asarray(args.free_prop_cm),
                              ds.energy_ev(args.energy_ev),
                              ds.psize_cm(args.psize_cm),
                              kappa=args.kappa,
                              safe_zone_width=args.safe_zone_width,
                              device=args.device)
    path = write_tiff(phase.cpu().numpy(), args.out)
    print(f'wrote {path}')
    return path


if __name__ == '__main__':
    main()
