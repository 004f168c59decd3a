#!/usr/bin/env python
"""Convert a folder of multi-distance hologram TIFFs into Adorym HDF5, on
the port (the JAX package's ``tools/convert_multidistance_to_adorym.py``;
needs ``h5py``): raw files named ``prefix_<iTheta>_<iDistance>.tiff``
become ``exchange/data[theta, i_dist * n_blocks + block, y, x]``,
optionally tiled into ``n_blocks_y x n_blocks_x`` sub-blocks (the block
scan positions go to ``metadata/probe_pos_px``).

    python -m adorym_tpu_torch.tools.convert_multidistance_to_adorym DIR 0.1,0.2,0.3
"""

import argparse
import os

import numpy as np


def convert(src_dir, distances_cm, prefix='data', out_path='data.h5',
            n_blocks_y=1, n_blocks_x=1, energy_ev=5000.0, psize_cm=1e-4):
    from adorym_tpu_torch.io.data import _h5py, parse_source_folder
    from adorym_tpu_torch.io.output import read_tiff
    flist, n_theta, n_dists, shape = parse_source_folder(src_dir, prefix)
    if n_dists != len(distances_cm):
        raise ValueError(f'found {n_dists} distances in folder, '
                         f'{len(distances_cm)} given')
    n_blocks = n_blocks_y * n_blocks_x
    by = shape[0] // n_blocks_y
    bx = shape[1] // n_blocks_x
    pos = np.array([[iy * by, ix * bx] for iy in range(n_blocks_y)
                    for ix in range(n_blocks_x)], np.float64)
    with _h5py().File(out_path, 'w') as f:
        dset = f.create_dataset(
            'exchange/data', shape=(n_theta, n_dists * n_blocks, by, bx),
            dtype=np.float32)
        for i_theta in range(n_theta):
            for i_dist in range(n_dists):
                img = np.squeeze(read_tiff(flist[i_theta * n_dists + i_dist]))
                for b, (py, px) in enumerate(pos.astype(int)):
                    dset[i_theta, i_dist * n_blocks + b] = \
                        img[py:py + by, px:px + bx]
        f.create_dataset('metadata/energy_ev', data=float(energy_ev))
        f.create_dataset('metadata/psize_cm', data=float(psize_cm))
        f.create_dataset('metadata/free_prop_cm',
                         data=np.asarray(distances_cm, np.float64))
        f.create_dataset('metadata/probe_pos_px', data=pos)
    return dict(n_theta=n_theta, n_dists=n_dists, n_blocks=n_blocks,
                block_shape=(by, bx))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('dir')
    p.add_argument('distances_cm',
                   help='comma-separated distances in cm, in file order')
    p.add_argument('prefix', nargs='?', default='data')
    p.add_argument('--output', default='data.h5')
    p.add_argument('--n_blocks_y', type=int, default=1)
    p.add_argument('--n_blocks_x', type=int, default=1)
    p.add_argument('--energy_ev', type=float, default=5000.0)
    p.add_argument('--psize_cm', type=float, default=1e-4)
    args = p.parse_args(argv)
    dists = [float(d) for d in args.distances_cm.split(',')]
    info = convert(args.dir, dists, args.prefix, args.output,
                   args.n_blocks_y, args.n_blocks_x, args.energy_ev,
                   args.psize_cm)
    print(f'wrote {args.output}: {info}')


if __name__ == '__main__':
    main()
