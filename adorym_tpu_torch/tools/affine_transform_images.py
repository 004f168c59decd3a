#!/usr/bin/env python
"""Apply refined per-distance affine matrices to hologram image stacks, on
the port (the JAX package's ``tools/affine_transform_images.py``): loads
the ``prj_affine_ls`` matrices a reconstruction refined (one ``[2, 3]``
block per distance, stacked in a text file), warps each distance's images
by its matrix (``ops.warp.affine_transform_2d`` on the device) and writes
the transformed stacks, e.g. to feed registered data into a follow-up
reconstruction.

    python -m adorym_tpu_torch.tools.affine_transform_images DIR MATS [--device cpu]
"""

import argparse
import os

import numpy as np
import torch


def apply_affines(image_dir, mat_path, out_dir, prefix='*', device=None):
    from adorym_tpu_torch.io.data import parse_source_folder
    from adorym_tpu_torch.io.output import read_tiff, write_tiff
    from adorym_tpu_torch.ops.warp import affine_transform_2d
    from adorym_tpu_torch.recon import resolve_device

    dev = resolve_device(device)
    mats = np.loadtxt(mat_path)
    mats = np.split(mats, len(mats) // 2, 0)
    flist, n_theta, n_dists, shape = parse_source_folder(image_dir, prefix)
    assert len(mats) == n_dists, (len(mats), n_dists)
    os.makedirs(out_dir, exist_ok=True)
    for i_dist in range(n_dists):
        stack = np.stack([np.squeeze(read_tiff(flist[i_dist + t * n_dists]))
                          for t in range(n_theta)])
        warped = affine_transform_2d(
            torch.as_tensor(stack, dtype=torch.float32, device=dev),
            torch.as_tensor(mats[i_dist], dtype=torch.float32,
                            device=dev)).cpu().numpy()
        for t, img in enumerate(warped):
            write_tiff(img, os.path.join(
                out_dir, os.path.basename(flist[i_dist + t * n_dists])))
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('image_dir')
    p.add_argument('mat_file', help='stacked [2,3] affine blocks, np.savetxt')
    p.add_argument('--output', default=None)
    p.add_argument('--prefix', default='*')
    p.add_argument('--device', default=None,
                   help="'cpu' to run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    out = args.output or args.image_dir.rstrip('/') + '_afteropt'
    print('wrote', apply_affines(args.image_dir, args.mat_file, out,
                                 args.prefix, device=args.device))


if __name__ == '__main__':
    main()
