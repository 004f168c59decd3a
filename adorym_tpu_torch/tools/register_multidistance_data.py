#!/usr/bin/env python
"""Register multi-distance hologram TIFFs against a reference distance, on
the port (the JAX package's ``tools/register_multidistance_data.py``): for
each angle, every distance's image is shifted onto the reference
distance's image using upsampled-DFT phase correlation
(``metrics.register_translation``; the shifts measured at theta 0 and
reused) and a Fourier shift on the device (``ops.fourier.fourier_shift``).
Writes ``<dir>_registered/``.

    python -m adorym_tpu_torch.tools.register_multidistance_data DIR [PREFIX] [--device cpu]
"""

import argparse
import os

import numpy as np
import torch


def register_folder(src_dir, prefix='data', i_ref=0, upsample=10,
                    device=None):
    from adorym_tpu_torch.io.data import parse_source_folder
    from adorym_tpu_torch.io.output import read_tiff, write_tiff
    from adorym_tpu_torch.metrics import register_translation
    from adorym_tpu_torch.ops.fourier import fourier_shift
    from adorym_tpu_torch.recon import resolve_device

    dev = resolve_device(device)
    flist, n_theta, n_dists, shape = parse_source_folder(src_dir, prefix)
    out_dir = os.path.join(os.path.dirname(src_dir.rstrip('/')),
                           os.path.basename(src_dir.rstrip('/')) + '_registered')
    os.makedirs(out_dir, exist_ok=True)
    shifts = [np.zeros(2)] * n_dists
    for i_theta in range(n_theta):
        ref_img = np.squeeze(read_tiff(flist[i_theta * n_dists + i_ref]))
        for i_dist in range(n_dists):
            fname = flist[i_theta * n_dists + i_dist]
            img = np.squeeze(read_tiff(fname))
            if i_dist != i_ref:
                if i_theta == 0:
                    shifts[i_dist] = np.asarray(register_translation(
                        ref_img, img, upsample_factor=upsample))
                img = torch.real(fourier_shift(
                    torch.tensor(img, dtype=torch.complex64, device=dev),
                    torch.as_tensor(shifts[i_dist], dtype=torch.float32,
                                    device=dev))).cpu().numpy()
            write_tiff(img, os.path.join(out_dir, os.path.basename(fname)))
    return out_dir, shifts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('dir')
    p.add_argument('prefix', nargs='?', default='data')
    p.add_argument('--ref', type=int, default=0)
    p.add_argument('--device', default=None,
                   help="'cpu' to run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    out_dir, shifts = register_folder(args.dir, args.prefix, args.ref,
                                      device=args.device)
    print(f'wrote {out_dir}; shifts: {[list(np.round(s, 2)) for s in shifts]}')


if __name__ == '__main__':
    main()
