#!/usr/bin/env python
"""Rescale cone-beam multi-distance holograms to parallel-beam geometry,
on the port (the JAX package's ``tools/rescale_multidistance_data.py``):
the Fresnel scaling theorem; each distance's image is zoomed to a common
magnification (or a common pixel size when ``--psize_ls`` is given),
center-cropped, and the effective parallel-beam distances
``z_eff = z_so * z_od / z_sd`` are written alongside.  Run before
``convert_multidistance_to_adorym``.

    python -m adorym_tpu_torch.tools.rescale_multidistance_data DIR --z_od_ls 20,36 --z_sd 100
"""

import argparse
import os

import numpy as np


def convert_cone_to_parallel(data, z_sd, z_od_ls, psize_ls=None, crop=True):
    """``data``: [n_dists, y, x] images at one angle.  Returns
    (rescaled images, z_eff_ls, mag_ls) — ``adorym`` reference
    ``rescale_multidistance_data.py:37-76`` semantics."""
    from scipy.ndimage import zoom as nd_zoom
    z_od_ls = np.asarray(z_od_ls, np.float64)
    z_so_ls = z_sd - z_od_ls
    z_eff_ls = z_so_ls * z_od_ls / z_sd
    mag_ls = z_sd / z_so_ls
    if psize_ls is not None:
        scale = np.asarray(psize_ls, np.float64)
        scale = scale / scale.min()
        ind_ref = int(np.argmin(psize_ls))
    else:
        scale = (mag_ls / mag_ls.max())
        scale = 1.0 / scale
        ind_ref = int(np.argmax(mag_ls))
    shape_ref = np.asarray(data[ind_ref].shape)
    half = (shape_ref / 2).astype(int)
    out = []
    for i, img in enumerate(data):
        if i != ind_ref:
            img = nd_zoom(img, scale[i], order=1)
            if crop:
                c = (np.asarray(img.shape) / 2).astype(int)
                img = img[c[0] - half[0]:c[0] - half[0] + shape_ref[0],
                          c[1] - half[1]:c[1] - half[1] + shape_ref[1]]
        out.append(np.asarray(img))
    return out, z_eff_ls, mag_ls


def main(argv=None):
    from adorym_tpu_torch.io.data import parse_source_folder
    from adorym_tpu_torch.io.output import read_tiff, write_tiff
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('dir')
    p.add_argument('prefix', nargs='?', default='data')
    p.add_argument('--z_od_ls', required=True,
                   help='object-detector distances (cm), comma-separated')
    p.add_argument('--z_sd', type=float, required=True,
                   help='source-detector distance (cm)')
    p.add_argument('--psize_ls', default=None,
                   help='per-distance pixel sizes (um), comma-separated')
    p.add_argument('--no_crop', action='store_true')
    args = p.parse_args(argv)
    z_od_ls = [float(z) for z in args.z_od_ls.split(',')]
    psize_ls = ([float(z) for z in args.psize_ls.split(',')]
                if args.psize_ls else None)

    flist, n_theta, n_dists, shape = parse_source_folder(args.dir, args.prefix)
    out_dir = os.path.join(os.path.dirname(args.dir.rstrip('/')),
                           os.path.basename(args.dir.rstrip('/')) + '_rescaled')
    os.makedirs(out_dir, exist_ok=True)
    z_eff_ls = mag_ls = None
    for i_theta in range(n_theta):
        imgs = [np.squeeze(read_tiff(flist[i_theta * n_dists + d]))
                for d in range(n_dists)]
        imgs, z_eff_ls, mag_ls = convert_cone_to_parallel(
            imgs, args.z_sd, z_od_ls, psize_ls, crop=not args.no_crop)
        for d, img in enumerate(imgs):
            write_tiff(img, os.path.join(
                out_dir, os.path.basename(flist[i_theta * n_dists + d])))
    np.savetxt(os.path.join(out_dir, 'z_eff_ls.txt'), z_eff_ls, fmt='%.5f')
    print(f'wrote {out_dir}; z_eff = {np.round(z_eff_ls, 4)}; '
          f'mag = {np.round(mag_ls, 3)}')
    return out_dir


if __name__ == '__main__':
    main()
