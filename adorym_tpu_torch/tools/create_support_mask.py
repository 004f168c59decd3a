#!/usr/bin/env python
"""Create a finite-support mask TIFF (sphere or cylinder) for an object of
the given size, on the port (the JAX package's
``tools/create_support_mask.py``).  The mask is made on the host, so the
JAX tool's ``--platform`` has no counterpart here.

    python -m adorym_tpu_torch.tools.create_support_mask --out mask \\
        --obj-size 64 64 64 --radius 24
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--out', required=True)
    p.add_argument('--obj-size', nargs=3, type=int, required=True)
    p.add_argument('--shape', choices=['sphere', 'cylinder'],
                   default='sphere')
    p.add_argument('--radius', type=float, required=True)
    args = p.parse_args(argv)

    from adorym_tpu_torch.io.output import write_tiff
    from adorym_tpu_torch.ops.image import generate_disk, generate_sphere

    Y, X, Z = args.obj_size
    if args.shape == 'sphere':
        mask = generate_sphere((Y, X, Z), args.radius, anti_aliasing=2)
    else:
        disk = generate_disk((Y, X), args.radius)
        mask = np.repeat(disk[:, :, None], Z, axis=2)
    mask = (mask > 0.5).astype(np.float32)
    # z-major stack for TIFF (matches the reference's mask.tiff convention)
    path = write_tiff(np.moveaxis(mask, -1, 0), args.out)
    print(f'wrote {path}: support fraction {mask.mean():.3f}')
    return path


if __name__ == '__main__':
    main()
