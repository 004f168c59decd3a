#!/usr/bin/env python
"""Stitch per-rank object TIFFs (distributed-object z-slab outputs) into
full stacks, on the port (the JAX package's
``tools/stitch_distributed_objects.py``): ``*_rank_N`` slab files are
concatenated in rank order.  The port's mesh runs write one whole object
(rank 0 gathers the slabs), which the tool leaves alone; reference runs in
``distribution_mode='distributed_object'`` leave the slab files.

    python -m adorym_tpu_torch.tools.stitch_distributed_objects [FOLDER]
"""

import argparse
import glob
import os
import re

import numpy as np


def stitch(folder='.'):
    from adorym_tpu_torch.io.output import read_tiff, write_tiff
    flist_raw = glob.glob(os.path.join(folder, '*.tif*'))
    names = (('delta', 'beta') if any('delta' in f or 'beta' in f
                                      for f in flist_raw)
             else ('mag', 'phase'))
    written = []
    for name in names:
        flist = [f for f in flist_raw if name in f and 'rank' in f]
        if not flist:
            continue
        ranks = [int(re.findall(r'\d+', os.path.basename(f))[-1])
                 for f in flist]
        stack = np.concatenate(
            [np.atleast_3d(read_tiff(f))
             for f in np.asarray(flist)[np.argsort(ranks)]], axis=0)
        written.append(write_tiff(
            stack, os.path.join(folder, f'{name}_stack')))
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('folder', nargs='?', default='.')
    args = p.parse_args(argv)
    out = stitch(args.folder)
    print('wrote:', out)


if __name__ == '__main__':
    main()
