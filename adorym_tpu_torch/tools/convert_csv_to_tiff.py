#!/usr/bin/env python
"""Convert a CSV of complex values ``(re+imj)`` into magnitude and phase
TIFFs, on the port (the JAX package's ``tools/convert_csv_to_tiff.py``).

    python -m adorym_tpu_torch.tools.convert_csv_to_tiff dump.csv
"""

import argparse
import os
import re

import numpy as np


def convert(path):
    from adorym_tpu_torch.io.output import write_tiff
    rows = []
    with open(path) as f:
        for line in f:
            vals = re.findall(
                r'(-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)\s*([+-]\s*\d+(?:\.\d+)?'
                r'(?:[eE][+-]?\d+)?)j', line.replace(' ', ''))
            if not vals:
                continue
            rows.append(np.array([float(r) + 1j * float(i.replace(' ', ''))
                                  for r, i in vals]))
    arr = np.stack(rows)
    base = os.path.splitext(path)[0]
    return (write_tiff(np.abs(arr), base + '_mag'),
            write_tiff(np.angle(arr), base + '_phase'))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('filename')
    args = p.parse_args(argv)
    print('wrote:', convert(args.filename))


if __name__ == '__main__':
    main()
