#!/usr/bin/env python
"""Convert a JAX package orbax checkpoint (``<output_folder>/checkpoint/
orbax/``, written under ``use_orbax=True``) to the npz form
(``checkpoint.npz``), which both packages restore, the PyTorch port
(``adorym_tpu_torch``) among them.

    python tools/orbax_to_npz.py CHECKPOINT_FOLDER [OUT_FOLDER]

Runs where JAX and orbax are installed, through the JAX package's own
``restore_checkpoint`` and ``save_checkpoint(use_orbax=False)``: the same
parameters, optimizer state, counters and ``extra``, gathered to the host.
``OUT_FOLDER`` defaults to ``CHECKPOINT_FOLDER``; the JAX package still
reads its orbax folder first there, the port reads the npz form.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))


def convert(folder: str, out: str = None) -> str:
    """Write ``folder``'s orbax checkpoint as ``out/checkpoint.npz``;
    returns its path."""
    from adorym_tpu.io import checkpoint as ckpt_lib
    if not os.path.isdir(os.path.join(folder, 'orbax')):
        raise FileNotFoundError(f'no orbax checkpoint in {folder}')
    params, state, i_epoch, i_batch, extra = ckpt_lib.restore_checkpoint(
        folder)
    return ckpt_lib.save_checkpoint(out or folder, params, state, i_epoch,
                                    i_batch, extra=extra, use_orbax=False)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument('folder', help='the checkpoint folder holding orbax/')
    p.add_argument('out', nargs='?', default=None,
                   help='where checkpoint.npz goes (default: folder)')
    args = p.parse_args(argv)
    print('wrote:', convert(args.folder, args.out))


if __name__ == '__main__':
    main()
