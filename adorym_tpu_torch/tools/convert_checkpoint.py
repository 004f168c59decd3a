#!/usr/bin/env python
"""Convert a port checkpoint, in the sharded form (``dcp/``, written under
``use_orbax=True``) or the npz form, to the npz form with whole arrays
(``checkpoint.npz``), which the JAX package restores into any
configuration.

    python -m adorym_tpu_torch.tools.convert_checkpoint CHECKPOINT_FOLDER
        [OUT_FOLDER]

The object, its optimizer state and the support mask are joined from
their y slabs; the parameters, the optimizer state, the counters and
``extra`` keep their keys.  ``OUT_FOLDER`` defaults to
``CHECKPOINT_FOLDER``; the port still reads its sharded form first there,
the JAX package reads the npz form.  Needs no card and no JAX.
"""

from __future__ import annotations

import argparse


def convert(folder: str, out: str = None) -> str:
    """Write ``folder``'s checkpoint as ``out/checkpoint.npz`` with whole
    arrays; returns its path."""
    from adorym_tpu_torch.io import checkpoint as ckpt_lib
    restored = ckpt_lib.restore_checkpoint(folder)
    if restored is None:
        raise FileNotFoundError(f'no checkpoint in {folder}')
    params, state, i_epoch, i_batch, extra = restored
    params = {k: ckpt_lib.deslab(v) for k, v in params.items()}
    state = ckpt_lib.deslab_obj_state(state)
    extra = {k: ckpt_lib.deslab(v) for k, v in extra.items()
             if k != 'obj_slab_rows'}
    return ckpt_lib.save_checkpoint(out or folder, params, state, i_epoch,
                                    i_batch, extra=extra)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument('folder', help='the checkpoint folder (dcp/ or '
                   'checkpoint.npz)')
    p.add_argument('out', nargs='?', default=None,
                   help='where checkpoint.npz goes (default: folder)')
    args = p.parse_args(argv)
    print('wrote:', convert(args.folder, args.out))


if __name__ == '__main__':
    main()
