"""Checkpoint and resume (``adorym_tpu/io/checkpoint.py``, its npz form):
one atomic ``checkpoint.npz`` a checkpoint, holding the parameters, the
optimizer state and the loop counters under the JAX package's flattened
keys (``params/obj``, ``state/obj/m``, ``extra/i_opt_batch``, ...), so a
checkpoint written by either package restores in the other.  Under slab
offload the object and its moments are written as y slabs
(``params/obj/s00``, ``state/obj/m/s00``, ...), as the JAX package writes
them; :func:`slab_order` and :func:`deslab` make whole arrays of them
again.  An orbax checkpoint (a JAX library's format) raises on restore."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

_ORBAX = ('orbax checkpoints (use_orbax=True) are a JAX library\'s format; '
          'the port writes and reads the npz form only')


def slab_order(keys):
    """Slab keys in numeric order (``s2`` before ``s10``: a lexicographic
    sort scrambles them past 100 slabs)."""
    return sorted(keys, key=lambda k: int(k[1:]))


def is_slabbed(v) -> bool:
    """Whether ``v`` is a dict of y slabs (``{'s00': ..., ...}``)."""
    return (isinstance(v, dict) and bool(v)
            and all(k.startswith('s') and k[1:].isdigit() for k in v))


def deslab(v):
    """A dict of y slabs as one array along y; anything else as it is."""
    if not is_slabbed(v):
        return v
    return np.concatenate([np.asarray(v[k]) for k in slab_order(v)], axis=0)


def deslab_obj_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """The object's optimizer state with each slabbed leaf (written under
    slab offload) made one array again."""
    if not isinstance(state.get('obj'), dict):
        return state
    return {**state, 'obj': {k: deslab(v) for k, v in state['obj'].items()}}


def _flatten(tree: Dict[str, Any], prefix: str = '') -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f'{prefix}{k}'
        if isinstance(v, dict):
            flat.update(_flatten(v, key + '/'))
        else:
            flat[key] = np.asarray(v)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split('/')
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(folder: str, params: Dict[str, Any],
                    opt_state: Dict[str, Any], i_epoch: int, i_batch: int,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write the checkpoint atomically (a temporary file, then a rename).
    ``(i_epoch, i_batch)`` is the NEXT batch to run.  Values are numpy
    arrays or anything ``np.asarray`` takes."""
    os.makedirs(folder, exist_ok=True)
    payload = {'__i_epoch': np.asarray(i_epoch),
               '__i_batch': np.asarray(i_batch)}
    payload.update(_flatten(params, 'params/'))
    payload.update(_flatten(opt_state, 'state/'))
    if extra:
        payload.update(_flatten(extra, 'extra/'))
    tmp = os.path.join(folder, 'checkpoint.npz.tmp')
    final = os.path.join(folder, 'checkpoint.npz')
    with open(tmp, 'wb') as f:
        np.savez(f, **payload)
    os.replace(tmp, final)
    return final


def restore_checkpoint(folder: str):
    """``(params, opt_state, i_epoch, i_batch, extra)`` as numpy trees, or
    None when the folder holds no checkpoint."""
    npath = os.path.join(folder, 'checkpoint.npz')
    if not os.path.exists(npath):
        if os.path.isdir(os.path.join(folder, 'orbax')):
            raise NotImplementedError(_ORBAX)
        return None
    with np.load(npath, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    i_epoch = int(flat.pop('__i_epoch'))
    i_batch = int(flat.pop('__i_batch'))
    tree = _unflatten(flat)
    return (tree.get('params', {}), tree.get('state', {}), i_epoch, i_batch,
            tree.get('extra', {}))
