"""Checkpoint and resume (``adorym_tpu/io/checkpoint.py``), in two forms.

The npz form: one atomic ``checkpoint.npz`` a checkpoint, holding the
parameters, the optimizer state and the loop counters under the JAX
package's flattened keys (``params/obj``, ``state/obj/m``,
``extra/i_opt_batch``, ...), so a checkpoint written by either package
restores in the other.  Under slab offload the object and its moments are
written as y slabs (``params/obj/s00``, ``state/obj/m/s00``, ...), as the
JAX package writes them; :func:`slab_order` and :func:`deslab` make whole
arrays of them again.

The sharded form (``use_orbax=True``, the JAX package's orbax checkpoint):
a ``torch.distributed.checkpoint`` folder ``dcp/`` under the same keys, in
which each rank writes its own files (``__<rank>_<i>.distcp``, one an
item) and rank 0 the ``.metadata``; nothing is gathered.  The object and
its object-shaped state leaves always go in as y slabs, each slab written
by the rank that holds it, and ``extra/obj_slab_rows`` (``[n_slabs, 2]``)
gives each slab's rows, so a reader takes a row range
(:func:`restore_sharded`'s ``rows``) from the slabs that overlap it
without knowing the writer's mesh.  Every
rank writes into ``dcp.tmp/``; after a barrier rank 0 moves the old
``dcp/`` aside, the new one into place and removes the old one, so a
crash before that leaves the previous checkpoint as the one that
restores.  The JAX package's orbax folders (tensorstore's format) raise on
restore, naming the converter ``tools/orbax_to_npz.py``."""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import time
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np

#: The sharded form's folder under the checkpoint folder, the folder a
#: write fills before its commit, and the one a commit moves aside.
DCP, DCP_TMP, DCP_OLD = 'dcp', 'dcp.tmp', 'dcp.old'

#: Where each slab of a sharded checkpoint lies along y.
SLAB_ROWS = 'extra/obj_slab_rows'

_ORBAX = ('a JAX orbax checkpoint (checkpoint/orbax/, tensorstore\'s '
          'format) cannot be read by the port: convert it to the npz form '
          'with tools/orbax_to_npz.py where JAX and orbax are installed '
          '(python tools/orbax_to_npz.py CHECKPOINT_FOLDER)')

_SLAB_KEY = re.compile(r'^(.*)/(s\d+)$')


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


def _split(flat):
    """``(params, state, i_epoch, i_batch, extra)`` of a flat checkpoint."""
    i_epoch = int(flat.pop('__i_epoch'))
    i_batch = int(flat.pop('__i_batch'))
    tree = _unflatten(flat)
    return (tree.get('params', {}), tree.get('state', {}), i_epoch, i_batch,
            tree.get('extra', {}))


def save_checkpoint(folder: str, params: Dict[str, Any],
                    opt_state: Dict[str, Any], i_epoch: int, i_batch: int,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write the npz form atomically (a temporary file, then a rename).
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


# -- the sharded form ---------------------------------------------------------

@contextlib.contextmanager
def _quiet():
    """``torch.distributed.checkpoint`` warns on every call made outside a
    process group that it assumes one process, which is what ``no_dist``
    asks for."""
    with warnings.catch_warnings():
        warnings.filterwarnings('ignore', message='torch.distributed is '
                                'disabled, unavailable or uninitialized')
        yield


def _tensor(v):
    """``v`` as a tensor to write.  A host view of a larger block (an
    offloaded slab) becomes a tensor over its own bytes of the same memory:
    ``torch.distributed.checkpoint`` copies a tensor whose storage is
    larger than itself and holds each copy until its file is closed."""
    import torch
    if not torch.is_tensor(v):
        return torch.as_tensor(np.asarray(v))
    v = v.detach()
    if (v.device.type == 'cpu' and v.is_contiguous()
            and v.untyped_storage().nbytes() != v.nbytes
            and v.dtype != torch.bfloat16):
        v = torch.from_numpy(v.numpy())
    return v


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _prepare(folder):
    """An empty ``dcp.tmp/`` under ``folder`` (a write that a crash left
    uncommitted goes)."""
    tmp = os.path.join(folder, DCP_TMP)
    os.makedirs(folder, exist_ok=True)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)


def _commit(folder):
    """The written ``dcp.tmp/`` becomes ``dcp/``: the old one moves aside
    first and goes last."""
    tmp, final, old = (os.path.join(folder, n)
                       for n in (DCP_TMP, DCP, DCP_OLD))
    if os.path.isdir(final):
        shutil.rmtree(old, ignore_errors=True)
        os.replace(final, old)
    os.replace(tmp, final)
    _fsync_dir(folder)
    shutil.rmtree(old, ignore_errors=True)


def _step(comm, work, what):
    """``work()`` on this rank (None: nothing here), then a barrier at which
    every rank learns whether it failed on any rank: a failure raises on
    every rank, so that none waits at a later barrier for a rank that has
    left."""
    err = None
    if work is not None:
        try:
            work()
        except Exception as e:                          # noqa: BLE001
            err = e
    if comm is not None and comm.barrier(failed=err is not None):
        if err is None:
            raise RuntimeError(f'sharded checkpoint: {what} failed on '
                               'another rank')
    if err is not None:
        raise err


def save_sharded(folder: str, items: Dict[str, Any], i_epoch: int,
                 i_batch: int, extra: Optional[Dict[str, Any]] = None,
                 comm=None) -> str:
    """Write this rank's share of a sharded checkpoint under ``folder``
    (``<output_folder>/checkpoint``) and commit it; every rank of the
    process group calls it.  ``items``: this rank's leaves by flattened
    key (``params/obj/s01``, ``params/probe``, ...), tensors on any device
    or arrays, each written as it is (a host tensor from its own memory, a
    device tensor brought down by itself, into its own file); no key may
    be written by two ranks.  ``extra`` (``extra/...`` keys) and the
    counters ``(i_epoch, i_batch)``, the NEXT batch to run, are rank 0's.
    ``comm``: the mesh's :class:`~..parallel.comm.Comm`, or None for one
    process.  Three steps, each closed by a counted barrier: rank 0 empties
    ``dcp.tmp/``, every rank writes (``dcp.save``, whose own plan exchange
    over the process group is counted as one ``dcp_save``, its bytes not
    measured), rank 0 commits.  A step that fails on any rank raises on
    every rank and commits nothing.  Returns the committed folder."""
    import torch
    import torch.distributed.checkpoint as dcp
    lead = comm is None or comm.rank == 0
    tmp = os.path.join(folder, DCP_TMP)
    state = {}

    def prepare():
        state.update({k: _tensor(v) for k, v in items.items()})
        if lead:
            state['__i_epoch'] = torch.tensor(int(i_epoch))
            state['__i_batch'] = torch.tensor(int(i_batch))
            state.update({k: _tensor(v) for k, v in
                          _flatten(extra or {}, 'extra/').items()})
            _prepare(folder)

    def write():
        t0 = time.perf_counter()
        with _quiet():
            # A file an item: the writer holds each item's host copy (a
            # device slab's) until its file is closed.
            dcp.save(state, storage_writer=dcp.FileSystemWriter(
                tmp, single_file_per_rank=False), no_dist=comm is None)
        if comm is not None:
            comm.note('dcp_save', time.perf_counter() - t0)

    _step(comm, prepare, 'preparing the write')
    _step(comm, write, 'the write')
    _step(comm, (lambda: _commit(folder)) if lead else None, 'the commit')
    return os.path.join(folder, DCP)


def sharded_path(folder: str) -> Optional[str]:
    """The committed sharded checkpoint under ``folder``: ``dcp/``, or
    ``dcp.old/`` where a commit stopped between its two renames; None
    when there is neither (``dcp.tmp/`` never counts)."""
    for name in (DCP, DCP_OLD):
        path = os.path.join(folder, name)
        if os.path.isfile(os.path.join(path, '.metadata')):
            return path
    return None


def drop_sharded(folder: str):
    """Remove the sharded form under ``folder``: a restore reads it before
    the npz form, so an older one would shadow a newer npz checkpoint."""
    for name in (DCP, DCP_OLD, DCP_TMP):
        shutil.rmtree(os.path.join(folder, name), ignore_errors=True)


def _read(path, meta, keys) -> Dict[str, np.ndarray]:
    """The leaves ``keys`` of the sharded checkpoint at ``path``, each
    read into a host tensor of its own, as numpy arrays."""
    import torch
    import torch.distributed.checkpoint as dcp
    if not keys:
        return {}
    state = {k: torch.empty(tuple(meta[k].size),
                            dtype=meta[k].properties.dtype) for k in keys}
    with _quiet():
        dcp.load(state, storage_reader=dcp.FileSystemReader(path),
                 no_dist=True)
    return {k: v.numpy() for k, v in state.items()}


def _cut(a, lo, hi, y0, y1):
    """Rows ``[y0, y1)`` of a slab that holds rows ``[lo, hi)``."""
    return a[max(y0, lo) - lo:min(y1, hi) - lo]


def restore_sharded(folder: str, rows: Optional[Tuple[int, int]] = None):
    """``(params, opt_state, i_epoch, i_batch, extra)`` of the committed
    sharded checkpoint under ``folder`` as numpy trees, or None when
    there is none.  Slabbed leaves come back as slab dicts (``{'s00':
    ...}``, :func:`deslab` joins them).  ``rows=(y0, y1)``: only the slabs
    that overlap those object rows are read, each cut to them (a slab with
    no such rows is left out)."""
    import torch.distributed.checkpoint as dcp
    path = sharded_path(folder)
    if path is None:
        return None
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    flat = _read(path, meta, [k for k in meta if not _SLAB_KEY.match(k)])
    table = flat.get(SLAB_ROWS)
    slabs = []
    for k in meta:
        m = _SLAB_KEY.match(k)
        if not m:
            continue
        if table is None:
            raise ValueError(f'{path}: slab {k} without {SLAB_ROWS}')
        lo, hi = (int(v) for v in table[int(m.group(2)[1:])])
        if rows is None or (lo < rows[1] and rows[0] < hi):
            slabs.append((k, lo, hi))
    got = _read(path, meta, [k for k, _, _ in slabs])
    for k, lo, hi in slabs:
        flat[k] = got[k] if rows is None else _cut(got[k], lo, hi, *rows)
    return _split(flat)


# -- either form ---------------------------------------------------------------

def cut_rows(params, state, extra, rows):
    """The object's rows ``[y0, y1)`` of a whole checkpoint (the npz
    form): the object, its object-shaped state leaves and the support
    mask, each joined from its slabs first; anything else as it is."""
    y0, y1 = rows
    obj = deslab(params['obj'])
    params = {**params, 'obj': obj[y0:y1]}
    if isinstance(state.get('obj'), dict):
        state = {**state, 'obj': {
            n: (a[y0:y1] if np.shape(a) == obj.shape else a)
            for n, a in deslab_obj_state(state)['obj'].items()}}
    mask = deslab(extra.get('finite_support_mask'))
    if mask is not None and np.shape(mask) == obj.shape[:3]:
        extra = {**extra, 'finite_support_mask': mask[y0:y1]}
    return params, state, extra


def restore_checkpoint(folder: str, rows: Optional[Tuple[int, int]] = None):
    """``(params, opt_state, i_epoch, i_batch, extra)`` as numpy trees, or
    None when the folder holds no checkpoint.  The sharded form is read
    where it is committed (before the npz form, as the JAX package reads
    orbax first; a run's npz checkpoint removes an older sharded one,
    :func:`drop_sharded`); a JAX orbax folder alone raises, naming the
    converter.
    ``rows=(y0, y1)``: the object's leaves cut to those rows (only the
    overlapping slabs are read from the sharded form)."""
    if sharded_path(folder) is not None:
        return restore_sharded(folder, rows=rows)
    npath = os.path.join(folder, 'checkpoint.npz')
    if not os.path.exists(npath):
        if os.path.isdir(os.path.join(folder, 'orbax')):
            raise NotImplementedError(_ORBAX)
        return None
    with np.load(npath, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    params, state, i_epoch, i_batch, extra = _split(flat)
    if rows is not None:
        params, state, extra = cut_rows(params, state, extra, rows)
    return params, state, i_epoch, i_batch, extra
