"""The device mesh and its layout (``adorym_tpu/parallel/mesh.py``).

Two axes, as in the JAX package:

  'dp' splits the minibatch of scan positions: each rank runs its share
       and the gradients and losses are summed over 'dp' (the reference's
       ``comm.allreduce``);
  'op' splits the object's y extent into slabs, one a rank (the
       reference's distributed-object mode); what crosses a slab boundary
       moves by ring shifts of a few rows or sums over 'op'.

'dp' is the outer axis: rank = dp * object_axis + op.  A :class:`Mesh` is
this rank's view of it (its coordinates, its device and its
:class:`~.comm.Comm`); every rank holds one, made by :func:`make_mesh` at
the same point of the program.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ParallelConfig
from .comm import Comm


class Mesh:
    """This rank's place in the (dp, op) mesh: ``n_dp``, ``n_op``, its
    coordinates ``dp``, ``op``, its ``device`` and its ``comm``."""

    def __init__(self, comm: Comm, pcfg: ParallelConfig):
        self.comm = comm
        self.pcfg = pcfg
        self.n_dp, self.n_op = comm.n_dp, comm.n_op
        self.dp, self.op = comm.dp, comm.op
        self.device = comm.device

    @property
    def rank(self) -> int:
        return self.comm.rank

    def slab(self, ny: int) -> Tuple[int, int]:
        """``(start, size)`` of this rank's rows of a y extent ``ny``
        split over 'op' (``ny`` divisible by ``object_axis``)."""
        if ny % self.n_op:
            raise ValueError(f'the object y extent {ny} does not split '
                             f'into object_axis={self.n_op} slabs')
        s = ny // self.n_op
        return self.op * s, s


def make_mesh(pcfg: ParallelConfig, device=None) -> Mesh:
    """The (dp, op) mesh over the process group, which must hold exactly
    ``data_axis * object_axis`` ranks.  ``device``: this rank's device
    (default :func:`.bootstrap.local_device`)."""
    from .bootstrap import local_device
    dev = local_device(device)
    return Mesh(Comm(pcfg.data_axis, pcfg.object_axis, dev), pcfg)


def param_specs(params: Dict[str, Any],
                pcfg: ParallelConfig) -> Dict[str, Tuple]:
    """Each leaf's split: the object over 'op' on its y axis (``('op',)``)
    where ``object_axis > 1``; every other leaf whole on every rank
    (``()``) — they are small and every step reads them."""
    return {k: ((pcfg.axis_names[1],) if k == 'obj' and pcfg.object_axis > 1
                else ()) for k in params}


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's share of whole parameters (numpy or tensors): its y
    slab of the object, every other leaf as it is."""
    specs = param_specs(params, mesh.pcfg)
    out = {}
    for k, v in params.items():
        if specs[k]:
            st, sz = mesh.slab(int(v.shape[0]))
            v = v[st:st + sz]
        out[k] = v
    return out


def batch_specs(pcfg: ParallelConfig, minibatch_size: int = 0) -> bool:
    """Whether a minibatch of ``minibatch_size`` splits over 'dp': where
    ``data_axis`` divides it; else every rank runs the whole batch (the
    JAX package's replicated batch, e.g. the flagship's 23-wide rows; the
    structured mesh paths pad those rows instead)."""
    return minibatch_size % max(1, pcfg.data_axis) == 0


def dp_share(n: int, mesh: Mesh) -> Optional[slice]:
    """This rank's slice of a batch of ``n`` items, or None when
    ``data_axis`` does not divide ``n`` (the batch stays whole)."""
    if mesh.n_dp == 1 or not batch_specs(mesh.pcfg, n):
        return None
    m = n // mesh.n_dp
    return slice(mesh.dp * m, (mesh.dp + 1) * m)


def shard_batch(batch: Dict[str, Any], measured, mesh: Mesh):
    """This rank's share of a batch dict (``pos_batch``, ``ind_batch``)
    and of its measured rows: the dp share where ``data_axis`` divides the
    batch, else all of it."""
    n = int(np.shape(batch['ind_batch'])[0])
    sl = dp_share(n, mesh)
    if sl is None:
        return batch, measured
    batch = {k: (v[sl] if k in ('pos_batch', 'ind_batch') else v)
             for k, v in batch.items()}
    return batch, measured[sl]


def gather_obj(slab: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The whole object from the ranks' y slabs (every rank calls it)."""
    if mesh is None or mesh.n_op == 1:
        return slab
    return mesh.comm.all_gather(slab, 'op')
