"""Carry parameters, optimizer state and whole checkpoints between the JAX
package and the port.  Both keep the same layouts — obj ``[y, x, z, 2]``,
probe ``[n_modes, py, px, 2]``, the auxiliary refinables (positions,
offsets, distances, ``slice_pos_cm_ls``, ``tilt_ls``, ``prj_affine_ls``,
``ctf_lg_kappa``), Adam ``m``/``v`` per leaf, momentum ``v``, the
object's CG (``s``, ``g_old``, ``alpha_suggested``, a boolean ``first``)
or Curveball state (``z``, ``lmbda``) — so the
conversion is a change of array type and device.  Under slab offload
either package keeps the object and its moments as y slabs (``{'s00':
..., 's01': ...}``); they convert to and from whole arrays.  The optimizer
step counts are the Reconstructor's ``i_opt_batch`` and ``global_batch``,
plain ints in both packages and in a checkpoint's ``extra``.
:func:`load_checkpoint` reads either checkpoint form of the port (npz or
sharded) into a run's state, whole or by a range of object rows."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .io import checkpoint as ckpt_lib


def params_from_jax(params_np: Dict[str, Any],
                    opt_state_np: Optional[Dict[str, Dict[str, Any]]] = None,
                    device='cuda', host_obj: bool = False,
                    host_obj_state: bool = False, mesh=None
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Optional[Dict[str, Dict[str, torch.Tensor]]]]:
    """JAX-package parameters (and optimizer state: each leaf's Adam or
    momentum moments, none for GD), as numpy arrays or anything
    ``np.asarray`` takes, to float32 tensors on ``device``.  A slabbed
    object or object state (a JAX run under offload) becomes whole arrays;
    ``host_obj`` / ``host_obj_state`` keep those on the host, for a run
    that offloads them.  ``mesh``: a rank's
    :class:`~.parallel.mesh.Mesh`; the object and its state leaves (the
    JAX run's whole arrays) come out as this rank's y slab."""
    def to_t(a, dev=device):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=dev)

    def state_t(a, dev=device):
        # CG's ``first`` flag stays boolean.
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return torch.as_tensor(a, device=dev)
        return to_t(a, dev)

    def own(a, ny):
        a = np.asarray(a)
        if mesh is None or a.ndim == 0 or a.shape[0] != ny:
            return a
        st, sz = mesh.slab(ny)
        return a[st:st + sz]

    obj_np = ckpt_lib.deslab(params_np['obj']) if 'obj' in params_np \
        else None
    ny = None if obj_np is None else np.shape(obj_np)[0]
    params = {k: to_t(own(ckpt_lib.deslab(v), ny) if k == 'obj'
                      else ckpt_lib.deslab(v),
                      'cpu' if k == 'obj' and host_obj else device)
              for k, v in params_np.items()}
    if opt_state_np is None:
        return params, None
    opt_state_np = ckpt_lib.deslab_obj_state(opt_state_np)
    if 'obj' in opt_state_np:
        opt_state_np = {**opt_state_np, 'obj': {
            n: own(a, ny) for n, a in opt_state_np['obj'].items()}}
    state = {k: {n: state_t(a, 'cpu' if k == 'obj' and host_obj_state
                            else device)
                 for n, a in st.items()}
             for k, st in opt_state_np.items()}
    return params, state


def _to_numpy(v):
    if isinstance(v, dict):
        return {k: _to_numpy(a) for k, a in v.items()}
    return v.detach().cpu().numpy()


def params_to_numpy(params: Dict[str, torch.Tensor],
                    opt_state: Optional[Dict[str, Dict[str, torch.Tensor]]]
                    = None):
    """The port's parameters (and optimizer state) as numpy arrays in the
    JAX package's layouts; y slabs stay slab dicts."""
    out = _to_numpy(params)
    if opt_state is None:
        return out, None
    return out, _to_numpy(opt_state)


def load_checkpoint(folder: str, device='cuda', host_obj: bool = False,
                    host_obj_state: bool = False,
                    rows: Optional[Tuple[int, int]] = None
                    ) -> Optional[Dict[str, Any]]:
    """The checkpoint in ``folder`` (``<output_folder>/checkpoint``),
    written by either package, in the npz or the sharded form, slabbed or
    not, as the port's run state:
    ``params`` and ``opt_state`` as tensors on ``device`` (the object and
    its state as whole arrays, on the host under ``host_obj`` /
    ``host_obj_state``), the NEXT ``(i_epoch,
    i_batch)`` to run, the step counts ``i_opt_batch`` and
    ``global_batch``, and ``extra`` (the remaining numpy entries, e.g. a
    shrink-wrapped support mask); None when there is none.
    ``rows=(y0, y1)``: the object, its object-shaped state and the support
    mask come back as those rows alone (of the sharded form, only the
    slabs that overlap them are read)."""
    restored = ckpt_lib.restore_checkpoint(folder, rows=rows)
    if restored is None:
        return None
    params_np, state_np, i_epoch, i_batch, extra = restored
    params, state = params_from_jax(params_np, state_np, device=device,
                                    host_obj=host_obj,
                                    host_obj_state=host_obj_state)
    extra = {k: ckpt_lib.deslab(v) for k, v in extra.items()}
    extra.pop('obj_slab_rows', None)
    return {'params': params, 'opt_state': state,
            'i_epoch': int(i_epoch), 'i_batch': int(i_batch),
            'i_opt_batch': int(extra.pop('i_opt_batch', 0)),
            'global_batch': int(extra.pop('global_batch', 0)),
            'extra': extra}
