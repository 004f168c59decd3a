"""Halo exchange over the object axis (``adorym_tpu/parallel/halo.py``).

The object lives in y slabs, one a rank of the 'op' axis.  A window that
starts in a slab may reach into the next one; instead of gathering the
whole object, each rank receives the next slab's top rows (a ring shift of
a probe-height band), cuts the windows that start in its slab, and one sum
over 'op' hands every rank the whole patch stack.  The JAX package gets
the transpose from ``jax.vjp``; here each step is an autograd Function
with its backward written out: the patch cotangent (the same on every rank
of the 'op' axis) is masked to this rank's windows, added into the
extended slab, and the halo rows' part goes back to the rank that sent
them.  Each Function also carries a forward-mode rule (the maps are
linear), for the Gauss-Newton products of the second-order optimizers.

:func:`op_sum` and :func:`all_gather_obj` are the two other collectives
autograd sees.  ``op_sum`` is a sum over an axis whose result each rank
goes on to use in a computation of its own (the regularizers' sums); its
transpose sums the ranks' cotangents, and a value that every rank then
holds alike enters the backward at ``1/n`` on each rank
(:meth:`SlabShard.finish`), so that the sum of the ranks' seeds is the
value's one.  ``all_gather_obj`` gathers the whole object from its slabs
(its transpose keeps this rank's rows), the generic path's fallback where
the halo geometry does not hold.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import patches as patch_ops


# -- sums and the whole-object gather ----------------------------------------
class _OpSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return comm.all_reduce(t.detach().clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous().clone(), ctx.axes), None, \
            None

    @staticmethod
    def jvp(ctx, t, *_):
        return ctx.comm.all_reduce(t.clone(), ctx.axes)


def op_sum(t: torch.Tensor, mesh, axes=('op',)) -> torch.Tensor:
    """``t`` summed over ``axes`` (default 'op'), differentiably; the
    backward sums the ranks' cotangents (each rank's use of the sum is its
    own).  A value every rank ends up holding alike goes through
    :meth:`SlabShard.finish` before its backward."""
    if mesh is None or mesh.comm.size(axes) == 1:
        return t
    return _OpSum.apply(t, mesh.comm, tuple(axes))


class _Finish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, n):
        ctx.n = n
        return v.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None

    @staticmethod
    def jvp(ctx, t, *_):
        return t


class _AllGatherObj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slab, comm):
        ctx.comm, ctx.s = comm, slab.shape[0]
        return comm.all_gather(slab.detach(), 'op')

    @staticmethod
    def backward(ctx, g):
        k = ctx.comm.op
        return g[k * ctx.s:(k + 1) * ctx.s].contiguous(), None

    @staticmethod
    def jvp(ctx, t, *_):
        return ctx.comm.all_gather(t, 'op')


def all_gather_obj(slab: torch.Tensor, mesh) -> torch.Tensor:
    """The whole object from the 'op' ranks' y slabs, differentiably (the
    backward keeps this rank's rows of the whole object's cotangent, which
    every rank of the axis computed alike).  Recorded as an
    ``all_gather``."""
    if mesh is None or mesh.n_op == 1:
        return slab
    return _AllGatherObj.apply(slab, mesh.comm)


# -- ring extension ----------------------------------------------------------
def _extend(slab, h1, h2, comm):
    parts = []
    if h1:
        parts.append(comm.ring_shift(slab[-h1:], 'op', +1))
    parts.append(slab)
    if h2:
        parts.append(comm.ring_shift(slab[:h2], 'op', -1))
    return torch.cat(parts, 0) if len(parts) > 1 else slab


class _NeighborExtend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slab, h1, h2, comm):
        ctx.h1, ctx.h2, ctx.comm, ctx.s = h1, h2, comm, slab.shape[0]
        return _extend(slab.detach(), h1, h2, comm)

    @staticmethod
    def backward(ctx, g):
        h1, h2, s, comm = ctx.h1, ctx.h2, ctx.s, ctx.comm
        g_slab = g[h1:h1 + s].clone()
        if h1:
            g_slab[-h1:] += comm.ring_shift(g[:h1], 'op', -1)
        if h2:
            g_slab[:h2] += comm.ring_shift(g[h1 + s:], 'op', +1)
        return g_slab, None, None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _extend(t, ctx.h1, ctx.h2, ctx.comm)


def neighbor_extend(slab: torch.Tensor, h1: int, h2: int,
                    mesh) -> torch.Tensor:
    """``[previous rank's last h1 rows ; slab ; next rank's first h2 rows]``
    over the 'op' ring, differentiably: two ring shifts of a few rows (one
    where ``h1`` or ``h2`` is 0).  Circular: the edge ranks receive the
    rows of the far end, which callers mask to vacuum or never read."""
    h1, h2 = int(h1), int(h2)
    s = slab.shape[0]
    if h1 > s or h2 > s:
        raise ValueError(f'a halo of ({h1}, {h2}) rows reaches past the '
                         f'neighbouring slab of {s} rows')
    if not (h1 or h2):
        return slab
    return _NeighborExtend.apply(slab, h1, h2, mesh.comm)


# -- the halo patch gather ---------------------------------------------------
def _ownership(positions, s, k):
    pos = np.asarray(positions, dtype=np.int64)
    mine = (pos[:, 0] // s) == k
    local = np.stack([np.where(mine, pos[:, 0] - k * s, 0), pos[:, 1]], 1)
    return mine, local


def _gather_forward(slab, positions, probe_size, comm):
    py = int(probe_size[0])
    s = slab.shape[0]
    halo = comm.ring_shift(slab[:py], 'op', -1)
    ext = torch.cat([slab, halo], 0)
    mine, local = _ownership(positions, s, comm.op)
    patches = patch_ops.extract_patches(ext, local, probe_size)
    mask = torch.as_tensor(mine, device=slab.device).reshape(
        (-1,) + (1,) * (patches.dim() - 1))
    patches = torch.where(mask, patches, torch.zeros_like(patches))
    return comm.all_reduce(patches.contiguous(), 'op')


def _gather_transpose(cot, positions, probe_size, slab_shape, comm):
    """The halo gather's transpose: this rank's windows of ``cot`` added
    into its slab, the halo rows' part sent back to the next rank."""
    py = int(probe_size[0])
    s = slab_shape[0]
    mine, local = _ownership(positions, s, comm.op)
    keep = np.nonzero(mine)[0]
    g_ext = cot.new_zeros((s + py,) + tuple(slab_shape[1:]))
    if len(keep):
        idx = torch.as_tensor(keep, device=cot.device)
        patch_ops.scatter_patches_add(g_ext, cot.index_select(0, idx),
                                      local[keep])
    g_slab = g_ext[:s].clone()
    g_slab[:py] += comm.ring_shift(g_ext[s:].contiguous(), 'op', +1)
    return g_slab


class _ShardedPatchGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slab, positions, probe_size, comm):
        ctx.positions, ctx.probe_size, ctx.comm = positions, probe_size, comm
        ctx.shape = tuple(slab.shape)
        return _gather_forward(slab.detach(), positions, probe_size, comm)

    @staticmethod
    def backward(ctx, g):
        return (_gather_transpose(g, ctx.positions, ctx.probe_size,
                                  ctx.shape, ctx.comm), None, None, None)

    @staticmethod
    def jvp(ctx, t, *_):
        return _gather_forward(t, ctx.positions, ctx.probe_size, ctx.comm)


def _check_window(py: int, s: int):
    assert py <= s, ('probe taller than a shard slab — use fewer shards '
                     f'(py={py} > S={s})')


def sharded_patch_gather(obj: torch.Tensor, positions, probe_size: Tuple,
                         mesh) -> torch.Tensor:
    """``[N, py, px, ...]`` patches of an object split over 'op' on its y
    axis (``obj`` is this rank's slab of ``S`` rows; ``py <= S``), at
    integer top-left corners ``positions[N, 2]`` (host ints) in the whole
    object's frame, every window in range.  The stack comes out whole on
    every rank of the 'op' axis: one ring shift of ``py`` rows, the
    windows that start in this slab, one sum over 'op'."""
    py = int(probe_size[0])
    _check_window(py, obj.shape[0])
    if mesh.n_op == 1:
        return patch_ops.extract_patches(obj, positions, probe_size)
    return _ShardedPatchGather.apply(obj, np.asarray(positions, np.int64),
                                     tuple(int(v) for v in probe_size),
                                     mesh.comm)


def sharded_patch_scatter_add(obj: torch.Tensor, patches: torch.Tensor,
                              positions, mesh) -> torch.Tensor:
    """The explicit transpose of :func:`sharded_patch_gather`: ``obj``
    (this rank's slab) plus the patches, which every rank of the 'op' axis
    holds alike, added at ``positions``."""
    py, px = patches.shape[1:3]
    _check_window(py, obj.shape[0])
    if mesh.n_op == 1:
        return patch_ops.scatter_patches_add(obj.clone(), patches,
                                             np.asarray(positions, np.int64))
    return obj + _gather_transpose(patches, np.asarray(positions, np.int64),
                                   (py, px), tuple(obj.shape), mesh.comm)


# -- the generic path's window gather on a padded frame -------------------
def padded_geometry(ny: int, pad_arr, window_y: int, n_op: int) -> bool:
    """Whether the halo gather serves a y extent ``ny`` padded by
    ``pad_arr`` over ``n_op`` slabs (the JAX package's test: the padded
    extent divides ``n_op`` and a window fits a padded slab; here also the
    padding fits a neighbouring slab)."""
    p0, p1 = int(pad_arr[0][0]), int(pad_arr[0][1])
    y_pad = ny + p0 + p1
    return (ny % n_op == 0 and y_pad % n_op == 0
            and window_y <= y_pad // n_op and max(p0, p1) <= ny // n_op)


def padded_window_gather(slab: torch.Tensor, pad_arr, positions,
                         window: Tuple, unknown_type: str,
                         mesh) -> torch.Tensor:
    """Windows of the vacuum-padded whole object at ``positions`` (in the
    padded frame), from this rank's unpadded y slab: the x padding is
    local; the y padding re-slabs the object onto equal padded slabs by
    :func:`neighbor_extend` (rows outside the object become vacuum); then
    :func:`sharded_patch_gather`.  The geometry must pass
    :func:`padded_geometry`."""
    pad_arr = np.asarray(pad_arr, np.int64)
    p0, p1 = int(pad_arr[0][0]), int(pad_arr[0][1])
    s_u = slab.shape[0]
    ny = s_u * mesh.n_op
    s_p = (ny + p0 + p1) // mesh.n_op
    k = mesh.op
    x = patch_ops.pad_object(slab, np.array([[0, 0], pad_arr[1]]),
                             unknown_type)
    if p0 or p1:
        ext = neighbor_extend(x, p0, p1, mesh)
        start = k * (s_p - s_u)
        win = ext[start:start + s_p]
        u = k * s_p - p0 + np.arange(s_p)
        valid = (u >= 0) & (u < ny)
        if not valid.all():
            v = torch.as_tensor(valid, device=slab.device).reshape(
                (-1,) + (1,) * (win.dim() - 1))
            vac = torch.zeros_like(win)
            if unknown_type == 'real_imag':
                vac[..., 0] = 1.0
            win = torch.where(v, win, vac)
        x = win
    return sharded_patch_gather(x, positions, window, mesh)


class SlabShard:
    """What the regularizers need of an object split over 'op' (this
    rank's slab): sums over the axis (:func:`op_sum`), the previous slab's
    last rows (the ring's wrap gives the circular stencils' first row) and
    a max over the axis (no gradient)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n = mesh.n_op

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return op_sum(t, self.mesh)

    def finish(self, v: torch.Tensor) -> torch.Tensor:
        """A value every rank holds alike (a regularizer's): the same
        value, whose backward seeds each rank with ``1/n`` of the
        cotangent, so that the ranks' seeds add up to it once."""
        return _Finish.apply(v, self.n)

    def prev_rows(self, t: torch.Tensor, h: int = 1) -> torch.Tensor:
        return neighbor_extend(t, h, 0, self.mesh)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.comm.all_reduce(t.detach().clone(), 'op', op='max')
