"""Probe-footprint patch extraction, the scatter of any scan table's
patches, and the complete-grid and one-row scatters and gather.

Counterpart of ``adorym_tpu/ops/patches.py``.  Object layout:
``obj[y, x, z, 2]`` (delta/beta channels last).  Scan positions are host
numpy tables here (the JAX package traces them), so windows are
computed and checked on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_scatter_grid as _csg


def calculate_pad(obj_size_yx, probe_pos, probe_size) -> np.ndarray:
    """Static padding ``[[top, bottom], [left, right]]`` so that every
    ``[pos, pos + probe_size)`` window is in range."""
    probe_pos = np.asarray(probe_pos)
    pad_arr = np.zeros((2, 2), dtype=np.int64)
    for ax in range(2):
        lo = int(np.floor(probe_pos[:, ax].min()))
        hi = int(np.ceil(probe_pos[:, ax].max())) + int(probe_size[ax])
        if lo < 0:
            pad_arr[ax, 0] = -lo
        if hi > int(obj_size_yx[ax]):
            pad_arr[ax, 1] = hi - int(obj_size_yx[ax])
    return pad_arr


def pad_object(obj, pad_arr, unknown_type='delta_beta'):
    """Pad ``obj[y, x, ...]`` by ``pad_arr`` with vacuum: 0 for delta_beta;
    (1, 0) for real_imag."""
    if not np.count_nonzero(pad_arr):
        return obj
    t, b = (int(v) for v in pad_arr[0])
    l, r = (int(v) for v in pad_arr[1])
    shape = (obj.shape[0] + t + b, obj.shape[1] + l + r) + tuple(obj.shape[2:])
    out = obj.new_zeros(shape)
    if unknown_type == 'real_imag':
        out[..., 0] = 1.0
    out[t:t + obj.shape[0], l:l + obj.shape[1]] = obj
    return out


def _window_index(positions, probe_size, dims, device):
    """Row and column index grids ``[N, py]``, ``[N, px]`` of the windows
    at integer ``positions[N, 2]`` in a ``dims`` plane, with the JAX
    package's ``dynamic_slice`` semantics for starts out of range: a
    negative start counts from the end, then starts clamp so the window
    fits."""
    dims = np.asarray(dims, dtype=np.int64)
    pos = np.asarray(positions, dtype=np.int64)
    pos = np.where(pos < 0, pos + dims, pos)
    pos = np.clip(pos, 0, dims - np.asarray(probe_size, dtype=np.int64))
    iy = pos[:, :1] + np.arange(int(probe_size[0]))
    ix = pos[:, 1:] + np.arange(int(probe_size[1]))
    return (torch.from_numpy(iy).to(device), torch.from_numpy(ix).to(device))


def extract_patches(obj, positions, probe_size):
    """``[N, py, px, ...]`` sub-blocks of ``obj[y, x, ...]`` at integer
    ``positions[N, 2]`` (host ints); trailing axes ride along whole."""
    iy, ix = _window_index(positions, probe_size, obj.shape[:2], obj.device)
    return obj[iy[:, :, None], ix[:, None, :]]


def extract_patches_zmajor(obj_zm, positions, probe_size):
    """Z-major :func:`extract_patches`: ``obj_zm`` is the padded object
    pre-transposed to ``[zb, 2, Yp, Xp]``, and the stack comes out as
    ``[zb, 2, N, py, px]`` — the multislice kernel's operand layout.
    Values equal ``movedim(extract_patches(obj, pos), (-2, -1), (0, 1))``."""
    iy, ix = _window_index(positions, probe_size, obj_zm.shape[2:4],
                           obj_zm.device)
    return obj_zm[:, :, iy[:, :, None], ix[:, None, :]]


def scatter_patches_add(acc, patches, positions):
    """Add ``patches[N, py, px, ...]`` into ``acc[y, x, ...]`` in place at
    integer ``positions[N, 2]`` (host ints) and return ``acc``: the
    transpose of :func:`extract_patches`, for any scan table
    (``patches.py:387`` of the JAX package).  Starts out of range follow
    the gather's semantics (:func:`_window_index`).  The patches are added
    in ``acc``'s dtype by one ``index_add_`` over the flattened windows:
    overlapping windows sum in another order than the JAX package's
    patch-by-patch loop (and, on CUDA, by atomics, in no fixed order)."""
    n, py, px = patches.shape[:3]
    iy, ix = _window_index(positions, (py, px), acc.shape[:2], acc.device)
    site = (iy[:, :, None] * acc.shape[1] + ix[:, None, :]).reshape(-1)
    flat = acc.view((acc.shape[0] * acc.shape[1], -1))
    flat.index_add_(0, site, patches.reshape(n * py * px, -1).to(acc.dtype))
    return acc


def extract_patches_vacuum(obj, positions, probe_size,
                           unknown_type='delta_beta'):
    """:func:`extract_patches` for windows that may reach past the edge of
    ``obj[y, x, ...]``: what lies outside is vacuum, 0 (delta_beta) or
    (1, 0) (real_imag), as in the reference's off-edge chunk reads.  The
    gradient of the vacuum part is dropped.  ``positions[N, 2]``: host
    ints, any range."""
    py, px = int(probe_size[0]), int(probe_size[1])
    pos = np.asarray(positions, dtype=np.int64)
    iy = pos[:, :1] + np.arange(py)
    ix = pos[:, 1:] + np.arange(px)
    valid = (((iy >= 0) & (iy < obj.shape[0]))[:, :, None]
             & ((ix >= 0) & (ix < obj.shape[1]))[:, None, :])
    dev = obj.device
    iy = torch.from_numpy(np.clip(iy, 0, obj.shape[0] - 1)).to(dev)
    ix = torch.from_numpy(np.clip(ix, 0, obj.shape[1] - 1)).to(dev)
    patch = obj[iy[:, :, None], ix[:, None, :]]
    if valid.all():
        return patch
    valid = torch.from_numpy(valid).to(dev).reshape(
        valid.shape + (1,) * (obj.dim() - 2))
    vac = torch.zeros_like(patch)
    if unknown_type == 'real_imag':
        vac[..., 0] = 1.0
    return torch.where(valid, patch, vac)


def detect_row_grid(pos_table, minibatch_size, probe_size):
    """Stride when every minibatch of the static scan table is one
    constant-stride grid row (same y, x = x0 + s*j, ``s`` dividing the
    probe width), else None."""
    pos = np.round(np.asarray(pos_table)).astype(np.int64)
    if pos.ndim != 2 or len(pos) == 0 or len(pos) % minibatch_size:
        return None
    if minibatch_size < 2:
        return None
    strides = set()
    for b0 in range(0, len(pos), minibatch_size):
        batch = pos[b0:b0 + minibatch_size]
        if not np.all(batch[:, 0] == batch[0, 0]):
            return None
        dx = np.diff(batch[:, 1])
        if not (np.all(dx == dx[0]) and dx[0] > 0):
            return None
        strides.add(int(dx[0]))
    if len(strides) != 1:
        return None
    s = strides.pop()
    if s > int(probe_size[1]) or int(probe_size[1]) % s:
        return None
    return s


def detect_row_grid_ragged(pos_table, minibatch_size, probe_size):
    """:func:`detect_row_grid` that also takes a final partial row: the
    full rows must pass the strict check and the tail must be one run at
    the same stride (one spot passes as it is).  Returns ``(stride,
    n_last)``, ``n_last`` the spots of the last row (``minibatch_size``
    when the table divides), or None."""
    pos = np.round(np.asarray(pos_table)).astype(np.int64)
    if pos.ndim != 2 or len(pos) == 0 or minibatch_size < 2:
        return None
    n_full = len(pos) // minibatch_size
    n_last = len(pos) - n_full * minibatch_size
    if n_full == 0:
        return None
    s = detect_row_grid(pos[:n_full * minibatch_size], minibatch_size,
                        probe_size)
    if s is None:
        return None
    if n_last == 0:
        return s, minibatch_size
    tail = pos[n_full * minibatch_size:]
    if not np.all(tail[:, 0] == tail[0, 0]):
        return None
    if n_last >= 2 and not np.all(np.diff(tail[:, 1]) == s):
        return None
    return s, n_last


def detect_full_grid(pos_table, minibatch_size, probe_size):
    """Stride when the static scan table is one complete 2D constant-stride
    grid (rows at the same stride in y, one x base, the stride dividing
    both probe dims), else None."""
    s = detect_row_grid(pos_table, minibatch_size, probe_size)
    if s is None:
        return None
    pos = np.round(np.asarray(pos_table)).astype(np.int64)
    y0s = pos[::minibatch_size, 0]
    x0s = pos[::minibatch_size, 1]
    if len(y0s) < 2 or not np.all(x0s == x0s[0]):
        return None
    if not np.all(np.diff(y0s) == s):
        return None
    if int(probe_size[0]) % s:
        return None
    return s


# The JAX package's names for the grid scatter and gather, kept so a reader
# finds the counterparts here.  All live in cuda_scatter_grid, which makes
# the device choice (the kernel on CUDA, its plain version on the CPU); the
# scatters update ``acc`` in place.  The gather takes grids whose footprint
# lies inside the object, which the Reconstructor's padding guarantees.
scatter_grid2d_add = _csg.scatter_grid2d_add_plain
scatter_grid2d_add_best = _csg.scatter_grid2d_add
scatter_rowgrid_add = _csg.scatter_rowgrid_add
extract_grid2d_best = _csg.extract_grid2d
