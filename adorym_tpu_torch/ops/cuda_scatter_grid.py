"""Complete-grid scatter-add of patch cotangents: the CUDA kernel
``csrc/grid_scatter.cu`` and its plain PyTorch version.

Counterpart of ``adorym_tpu/ops/pallas_scatter_grid.py``: the kernel
replaces the band kernel behind ``grid2d_tile`` (``:68``) together with the
accumulator update of ``scatter_grid2d_add_pallas`` (``:182``).  Patch
``(r, j)`` of a ``rows x cols`` grid, ``cot[r*cols + j, py, px, ...]``,
is added at ``(y0 + r*stride, x0 + j*stride)`` of ``acc[Y, X, ...]``.
Cotangents may be f32 or bf16; the sums and the accumulator are f32.

Unlike the JAX package, which returns a new accumulator
(``dynamic_update_slice``), :func:`scatter_grid2d_add` updates ``acc`` IN
PLACE and returns it: the accumulator is the size of the padded object and
is touched once per gradient chunk.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.cuda_build import Kernel, ptr

_I = ctypes.c_int
_P = ctypes.c_void_p
K2 = Kernel('grid_scatter.cu', 'k2_grid_scatter_add',
            [_I, _I, _P, _P] + [_I] * 9)


def check_supported(cot_shape, stride, rows):
    """Raise ``ValueError`` unless ``cot_shape`` is a complete
    ``rows x cols`` grid of patches whose sides the stride divides."""
    n, py, px = cot_shape[:3]
    if stride <= 0 or py % stride or px % stride:
        raise ValueError(f'stride {stride} must divide the patch size '
                         f'{py}x{px}')
    if rows <= 0 or n % rows:
        raise ValueError(f'{n} patches do not form {rows} complete rows')


def tile_shape(cot_shape, stride, rows):
    """``(Ty, Tx)`` of the grid's footprint."""
    n, py, px = cot_shape[:3]
    cols = n // rows
    return (rows - 1) * stride + py, (cols - 1) * stride + px


def grid2d_tile_plain(cot, stride, rows, out_dtype=None):
    """Plain version of the tile: ``[Ty, Tx, ...]`` with patch ``(r, j)``
    added at ``(r*stride, j*stride)``, built by the separable lane
    decomposition of ``patches.scatter_grid2d_add`` (lane ``b`` of patch
    ``i`` lands at grid slot ``i + b``, first along x, then along y).
    Sums run in ``out_dtype`` (default ``cot.dtype``)."""
    out_dtype = cot.dtype if out_dtype is None else out_dtype
    check_supported(cot.shape, stride, rows)
    n, py, px = cot.shape[:3]
    trailing = tuple(cot.shape[3:])
    cols = n // rows
    kx, ky = px // stride, py // stride
    z = cot.reshape((rows, cols, py, kx, stride) + trailing)
    cx = cols + kx - 1
    xsum = torch.zeros((rows, cx, py, stride) + trailing, dtype=out_dtype,
                       device=cot.device)
    for b in range(kx):
        xsum[:, b:b + cols] += z[:, :, :, b].to(out_dtype)
    zy = xsum.reshape((rows, cx, ky, stride, stride) + trailing)
    ry = rows + ky - 1
    ysum = torch.zeros((ry, cx, stride, stride) + trailing, dtype=out_dtype,
                       device=cot.device)
    for b in range(ky):
        ysum[b:b + rows] += zy[:, :, b]
    tile = ysum.movedim(2, 1)                     # [Ry, s, Cx, s, ...]
    return tile.reshape((ry * stride, cx * stride) + trailing)


def scatter_grid2d_add_plain(acc, cot, y0, x0, stride, rows):
    """Plain version of the whole operation, in place on ``acc``."""
    tile = grid2d_tile_plain(cot, stride, rows, out_dtype=acc.dtype)
    ty, tx = tile.shape[:2]
    acc[y0:y0 + ty, x0:x0 + tx] += tile
    return acc


def _check_cuda_operands(acc, cot, y0, x0, stride, rows):
    check_supported(cot.shape, stride, rows)
    if acc.dtype != torch.float32 or not acc.is_contiguous():
        raise ValueError('acc must be a contiguous float32 tensor')
    if cot.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'cot must be float32 or bfloat16, got {cot.dtype}')
    if not cot.is_cuda or cot.device != acc.device:
        raise ValueError('acc and cot must share a CUDA device')
    if tuple(cot.shape[3:]) != tuple(acc.shape[2:]):
        raise ValueError(f'trailing dims differ: cot {tuple(cot.shape)}, '
                         f'acc {tuple(acc.shape)}')
    ty, tx = tile_shape(cot.shape, stride, rows)
    if ty > 65535:
        raise ValueError(f'tile height {ty} exceeds the launch grid')
    if not (0 <= y0 and y0 + ty <= acc.shape[0]
            and 0 <= x0 and x0 + tx <= acc.shape[1]):
        raise ValueError(f'tile {ty}x{tx} at ({y0}, {x0}) leaves the '
                         f'accumulator {tuple(acc.shape[:2])}')


def _channel_major(cot) -> bool:
    """Whether ``cot[N, py, px, *tr]`` is a view of contiguous
    ``[*tr, N, py, px]`` memory (the z-major patch gradient)."""
    trail = tuple(range(3, cot.dim()))
    return (not cot.is_contiguous()
            and cot.movedim(trail, tuple(range(len(trail)))).is_contiguous())


def scatter_grid2d_add(acc, cot, y0, x0, stride, rows):
    """Add the complete-grid patch cotangents ``cot[N, py, px, *tr]`` into
    ``acc[Y, X, *tr]`` in place and return ``acc``.  CUDA tensors launch
    the kernel, which reads ``cot`` in place when it is contiguous or a
    view of contiguous ``[*tr, N, py, px]`` memory (other layouts are
    copied first); CPU tensors run the plain version.  ``y0``, ``x0``: the
    grid origin (host ints)."""
    y0, x0 = int(y0), int(x0)
    if not acc.is_cuda:
        return scatter_grid2d_add_plain(acc, cot, y0, x0, stride, rows)
    _check_cuda_operands(acc, cot, y0, x0, stride, rows)
    channel_major = _channel_major(cot)
    if not channel_major:
        cot = cot.contiguous()
    n, py, px = cot.shape[:3]
    channels = int(np.prod(cot.shape[3:])) if cot.dim() > 3 else 1
    K2(0 if cot.dtype == torch.float32 else 1, int(channel_major), ptr(cot),
       ptr(acc), rows, n // rows, py, px, channels, stride, acc.shape[1],
       y0, x0)
    return acc


def bytes_moved(cot_shape, stride, rows, cot_itemsize):
    """Least device-memory bytes: every cotangent read once, the tile of
    the f32 accumulator read and written once."""
    ty, tx = tile_shape(cot_shape, stride, rows)
    channels = int(np.prod(cot_shape[3:])) if len(cot_shape) > 3 else 1
    return float(np.prod(cot_shape) * cot_itemsize + 2 * ty * tx * channels * 4)
