"""Complete-grid patch scatter-add and gather: the CUDA kernels
``csrc/grid_scatter.cu`` (K2) and ``csrc/grid_extract.cu`` (K3), each with
its plain PyTorch version.

Counterpart of ``adorym_tpu/ops/pallas_scatter_grid.py``.  K2 replaces the
band kernel behind ``grid2d_tile`` (``:68``) together with the accumulator
update of ``scatter_grid2d_add_pallas`` (``:182``): patch ``(r, j)`` of a
``rows x cols`` grid, ``cot[r*cols + j, py, px, ...]``, is added at
``(y0 + r*stride, x0 + j*stride)`` of ``acc[Y, X, ...]``.  Cotangents may
be f32 or bf16; the sums and the accumulator are f32.  K3 replaces the
band gather behind ``grid2d_extract`` (``:118``) and
``extract_grid2d_pallas`` (``:156``): the same windows copied out of the
object, K2's exact transpose.  It is forward only: the Reconstructor
differentiates with respect to the patches, and K2 carries their gradient
back.  K6, ``csrc/rowgrid_scatter.cu``, replaces
``scatter_rowgrid_add_pallas`` (``:193``, K2's kernel for one grid row):
the immediate scheme's band step launches it once a minibatch, and the
per-angle path once a grid row of a gradient chunk that is not one
complete grid (reading the row where it lies in the chunk's z-major
gradient), through a launch plan cached per operand shape
(:func:`rowgrid_plan`), so that a call costs the host a dict lookup and
one ctypes call.

K2's and K6's kernels have two instantiations for each dtype and layout:
``'vec'``, in which a thread owns 16 bytes of contiguous cotangent
elements (4 f32 or 8 bf16), and ``'scalar'``, one element a thread, for
the shapes and pointers the vector form does not take
(:func:`vector_width` chooses by shape, dtype and alignment).  Both sum
in the same order, so they agree bit for bit, and K6 sums as K2's kernel
does at ``rows=1``.  :data:`K2_ROUTE_LAUNCHES` and
:data:`K6_ROUTE_LAUNCHES` count the launches of each.

Unlike the JAX package, which returns a new accumulator
(``dynamic_update_slice``), the scatters update ``acc`` IN PLACE and
return it: the accumulator is the size of the padded object and is
touched once per gradient chunk.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.cuda_build import Kernel, ptr, stream_ptr
from . import cuda_multislice as _cm

_I = ctypes.c_int
_P = ctypes.c_void_p
K2 = Kernel('grid_scatter.cu', 'k2_grid_scatter_add',
            [_I, _I, _I, _P, _P] + [_I] * 9)
K3 = Kernel('grid_extract.cu', 'k3_grid_extract',
            [_P, _P, _I, ctypes.c_longlong] + [_I] * 8)
#: K6: one grid row, launched by :func:`scatter_rowgrid_add_kernel`.
K6 = Kernel('rowgrid_scatter.cu', 'k6_rowgrid_scatter_add',
            [_I, _P, _P, _P, _I, _I])
#: K2's and K6's launches by instantiation (:func:`vector_width`).
K2_ROUTE_LAUNCHES = {'vec': 0, 'scalar': 0}
K6_ROUTE_LAUNCHES = {'vec': 0, 'scalar': 0}
#: K6's launches by the layout it read (:class:`RowgridPlan`): ``'copy'``
#: counts the rows made contiguous before the launch.
K6_LAYOUT_LAUNCHES = {'channel': 0, 'patch': 0, 'copy': 0}


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


def _check_operands(acc, cot, stride, rows):
    """The checks of K2's and K6's operands that depend neither on their
    device nor on the grid's origin; returns the tile's ``(Ty, Tx)``."""
    check_supported(cot.shape, stride, rows)
    if acc.dtype != torch.float32 or not acc.is_contiguous():
        raise ValueError('acc must be a contiguous float32 tensor')
    if cot.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'cot must be float32 or bfloat16, got {cot.dtype}')
    if tuple(cot.shape[3:]) != tuple(acc.shape[2:]):
        raise ValueError(f'trailing dims differ: cot {tuple(cot.shape)}, '
                         f'acc {tuple(acc.shape)}')
    ty, tx = tile_shape(cot.shape, stride, rows)
    if ty > 65535:
        raise ValueError(f'tile height {ty} exceeds the launch grid')
    return ty, tx


def _check_cuda_operands(acc, cot, y0, x0, stride, rows):
    ty, tx = _check_operands(acc, cot, stride, rows)
    if not cot.is_cuda or cot.device != acc.device:
        raise ValueError('acc and cot must share a CUDA device')
    if not (0 <= y0 and y0 + ty <= acc.shape[0]
            and 0 <= x0 and x0 + tx <= acc.shape[1]):
        raise ValueError(f'tile {ty}x{tx} at ({y0}, {x0}) leaves the '
                         f'accumulator {tuple(acc.shape[:2])}')


def channel_stride(cot):
    """The elements between two channels' patches when ``cot[N, py, px,
    *tr]`` is channel-major: each channel's ``[N, py, px]`` block
    contiguous, the channels (``*tr`` flattened, last fastest) at one
    stride no smaller than the block, as in a slice along N of contiguous
    ``[*tr, N', py, px]`` memory (one grid row of a z-major gradient
    chunk).  None for any other layout, a contiguous one included."""
    n, py, px = cot.shape[:3]
    st = cot.stride()
    if (cot.is_contiguous() or cot.dim() < 4
            or tuple(st[:3]) != (py * px, px, 1)):
        return None
    cs = st[-1]
    want = cs
    for size, s in zip(reversed(cot.shape[3:]), reversed(st[3:])):
        if size > 1 and s != want:
            return None
        want *= size
    return cs if cs >= n * py * px else None


def _channel_major(cot) -> bool:
    """Whether ``cot[N, py, px, *tr]`` is a view of contiguous
    ``[*tr, N, py, px]`` memory (the z-major patch gradient)."""
    return channel_stride(cot) == cot.shape[0] * cot.shape[1] * cot.shape[2]


def bulk_copy_smem_bytes(itemsize, cols, px, stride):
    """Dynamic shared memory of a block of K2's channel-major vector
    instantiation (``tma_stage_bytes`` in the source): two buffers, each
    the block's 8 (f32) or 16 (bf16) rows of every patch column that can
    cover its 256 X values, padded by 8 elements a column."""
    rows = 32 // itemsize
    n_cols = min(cols, (256 + px) // stride + 1)
    return 2 * itemsize * n_cols * (rows * px + 8)


def vector_width(itemsize, channels, stride, channel_major, *pointers,
                 smem_bytes=0):
    """Elements a thread of K2's kernel owns: 16 bytes' worth (4 f32, 8
    bf16) when a vector never straddles a patch column (channel-major: the
    vector runs along x, so ``stride`` must be a multiple of it, and the
    block's ``smem_bytes``, :func:`bulk_copy_smem_bytes`, must fit) or a
    site (patch-major: along c, so ``channels`` must be), the accumulator
    is read and written along c in 16-byte words (``channels % 4 == 0``)
    and every pointer (cotangents, accumulator) is 16-byte aligned; else
    1."""
    v = 16 // itemsize
    along = stride if channel_major else channels
    # 16 bytes of static shared memory: the block's two barriers.
    fits = not channel_major or smem_bytes + 16 <= _cm.MAX_SMEM_BYTES
    if (along % v == 0 and channels % 4 == 0 and fits
            and all(p % 16 == 0 for p in pointers)):
        return v
    return 1


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
    return _launch_scatter(acc, cot, y0, x0, stride, rows)


def _launch_scatter(acc, cot, y0, x0, stride, rows, vec=None):
    """Launch K2 with :func:`vector_width`'s instantiation, or with
    ``vec=1`` the scalar one (the card tests and chip_smoke compare the
    two), and count it in :data:`K2_ROUTE_LAUNCHES`."""
    _check_cuda_operands(acc, cot, y0, x0, stride, rows)
    channel_major = _channel_major(cot)
    if not channel_major:
        cot = cot.contiguous()
    n, py, px = cot.shape[:3]
    channels = int(np.prod(cot.shape[3:])) if cot.dim() > 3 else 1
    widest = vector_width(
        cot.element_size(), channels, stride, channel_major, cot.data_ptr(),
        acc.data_ptr(), smem_bytes=bulk_copy_smem_bytes(
            cot.element_size(), n // rows, px, stride))
    if vec is None:
        vec = widest
    elif vec not in (1, widest):
        raise ValueError(f'K2 takes {widest} or 1 elements a thread for '
                         f'these operands, not {vec}')
    K2(0 if cot.dtype == torch.float32 else 1, int(channel_major), vec,
       ptr(cot), ptr(acc), rows, n // rows, py, px, channels, stride,
       acc.shape[1], y0, x0)
    K2_ROUTE_LAUNCHES['vec' if vec > 1 else 'scalar'] += 1
    return acc


def bytes_moved(cot_shape, stride, rows, cot_itemsize):
    """Least device-memory bytes: every cotangent read once, the tile of
    the f32 accumulator read and written once."""
    ty, tx = tile_shape(cot_shape, stride, rows)
    channels = int(np.prod(cot_shape[3:])) if len(cot_shape) > 3 else 1
    return float(np.prod(cot_shape) * cot_itemsize + 2 * ty * tx * channels * 4)


# -- K6: one grid row -------------------------------------------------------

def scatter_rowgrid_add(acc, cot, y0, x0, stride):
    """Plain version of one grid row's scatter (``patches.py:204``): the
    patches ``cot[N, py, px, ...]`` at ``(y0, x0 + stride*j)`` added into
    ``acc`` in place (returned), summed in ``acc``'s dtype.  Lane ``b`` of
    patch ``j`` (``px/stride`` lanes of ``stride`` columns) lands at column
    block ``j + b``: ``px/stride`` shifted adds, then one update of the
    row's ``[py, (N-1)*stride + px]`` tile."""
    y0, x0 = int(y0), int(x0)
    n, py, px = cot.shape[:3]
    k = px // stride
    trailing = tuple(cot.shape[3:])
    z = cot.reshape((n, py, k, stride) + trailing)
    buf = torch.zeros((n + k - 1, py, stride) + trailing, dtype=acc.dtype,
                      device=acc.device)
    for b in range(k):
        buf[b:b + n] += z[:, :, b].to(acc.dtype)
    width = (n + k - 1) * stride
    tile = buf.movedim(0, 1).reshape((py, width) + trailing)
    acc[y0:y0 + py, x0:x0 + width] += tile
    return acc


class _K6Row(ctypes.Structure):
    """The row's geometry as ``csrc/rowgrid_scatter.cu`` reads it
    (``K6Row``)."""
    _fields_ = [(f, ctypes.c_int) for f in ('N', 'py', 'px', 'C', 'stride',
                                             'Xa')] + [('cs', ctypes.c_int64)]


class RowgridPlan:
    """K6's launch for one key of operands (:func:`rowgrid_plan`): the
    checks that do not depend on the row's origin, done once, and what the
    launch needs.

    ``layout``: ``'channel'`` (``cot[N, py, px, *tr]`` channel-major,
    :func:`channel_stride`: the z-major gradient of a row, or one grid row
    of a z-major gradient chunk, read in place), ``'patch'`` (contiguous)
    or ``'copy'`` (any other view, made contiguous at each call and then
    read as ``'patch'``).  ``vec``: the elements a thread owns, 16 bytes'
    worth where :func:`vector_width` allows (without the bulk-copy buffers
    of K2, which K6 has not) and a channel-major channel stride is a whole
    number of vectors, else 1; ``vec=1`` asked for forces the scalar
    instantiation, and any other width than those two raises.  ``route``:
    ``'vec'`` or ``'scalar'``.  ``kind``: the C entry's instantiation (bit
    0 bf16, bit 1
    channel-major, bit 2 the vector one).  ``y_max``, ``x_max``: the
    largest origin that keeps the row's tile inside the accumulator."""

    __slots__ = ('layout', 'vec', 'route', 'kind', 'row', 'row_ptr',
                 'y_max', 'x_max')

    def __init__(self, acc, cot, stride, aligned, vec=None):
        ty, tx = _check_operands(acc, cot, stride, 1)
        n, py, px = cot.shape[:3]
        self.y_max, self.x_max = acc.shape[0] - ty, acc.shape[1] - tx
        if self.y_max < 0 or self.x_max < 0:
            raise ValueError(f'tile {ty}x{tx} leaves the accumulator '
                             f'{tuple(acc.shape[:2])}')
        channels = int(np.prod(cot.shape[3:])) if cot.dim() > 3 else 1
        cs = channel_stride(cot)
        channel_major = cs is not None
        self.layout = ('channel' if channel_major else
                       'patch' if cot.is_contiguous() else 'copy')
        widest = vector_width(cot.element_size(), channels, stride,
                              channel_major) if aligned else 1
        if channel_major and cs % widest:
            widest = 1
        if vec is None:
            vec = widest
        elif vec not in (1, widest):
            raise ValueError(f'K6 takes {widest} or 1 elements a thread for '
                             f'these operands, not {vec}')
        self.vec = vec
        self.route = 'vec' if vec > 1 else 'scalar'
        self.kind = (int(cot.dtype == torch.bfloat16) | 2 * channel_major
                     | 4 * (vec > 1))
        self.row = _K6Row(n, py, px, channels, stride, acc.shape[1],
                          cs or 0)
        self.row_ptr = ctypes.addressof(self.row)


#: K6's plans by key (:func:`rowgrid_plan`).
_ROWGRID_PLANS = {}


def rowgrid_key(acc, cot, stride, vec=None):
    """The key of K6's plan: the operands' shapes, strides and dtypes, the
    stride, whether both pointers are 16-byte aligned, and the
    instantiation asked for (None: the widest)."""
    return (cot.shape, cot.stride(), cot.dtype, acc.shape, acc.stride(),
            acc.dtype, stride, (acc.data_ptr() | cot.data_ptr()) % 16 == 0,
            vec)


def rowgrid_plan(acc, cot, stride, vec=None):
    """K6's :class:`RowgridPlan` for these operands, built on the first
    call with its key and reused after."""
    key = rowgrid_key(acc, cot, stride, vec)
    plan = _ROWGRID_PLANS.get(key)
    if plan is None:
        plan = _ROWGRID_PLANS[key] = RowgridPlan(acc, cot, stride, key[7],
                                                 vec)
    return plan


def scatter_rowgrid_add_kernel(acc, cot, y0, x0, stride):
    """Counterpart of ``scatter_rowgrid_add_pallas``
    (``pallas_scatter_grid.py:193``): one grid row through K6
    (``csrc/rowgrid_scatter.cu``), fused with the accumulator update, in
    place.  The immediate scheme's band step scatters each minibatch's row
    with it (the z-major gradient read in place), and the per-angle path
    each grid row of a chunk that is not one complete grid (a row of the
    chunk's z-major gradient, read in place), where the JAX package calls
    the plain form, since per-row Pallas launches lost on the TPU.  CPU
    tensors run :func:`scatter_rowgrid_add`."""
    y0, x0 = int(y0), int(x0)
    if not acc.is_cuda:
        return scatter_rowgrid_add(acc, cot, y0, x0, stride)
    return _launch_rowgrid(acc, cot, y0, x0, stride)


def _launch_rowgrid(acc, cot, y0, x0, stride, vec=None):
    """Launch K6 by its plan (with ``vec=1`` the scalar instantiation: the
    card tests and chip_smoke compare the two) on the current stream, and
    count it in :data:`K6`, :data:`K6_ROUTE_LAUNCHES` and
    :data:`K6_LAYOUT_LAUNCHES`."""
    plan = rowgrid_plan(acc, cot, stride, vec)
    dev = acc.get_device()
    if cot.get_device() != dev:
        raise ValueError('acc and cot must share a CUDA device')
    if not (0 <= y0 <= plan.y_max and 0 <= x0 <= plan.x_max):
        raise ValueError(f'the row at ({y0}, {x0}) leaves the accumulator '
                         f'{tuple(acc.shape[:2])}')
    if plan.layout == 'copy':
        cot = cot.contiguous()
    err = K6.function()(plan.kind, cot.data_ptr(), acc.data_ptr(),
                        plan.row_ptr, y0, x0, stream_ptr(dev))
    if err:
        K6.fail(err)
    K6.launches += 1
    K6_ROUTE_LAUNCHES[plan.route] += 1
    K6_LAYOUT_LAUNCHES[plan.layout] += 1
    return acc


# -- K3: the gather ---------------------------------------------------------

def grid2d_extract_plain(tile, stride, rows, cols, probe_size):
    """Plain version of the gather from a tile whose window ``(r, j)``
    starts at ``(r*stride, j*stride)``: patches ``[rows*cols, py, px,
    ...]`` (``pallas_scatter_grid.grid2d_extract``'s contract)."""
    py, px = int(probe_size[0]), int(probe_size[1])
    dev = tile.device
    iy = (stride * torch.arange(rows, device=dev)[:, None]
          + torch.arange(py, device=dev))
    ix = (stride * torch.arange(cols, device=dev)[:, None]
          + torch.arange(px, device=dev))
    out = tile[iy[:, None, :, None], ix[None, :, None, :]]
    return out.reshape((rows * cols, py, px) + tuple(tile.shape[2:]))


def _check_extract(obj, y0, x0, stride, rows, cols, probe_size):
    py, px = int(probe_size[0]), int(probe_size[1])
    shape = (rows * cols, py, px)
    check_supported(shape, stride, rows)
    ty, tx = tile_shape(shape, stride, rows)
    if not (0 <= y0 and y0 + ty <= obj.shape[0]
            and 0 <= x0 and x0 + tx <= obj.shape[1]):
        raise ValueError(f'grid footprint {ty}x{tx} at ({y0}, {x0}) leaves '
                         f'the object {tuple(obj.shape[:2])}')
    return ty, tx


def _word_bytes(*sizes):
    """Largest copy word (16, 8 or 4 bytes) dividing every size; raises
    when 4 does not (an object site ``(z, 2)`` is always a multiple of 4
    bytes)."""
    for w in (16, 8, 4):
        if all(s % w == 0 for s in sizes):
            return w
    raise ValueError('the grid gather copies 4-byte words: the bytes per '
                     f'site and both pointers must be multiples of 4, got '
                     f'{sizes}')


def extract_grid2d(obj, y0, x0, stride, rows, cols, probe_size):
    """Patches ``[rows*cols, py, px, *tr]`` of ``obj[Y, X, *tr]`` at the
    windows ``(y0 + r*stride, x0 + j*stride)`` of a complete grid, in the
    object's dtype (``pallas_scatter_grid.extract_grid2d_pallas``).  CUDA
    tensors launch the kernel, which reads a contiguous ``obj`` in place;
    CPU tensors run the plain version.  The footprint must lie inside
    ``obj``.  ``y0``, ``x0``: the grid origin (host ints)."""
    y0, x0 = int(y0), int(x0)
    ty, tx = _check_extract(obj, y0, x0, stride, rows, cols, probe_size)
    if not obj.is_cuda:
        return grid2d_extract_plain(obj[y0:y0 + ty, x0:x0 + tx], stride,
                                    rows, cols, probe_size)
    if not obj.is_contiguous():
        raise ValueError('obj must be contiguous')
    if rows * cols > 65535:
        raise ValueError(f'{rows * cols} patches exceed the launch grid')
    py, px = int(probe_size[0]), int(probe_size[1])
    out = torch.empty((rows * cols, py, px) + tuple(obj.shape[2:]),
                      dtype=obj.dtype, device=obj.device)
    site = int(np.prod(obj.shape[2:])) * obj.element_size()
    K3(ptr(obj), ptr(out), _word_bytes(site, obj.data_ptr(), out.data_ptr()),
       site, obj.shape[1], rows, cols, py, px, stride, y0, x0)
    return out


def extract_bytes_moved(patch_shape, stride, rows, itemsize):
    """Least device-memory bytes of the gather: the grid's footprint read
    once, every patch written once."""
    ty, tx = tile_shape(patch_shape, stride, rows)
    channels = int(np.prod(patch_shape[3:])) if len(patch_shape) > 3 else 1
    return float((np.prod(patch_shape) + ty * tx * channels) * itemsize)
