"""Multislice propagation through precomputed slice transmissions with a
general transfer function: the CUDA kernel pair ``csrc/multislice_fused.cu``
and its plain PyTorch version.

Counterpart of ``adorym_tpu/ops/pallas_multislice.py``'s
``multislice_fused`` (``:774``), whose forward and backward Pallas kernels
(``_fwd_kernel`` ``:184``, ``_bwd_kernel`` ``:222``) the CUDA kernels
replace.  ``t[S, N, ny, nx]`` holds the complex transmission of each
(binned) slice, ``wave[M, N, ny, nx]`` the incident wave of M probe modes
(t broadcasts over them), and ``kernel[ny, nx]`` the per-step transfer
function, which need not be separable (the non-paraxial Fresnel kernel is
not).  Every step but the last is ``w <- IFFT2(FFT2(w t_z) H)``; the last
is the modulation only.

This is the fused multislice of every case the delta/beta kernel of
:mod:`.cuda_multislice` does not take: ``unknown_type='real_imag'``, whose
transmission is the object's channels themselves, and the non-paraxial
transfer function.  The kernels compute and record in f32 whatever the
object's storage type.

The kernels take each step by one of three routes, chosen from the shape
alone (:func:`k5_route`), as K1 and K4 do: ``'fft'`` when both sides split
as ``n1 * n2`` with ``2 <= n1 <= n2 <= 9`` (72 = 8 x 9), where each step
is a 2-D FFT in shared memory with the transfer function applied from the
step table of :func:`step_table`; ``'dense'`` otherwise, four DFT matmuls a
step, while the block's waves and matrices fit in shared memory;
``'global'`` for larger planes (128^2, or 96^2 at three modes), the dense
route's kernels with the block's planes in a device-memory workspace.
:func:`fft_step2d_plain` models the FFT route's step in PyTorch for the
tests.

:func:`multislice_fused` routes by device: CUDA tensors go through the
kernels (an autograd Function whose backward is the second kernel), CPU
tensors through :func:`multislice_fused_plain`, the same steps op by op with
the gradient from autograd.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch

from ..utils.cuda_build import Kernel, ptr
from . import cuda_multislice as _cm
from .fourier import dft_matrix, fft2, ifft2

_I = ctypes.c_int
_P = ctypes.c_void_p
K5_FWD = Kernel('multislice_fused.cu', 'k5_fwd',
                [_I] + [_P] * 7 + [_I] * 5 + [_P])
K5_BWD = Kernel('multislice_fused.cu', 'k5_bwd',
                [_I] + [_P] * 8 + [_I] * 5 + [_P])
#: K5 launches (forward and backward) by step route, counted beside
#: ``K5_FWD.launches`` and ``K5_BWD.launches``.
K5_ROUTE_LAUNCHES = {'dense': 0, 'fft': 0, 'global': 0}


def multislice_fused_plain(t, wave, kernel, records=False):
    """Plain PyTorch version of the kernel pair: FFT steps op by op,
    differentiable by autograd.  ``records``: also return the wave
    entering each step, ``[S, M, N, ny, nx]``, what the forward kernel
    records."""
    w = wave
    rec = []
    for z in range(t.shape[0] - 1):
        rec.append(w)
        w = ifft2(fft2(w * t[z]) * kernel)
    rec.append(w)
    out = w * t[-1]
    return (out, torch.stack(rec)) if records else out


def smem_bytes(n_modes, ny, nx, route='dense', backward=False):
    """Dynamic shared memory of one kernel block, complex64.  Dense route:
    one block per patch holds the M waves, one scratch plane and the DFT
    matrices (one when ny == nx).  FFT route: one block per (patch, mode)
    holds the plane and its scratch plane with rows padded to an odd
    length, the staged t plane (and in the backward the staged record
    plane), both axes' roots of unity and, where the block still fits, the
    step table; else the table is read through L2
    (``multislice_fused.cu``, ``fft2d_smem_bytes``).  The global route
    takes none: its planes lie in device memory."""
    if route == 'global':
        return 0
    if route == 'dense':
        return 8 * ((n_modes + 1) * ny * nx + ny * ny
                    + (0 if nx == ny else nx * nx))
    planes = 2 * ny * (nx | 1) + (2 if backward else 1) * ny * nx + ny + nx
    with_table = 8 * (planes + ny * nx)
    return with_table if with_table <= _cm.MAX_SMEM_BYTES else 8 * planes


def k5_route(ny, nx, n_modes=1):
    """K5's route for ``ny x nx`` planes: ``'fft'`` when both sides take
    the radix split (:func:`.cuda_multislice.fft_radix`) and the backward's
    block fits in shared memory (with the step table through L2 if need
    be), else ``'dense'`` when the dense block of ``n_modes`` waves fits,
    else ``'global'`` (e.g. 128^2).  The FFT route runs one block per mode,
    so the modes enter only the dense route's check."""
    if (_cm.fft_radix(ny) and _cm.fft_radix(nx)
            and smem_bytes(1, ny, nx, 'fft', backward=True)
            <= _cm.MAX_SMEM_BYTES):
        return 'fft'
    if (smem_bytes(n_modes, ny, nx, 'dense', backward=True)
            <= _cm.MAX_SMEM_BYTES):
        return 'dense'
    return 'global'


def _stage_order(n):
    """The frequency of each position along an axis after pass B's forward
    half: position ``n2 k1 + k2`` holds ``k1 + n1 k2``."""
    n1 = _cm.fft_radix(n)
    n2 = n // n1
    pos = torch.arange(n)
    return pos // n2 + n1 * (pos % n2)


#: The step tables built so far, by the transfer function tensor's id:
#: (a weak reference to it, its version counter, the table).
_tables = {}


def step_table(kernel):
    """The FFT route's step table of the transfer function ``kernel[ny,
    nx]``: ``H`` in complex64 on its device, row ``n2 k1 + k2`` holding
    the y frequency ``k1 + n1 k2`` (the order in which the y axis's forward
    half leaves the rows), so the x pass reads its row with the natural x
    frequencies.  The step's ``1 / (ny nx)`` is not in the table: each
    axis's last pass back multiplies by its own ``1 / n``, rounded to f32
    (:func:`fft_step2d_plain`; ROADMAP C.2).  Built once for each transfer-function tensor
    (rebuilt if it is modified in place): the propagator keeps one tensor
    per geometry, so the table is not rebuilt per chunk."""
    hit = _tables.get(id(kernel))
    if (hit is not None and hit[0]() is kernel
            and hit[1] == kernel._version):
        return hit[2]
    h = kernel.to(torch.complex64)
    ny, nx = h.shape
    table = h[_stage_order(ny).to(h.device)].contiguous()
    if len(_tables) >= 16:
        _tables.clear()
    _tables[id(kernel)] = (weakref.ref(kernel), kernel._version, table)
    return table


def fft_step2d_plain(w, table, step='P'):
    """The FFT route's 2-D step on planes ``[..., ny, nx]``, op by op in
    the kernels' stages (:func:`.cuda_multislice.fft_stages_plain` and
    :func:`.cuda_multislice.fft_stages_back_plain`): the y transform, the x
    transform, the product with the step table (put back in natural order),
    the x transform back times ``1 / nx`` and the y transform back times
    ``1 / ny`` (each rounded to f32 once).  ``step``: ``'P'`` (forward:
    FFTs, H, inverse FFTs) or ``'PT'`` (``P^T``: inverse FFTs, the same H,
    FFTs; JAX's transpose takes H itself)."""
    ny, nx = w.shape[-2:]
    ry, rx = _cm.fft_radix(ny), _cm.fft_radix(nx)
    first_inverse = step == 'PT'
    h = torch.empty_like(table)
    h[_stage_order(ny).to(table.device)] = table
    x = _cm.fft_stages_plain(w.transpose(-1, -2), ry, ny // ry,
                             first_inverse).transpose(-1, -2)
    x = _cm.fft_stages_plain(x, rx, nx // rx, first_inverse) * h
    x = _cm.fft_stages_back_plain(x, rx, nx // rx,
                                  not first_inverse) * np.float32(1 / nx)
    x = _cm.fft_stages_back_plain(x.transpose(-1, -2), ry, ny // ry,
                                  not first_inverse).transpose(-1, -2)
    return x * np.float32(1 / ny)


@functools.lru_cache(maxsize=16)
def _dft_mats(ny, nx, device):
    """The forward DFT matrices ``(F_y, F_x)`` on ``device`` (one tensor
    when square), built once per shape and device."""
    fy = torch.from_numpy(dft_matrix(ny)).to(device)
    fx = fy if nx == ny else torch.from_numpy(dft_matrix(nx)).to(device)
    return fy, fx


def step_mats(kernel, route):
    """The step operands the kernels take on ``route``: on ``'fft'`` the
    step table (:func:`step_table`); on ``'dense'`` and ``'global'`` the
    DFT matrices and the transfer function itself."""
    if route == 'fft':
        return {'route': 'fft', 'fy': None, 'fx': None,
                'h': step_table(kernel), 'kernel': kernel}
    ny, nx = kernel.shape
    fy, fx = _dft_mats(ny, nx, kernel.device)
    return {'route': route, 'fy': fy, 'fx': fx, 'h': kernel.contiguous(),
            'kernel': kernel}


def _workspace(route, m, n, ny, nx, device):
    """The global route's device-memory planes: the M waves and a scratch
    plane of each of the ``n`` blocks (None on the other routes)."""
    return _cm.workspace(route, m + 1, 1, n, ny, nx, device)


class MultisliceFused(torch.autograd.Function):
    """The CUDA kernel pair as one autograd Function.  Takes contiguous
    complex64 CUDA operands and the step operands of :func:`step_mats` for
    ``mats['route']`` (see :func:`multislice_fused`)."""

    @staticmethod
    def forward(ctx, t, wave, mats):
        n_steps, n, ny, nx = t.shape
        m = wave.shape[0]
        out = torch.empty((m, n, ny, nx), dtype=torch.complex64,
                          device=t.device)
        rec = torch.empty((n_steps, m, n, ny, nx), dtype=torch.complex64,
                          device=t.device)
        route = mats['route']
        K5_FWD(_cm.STEP_ROUTES[route], ptr(t), ptr(wave), ptr(mats['fy']),
               ptr(mats['fx']), ptr(mats['h']), ptr(out), ptr(rec), n_steps,
               m, n, ny, nx, ptr(_workspace(route, m, n, ny, nx, t.device)))
        K5_ROUTE_LAUNCHES[route] += 1
        ctx.save_for_backward(t, rec)
        ctx.save_for_forward(t, rec)
        ctx.mats = mats
        return out

    @staticmethod
    def jvp(ctx, dt, dwave, _):
        """Forward mode from the records (:func:`.cuda_multislice.
        multislice_tangent`)."""
        t, rec = ctx.saved_tensors
        _cm.TANGENT_LAUNCHES['K5'] += 1
        return _cm.multislice_tangent(t, dt, rec, dwave,
                                      ctx.mats['kernel'])

    @staticmethod
    def backward(ctx, grad_out):
        t, rec = ctx.saved_tensors
        mats = ctx.mats
        n_steps, n, ny, nx = t.shape
        m = rec.shape[1]
        g = grad_out.resolve_conj().contiguous()
        gt = torch.empty_like(t)
        gw = torch.empty((m, n, ny, nx), dtype=torch.complex64,
                         device=t.device)
        route = mats['route']
        K5_BWD(_cm.STEP_ROUTES[route], ptr(t), ptr(rec), ptr(g),
               ptr(mats['fy']), ptr(mats['fx']), ptr(mats['h']), ptr(gt),
               ptr(gw), n_steps, m, n, ny, nx,
               ptr(_workspace(route, m, n, ny, nx, t.device)))
        K5_ROUTE_LAUNCHES[route] += 1
        return gt, gw, None


def _check_cuda_operands(t, wave, kernel, route):
    if t.dim() != 4:
        raise ValueError(f't must be [S, N, ny, nx], got {tuple(t.shape)}')
    _, n, ny, nx = t.shape
    if wave.dim() != 4 or tuple(wave.shape[1:]) != (n, ny, nx):
        raise ValueError(f'wave must be [M, {n}, {ny}, {nx}], '
                         f'got {tuple(wave.shape)}')
    for name, x in (('t', t), ('wave', wave), ('kernel', kernel)):
        if x.dtype != torch.complex64:
            raise TypeError(f'{name} must be complex64, got {x.dtype}')
        if not x.is_cuda or x.device != t.device:
            raise ValueError('t, wave and kernel must share a CUDA device')
    if tuple(kernel.shape) != (ny, nx):
        raise ValueError(f'kernel must be [{ny}, {nx}], '
                         f'got {tuple(kernel.shape)}')
    m = wave.shape[0]
    if route == 'fft' and m > _cm.MAX_MODES:
        raise ValueError(f'the fused multislice kernels take at most '
                         f'{_cm.MAX_MODES} probe modes (one cluster block '
                         f'each), got {m}')
    need = smem_bytes(m, ny, nx, route, backward=True)
    if need > _cm.MAX_SMEM_BYTES:
        raise ValueError(
            f'fused multislice kernel needs {need} bytes of shared memory '
            f'for {m} modes at {ny}x{nx}; the limit is '
            f'{_cm.MAX_SMEM_BYTES}')


def multislice_fused(t, wave, kernel):
    """Exit wave ``[M, N, ny, nx]`` complex64 of the multislice through
    the slice transmissions ``t[S, N, ny, nx]``; differentiable in ``t``
    and ``wave`` (not in ``kernel``: it is geometry).  CUDA tensors run the
    kernels, on the route :func:`k5_route` picks for the shape; CPU
    tensors the plain version."""
    if not t.is_cuda:
        return multislice_fused_plain(t, wave, kernel)
    route = k5_route(*t.shape[-2:], wave.shape[0])
    _check_cuda_operands(t, wave, kernel, route)
    return MultisliceFused.apply(t.contiguous(), wave.contiguous(),
                                 step_mats(kernel, route))


def flops(n_steps, n_modes, n, ny, nx, backward=False):
    """Least real floating-point operations of one sweep, the transforms
    counted as FFTs (:func:`.cuda_multislice.flops` without a far field),
    whichever route runs: the dense route's DFT matmuls do about 13 times
    as many at 72x72."""
    return _cm.flops(n_steps, n_modes, n, ny, nx, final=False,
                     backward=backward)


def bytes_moved(n_steps, n_modes, n, ny, nx, backward=False):
    """Least device-memory bytes of one sweep, complex64 throughout: every
    input read once and every output written once (t, records, waves and
    the transfer function)."""
    plane = n * ny * nx * 8
    t = n_steps * plane
    rec = n_steps * n_modes * plane
    wave = n_modes * plane
    h = ny * nx * 8
    if backward:          # t, records, g, H in; gt, gw out
        return float(t + rec + wave + h + t + wave)
    return float(t + wave + h + wave + rec)   # t, w0, H in; out, records out
