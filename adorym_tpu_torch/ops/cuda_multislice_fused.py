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

:func:`multislice_fused` routes by device: CUDA tensors go through the
kernels (an autograd Function whose backward is the second kernel), CPU
tensors through :func:`multislice_fused_plain`, the same steps op by op with
the gradient from autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.cuda_build import Kernel, ptr
from . import cuda_multislice as _cm
from .fourier import dft_matrix, fft2, ifft2

_I = ctypes.c_int
_P = ctypes.c_void_p
K5_FWD = Kernel('multislice_fused.cu', 'k5_fwd', [_P] * 7 + [_I] * 5)
K5_BWD = Kernel('multislice_fused.cu', 'k5_bwd', [_P] * 8 + [_I] * 5)


def multislice_fused_plain(t, wave, kernel):
    """Plain PyTorch version of the kernel pair: FFT steps op by op,
    differentiable by autograd."""
    w = wave
    for z in range(t.shape[0] - 1):
        w = ifft2(fft2(w * t[z]) * kernel)
    return w * t[-1]


def smem_bytes(n_modes, ny, nx):
    """Dynamic shared memory of one kernel block: the M waves, one scratch
    plane and the DFT matrices (one when ny == nx), complex64."""
    return 8 * ((n_modes + 1) * ny * nx + ny * ny
                + (0 if nx == ny else nx * nx))


@functools.lru_cache(maxsize=16)
def _dft_mats(ny, nx, device):
    """The forward DFT matrices ``(F_y, F_x)`` on ``device`` (one tensor
    when square), built once per shape and device."""
    fy = torch.from_numpy(dft_matrix(ny)).to(device)
    fx = fy if nx == ny else torch.from_numpy(dft_matrix(nx)).to(device)
    return fy, fx


class MultisliceFused(torch.autograd.Function):
    """The CUDA kernel pair as one autograd Function.  Takes contiguous
    complex64 CUDA operands and the DFT matrices of :func:`_dft_mats`
    (see :func:`multislice_fused`)."""

    @staticmethod
    def forward(ctx, t, wave, kernel, fy, fx):
        n_steps, n, ny, nx = t.shape
        m = wave.shape[0]
        out = torch.empty((m, n, ny, nx), dtype=torch.complex64,
                          device=t.device)
        rec = torch.empty((n_steps, m, n, ny, nx), dtype=torch.complex64,
                          device=t.device)
        K5_FWD(ptr(t), ptr(wave), ptr(fy), ptr(fx), ptr(kernel), ptr(out),
               ptr(rec), n_steps, m, n, ny, nx)
        ctx.save_for_backward(t, rec, kernel, fy, fx)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        t, rec, kernel, fy, fx = ctx.saved_tensors
        n_steps, n, ny, nx = t.shape
        m = rec.shape[1]
        g = grad_out.resolve_conj().contiguous()
        gt = torch.empty_like(t)
        gw = torch.empty((m, n, ny, nx), dtype=torch.complex64,
                         device=t.device)
        K5_BWD(ptr(t), ptr(rec), ptr(g), ptr(fy), ptr(fx), ptr(kernel),
               ptr(gt), ptr(gw), n_steps, m, n, ny, nx)
        return gt, gw, None, None, None


def _check_cuda_operands(t, wave, kernel):
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
    need = smem_bytes(wave.shape[0], ny, nx)
    if need > _cm.MAX_SMEM_BYTES:
        raise ValueError(
            f'fused multislice kernel needs {need} bytes of shared memory '
            f'for {wave.shape[0]} modes at {ny}x{nx}; the limit is '
            f'{_cm.MAX_SMEM_BYTES}')


def multislice_fused(t, wave, kernel):
    """Exit wave ``[M, N, ny, nx]`` complex64 of the multislice through
    the slice transmissions ``t[S, N, ny, nx]``; differentiable in ``t``
    and ``wave`` (not in ``kernel``: it is geometry).  CUDA tensors run the
    kernels; CPU tensors the plain version."""
    if not t.is_cuda:
        return multislice_fused_plain(t, wave, kernel)
    _check_cuda_operands(t, wave, kernel)
    _, _, ny, nx = t.shape
    fy, fx = _dft_mats(ny, nx, t.device)
    return MultisliceFused.apply(t.contiguous(), wave.contiguous(),
                                 kernel.contiguous(), fy, fx)


def flops(n_steps, n_modes, n, ny, nx, backward=False):
    """Least real floating-point operations of one sweep, the transforms
    counted as FFTs (:func:`.cuda_multislice.flops` without a far field).
    The kernels' DFT matmuls do about 13 times as many at 72x72."""
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
