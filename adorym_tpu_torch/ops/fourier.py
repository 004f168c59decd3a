"""Fourier-domain primitives on complex64 tensors (``torch.fft``).

Counterpart of ``adorym_tpu/ops/fourier.py``.  Conventions as in the
reference: ``fft2``/``ifft2`` act on the last two axes and are
unnormalized unless ``norm='ortho'``; :func:`fourier_shift` moves an image
by a (differentiable) sub-pixel shift through a phase ramp.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def fft2(x, norm=None, dim=(-2, -1)):
    return torch.fft.fft2(x, dim=dim, norm=norm)


def ifft2(x, norm=None, dim=(-2, -1)):
    return torch.fft.ifft2(x, dim=dim, norm=norm)


def fftshift2(x, dim=(-2, -1)):
    return torch.fft.fftshift(x, dim=dim)


def ifftshift2(x, dim=(-2, -1)):
    return torch.fft.ifftshift(x, dim=dim)


def fft2_and_shift(x, norm=None, dim=(-2, -1)):
    """fftshifted 2D FFT — the Fraunhofer far-field operator."""
    return torch.fft.fftshift(fft2(x, norm=norm, dim=dim), dim=dim)


def ifft2_and_shift(x, norm=None, dim=(-2, -1)):
    """fftshifted 2D inverse FFT."""
    return torch.fft.fftshift(ifft2(x, norm=norm, dim=dim), dim=dim)


def ishift_and_ifft2(x, norm=None, dim=(-2, -1)):
    """Inverse of :func:`fft2_and_shift`."""
    return ifft2(torch.fft.ifftshift(x, dim=dim), norm=norm, dim=dim)


@functools.lru_cache(maxsize=64)
def _freq_grids(shape: tuple) -> tuple:
    """(fy, fx) pixel-frequency grids (cycles/pixel) of a 2D shape, float32
    numpy, ``[ny, 1]`` and ``[1, nx]``."""
    fy = np.fft.fftfreq(shape[0]).astype(np.float32)[:, None]
    fx = np.fft.fftfreq(shape[1]).astype(np.float32)[None, :]
    return fy, fx


def shift_phase_ramp(shape, shift):
    """The frequency-domain phase ramp ``exp(-2 pi i (fy dy + fx dx))`` of
    a real-space shift ``shift[..., 2]`` = (dy, dx) pixels, complex64
    ``[..., ny, nx]`` on ``shift``'s device; differentiable in ``shift``
    (leading axes batch several shifts)."""
    fy, fx = _freq_grids(tuple(int(s) for s in shape))
    fy = torch.from_numpy(fy).to(shift.device)
    fx = torch.from_numpy(fx).to(shift.device)
    dy = shift[..., 0][..., None, None]
    dx = shift[..., 1][..., None, None]
    phase = -2.0 * np.pi * (fy * dy + fx * dx)
    return torch.complex(torch.cos(phase), torch.sin(phase))


def fourier_shift(img, shift):
    """Sub-pixel shift of the complex images ``img[..., ny, nx]`` by
    ``shift[..., 2]`` (broadcast against the images' leading axes): a
    positive ``shift[0]`` moves the image down (+y), ``shift[1]`` right
    (+x).  Differentiable in both."""
    ramp = shift_phase_ramp(img.shape[-2:], shift)
    return ifft2(fft2(img) * ramp)


def dft_matrix(n: int, inverse: bool = False,
               dtype=np.complex64) -> np.ndarray:
    """Dense DFT matrix ``exp(-+2 pi i k l / n)`` (``/ n`` when inverse):
    the multislice kernel applies small transforms as matmuls."""
    k = np.arange(n)
    sign = 2j if inverse else -2j
    mat = np.exp(sign * np.pi * np.outer(k, k) / n).astype(dtype)
    if inverse:
        mat /= n
    return mat
