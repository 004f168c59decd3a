"""Fourier-domain primitives on complex64 tensors (``torch.fft``).

Main-path subset of ``adorym_tpu/ops/fourier.py``.  Conventions as in
the reference: ``fft2``/``ifft2`` act on the last two axes and are
unnormalized unless ``norm='ortho'``.
"""

from __future__ import annotations

import numpy as np
import torch


def fft2(x, norm=None, dim=(-2, -1)):
    return torch.fft.fft2(x, dim=dim, norm=norm)


def ifft2(x, norm=None, dim=(-2, -1)):
    return torch.fft.ifft2(x, dim=dim, norm=norm)


def fft2_and_shift(x, norm=None, dim=(-2, -1)):
    """fftshifted 2D FFT — the Fraunhofer far-field operator."""
    return torch.fft.fftshift(fft2(x, norm=norm, dim=dim), dim=dim)


def ifft2_and_shift(x, norm=None, dim=(-2, -1)):
    """fftshifted 2D inverse FFT."""
    return torch.fft.fftshift(ifft2(x, norm=norm, dim=dim), dim=dim)


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
