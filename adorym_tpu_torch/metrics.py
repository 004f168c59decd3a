"""Quality metrics: Fourier shell / ring correlation and subpixel image
registration (``adorym_tpu/metrics.py``), numpy on the host."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _radial_bins(shape, step_size=1):
    grids = np.meshgrid(*[np.fft.fftshift(np.fft.fftfreq(s)) * s
                          for s in shape], indexing='ij')
    r = np.sqrt(sum(g ** 2 for g in grids))
    radius_max = int(min(shape) / 2)
    radii = np.arange(1, radius_max, step_size)
    # a shell of width `step_size` centered at each radius
    idx = np.digitize(r, radii - step_size / 2)
    return radii, idx


def fourier_shell_correlation(obj, ref, step_size=1
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """FSC (3D) or FRC (2D) between two volumes; returns (radii,
    correlation)."""
    obj = np.asarray(obj)
    ref = np.asarray(ref)
    f_obj = np.fft.fftshift(np.fft.fftn(obj))
    f_ref = np.fft.fftshift(np.fft.fftn(ref))
    f_prod = f_obj * np.conjugate(f_ref)
    f_obj_2 = np.abs(f_obj) ** 2
    f_ref_2 = np.abs(f_ref) ** 2
    radii, idx = _radial_bins(obj.shape, step_size)
    n_bins = len(radii) + 2
    flat = idx.ravel()
    num = (np.bincount(flat, weights=f_prod.real.ravel(), minlength=n_bins)
           + 1j * np.bincount(flat, weights=f_prod.imag.ravel(),
                              minlength=n_bins))
    d1 = np.bincount(flat, weights=f_obj_2.ravel(), minlength=n_bins)
    d2 = np.bincount(flat, weights=f_ref_2.ravel(), minlength=n_bins)
    sel = slice(1, len(radii) + 1)
    fsc = np.abs(num[sel]) / np.maximum(np.sqrt(d1[sel] * d2[sel]), 1e-30)
    return radii, fsc


fourier_ring_correlation = fourier_shell_correlation  # 2D input => FRC


def fsc_crossing(radii, fsc, threshold=0.5) -> float:
    """First spatial frequency (in units of the largest radius) where the
    FSC drops below ``threshold``."""
    radii = np.asarray(radii, float)
    below = np.nonzero(np.asarray(fsc) < threshold)[0]
    if len(below) == 0:
        return 1.0
    return float(radii[below[0]] / radii[-1])


def register_translation(src, target, upsample_factor=10):
    """Subpixel registration by upsampled-DFT cross-correlation
    (Guizar-Sicairos et al., Opt. Lett. 33, 156 (2008)).  Returns the (dy,
    dx) shift that aligns ``src`` to ``target``."""
    src = np.asarray(src)
    target = np.asarray(target)
    cross = np.fft.fft2(src) * np.conj(np.fft.fft2(target))
    cc = np.fft.ifft2(cross)
    maxima = np.unravel_index(np.argmax(np.abs(cc)), cc.shape)
    shifts = np.array(maxima, dtype=np.float64)
    for i, s in enumerate(src.shape):
        if shifts[i] > s // 2:
            shifts[i] -= s
    if upsample_factor > 1:
        # Refine around the coarse peak with a matrix-multiply DFT.
        region = int(np.ceil(upsample_factor * 1.5))
        dftshift = region // 2
        offsets = dftshift - shifts * upsample_factor

        def upsampled_dft(data):
            # Contract the last axis for each dimension in reverse, so the
            # axis order is kept.
            out = data
            for n_items, off in zip(data.shape[::-1], offsets[::-1]):
                kernel = ((np.arange(region) - off)[:, None]
                          * np.fft.fftfreq(n_items, upsample_factor))
                out = np.tensordot(np.exp(-2j * np.pi * kernel), out,
                                   axes=(1, -1))
            return out

        cc_up = upsampled_dft(np.conj(cross)).conj()
        maxima_up = np.unravel_index(np.argmax(np.abs(cc_up)), cc_up.shape)
        shifts = shifts + (np.array(maxima_up, dtype=np.float64)
                           - dftshift) / upsample_factor
    return shifts
