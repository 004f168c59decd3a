"""Image-space helpers: priors, conversions, synthetic masks, resampling
(``adorym_tpu/ops/image.py``).

The priors and conversions act on tensors, differentiably; the mask and
map generators and the multiscale upsampling are host-side numpy, as in
the JAX package, and give the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def total_variation(arr, axes):
    """Mean absolute circular difference along ``axes``."""
    res = 0.0
    for ax in axes:
        res = res + torch.sum(torch.abs(torch.roll(arr, 1, dims=ax) - arr))
    return res / arr.numel()


def total_variation_3d(arr, axis_offset=0):
    """3D TV over axes ``axis_offset + (0, 1, 2)``."""
    return total_variation(arr, (axis_offset, axis_offset + 1,
                                 axis_offset + 2))


def image_gradient(arr, axes):
    """Squared roll-difference gradient magnitude map."""
    g = 0.0
    for ax in axes:
        g = g + (torch.roll(arr, 1, dims=ax) - arr) ** 2
    return g


def pearson_corr_along_last(arr):
    """Product-form Pearson correlation across the last axis: multiply the
    centered slices elementwise, sum, normalize by the product of the
    (population) standard deviations, abs."""
    lead = tuple(range(arr.dim() - 1))
    centered = arr - torch.mean(arr, dim=lead, keepdim=True)
    nom = torch.sum(torch.prod(centered, dim=-1))
    denom = torch.prod(torch.std(arr, dim=lead, unbiased=False))
    return torch.abs(nom / denom)


def mag_phase_to_real_imag(mag, phase):
    return mag * torch.cos(phase), mag * torch.sin(phase)


def real_imag_to_mag_phase(re, im):
    return torch.sqrt(re ** 2 + im ** 2), torch.atan2(im, re)


def generate_gaussian_map(size, mag_max, mag_sigma, phase_max, phase_sigma):
    """Centered Gaussian magnitude and phase maps (numpy)."""
    py = np.arange(size[0]) - (size[0] - 1.0) / 2
    px = np.arange(size[1]) - (size[1] - 1.0) / 2
    pxx, pyy = np.meshgrid(px, py)
    r2 = pxx ** 2 + pyy ** 2
    map_mag = mag_max * np.exp(-r2 / (2 * mag_sigma ** 2))
    map_phase = phase_max * np.exp(-r2 / (2 * phase_sigma ** 2))
    return map_mag, map_phase


def generate_disk(shape, radius, anti_aliasing=5):
    """Antialiased disk mask (numpy)."""
    shape = np.asarray(shape)
    radius = int(radius)
    x = np.linspace(-shape[1] / 2, shape[1] / 2, shape[1] * anti_aliasing)
    y = np.linspace(-shape[0] / 2, shape[0] / 2, shape[0] * anti_aliasing)
    xx, yy = np.meshgrid(x, y)
    a = (xx ** 2 + yy ** 2 <= radius ** 2).astype(np.float64)
    return a.reshape(shape[0], anti_aliasing, shape[1],
                     anti_aliasing).mean(axis=(1, 3))


def generate_sphere(shape, radius, anti_aliasing=5):
    """Antialiased solid sphere mask (numpy)."""
    shape = np.asarray(shape)
    aa = anti_aliasing
    grids = np.meshgrid(*[np.linspace(-s / 2, s / 2, s * aa) for s in shape],
                        indexing='ij')
    vol = (sum(g ** 2 for g in grids) <= radius ** 2).astype(np.float64)
    view = vol.reshape(*[d for s in shape for d in (s, aa)])
    return view.mean(axis=tuple(range(1, 2 * len(shape), 2)))


def generate_shell(shape, radius, thickness=1, anti_aliasing=2):
    """Spherical shell mask, the FSC integration element."""
    outer = generate_sphere(shape, radius + thickness / 2, anti_aliasing)
    inner = generate_sphere(shape, radius - thickness / 2, anti_aliasing)
    return outer - inner


def generate_ring(shape, radius, thickness=1, anti_aliasing=2):
    """Annulus mask, the FRC integration element."""
    outer = generate_disk(shape, radius + thickness / 2, anti_aliasing)
    inner = generate_disk(shape, radius - thickness / 2, anti_aliasing)
    return outer - inner


def upsample_2x(arr):
    """Nearest-neighbour 2x upsampling along the first three axes (numpy),
    for the multiscale schedule."""
    out = arr
    for ax in range(min(3, arr.ndim)):
        out = np.repeat(out, 2, axis=ax)
    return out


def ramp_filter(arr, axis=2, filter_type='hamming'):
    """Frequency-domain 1D window filter along ``axis``, for FBP-style
    tomography."""
    import scipy.signal.windows

    n = arr.shape[axis]
    filt = torch.as_tensor(getattr(scipy.signal.windows, filter_type)(n),
                           dtype=torch.float32, device=arr.device)
    arr = torch.movedim(arr, axis, -1)
    f = torch.fft.fft(arr.to(torch.complex64), dim=-1) * filt
    arr = torch.real(torch.fft.ifft(f, dim=-1))
    return torch.movedim(arr, -1, axis)
