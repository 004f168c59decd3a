"""Object and probe initialization (``adorym_tpu/utils/initialize.py``):
host-side numpy, run once at setup, with the JAX package's numpy draws, so
both packages start from the same arrays bit for bit."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..constants import wavelength_nm
from ..ops.image import generate_disk, generate_gaussian_map, upsample_2x


def initialize_object(obj_size: Tuple[int, int, int],
                      unknown_type='delta_beta', object_type='normal',
                      initial_guess=None,
                      random_guess_means_sigmas=(8.7e-7, 5.1e-8, 1e-7, 1e-8),
                      non_negativity=False, previous_pass=None,
                      seed: Optional[int] = None) -> np.ndarray:
    """Initial object ``[y, x, z, 2]`` float32: Gaussian-random with the
    given means and sigmas of delta and beta, the ``initial_guess``
    (delta, beta) pair, or the coarser multiscale level's ``previous_pass``
    (delta, beta) upsampled 2x and perturbed."""
    rng = np.random.default_rng(seed)
    md, mb, sd, sb = random_guess_means_sigmas
    if previous_pass is not None:
        crop = (slice(0, obj_size[0]), slice(0, obj_size[1]),
                slice(0, obj_size[2]))
        obj_delta = upsample_2x(previous_pass[0])[crop]
        obj_beta = upsample_2x(previous_pass[1])[crop]
        obj_delta = obj_delta + rng.normal(md, sd, size=obj_size)
        obj_beta = obj_beta + rng.normal(mb, sb, size=obj_size)
    elif initial_guess is None:
        obj_delta = rng.normal(md, sd, size=obj_size)
        obj_beta = rng.normal(mb, sb, size=obj_size)
    else:
        obj_delta = np.array(initial_guess[0], dtype=np.float64)
        obj_beta = np.array(initial_guess[1], dtype=np.float64)

    if object_type == 'phase_only':
        if unknown_type == 'delta_beta':
            obj_beta[...] = 0
        else:
            obj_delta[...] = 1
    elif object_type == 'absorption_only':
        if unknown_type == 'delta_beta':
            obj_delta[...] = 0
        else:
            obj_beta[...] = 0

    if unknown_type == 'delta_beta' and non_negativity:
        obj_delta = np.clip(obj_delta, 0, None)
        obj_beta = np.clip(obj_beta, 0, None)
    elif unknown_type == 'real_imag':
        obj_delta, obj_beta = (obj_delta * np.cos(obj_beta),
                               obj_delta * np.sin(obj_beta))
    return np.stack([obj_delta, obj_beta], axis=-1).astype(np.float32)


def _fresnel_propagate_np(wave: np.ndarray, dist_nm, lmbda_nm, psize_nm,
                          sign_convention=1) -> np.ndarray:
    """Fresnel propagation by the transfer function, complex128."""
    u = np.fft.fftfreq(wave.shape[-2])[:, None] / psize_nm
    v = np.fft.fftfreq(wave.shape[-1])[None, :] / psize_nm
    h = np.exp(-sign_convention * 1j * np.pi * lmbda_nm * dist_nm
               * (u ** 2 + v ** 2))
    return np.fft.ifft2(np.fft.fft2(wave) * h)


def initialize_probe(probe_size, probe_type, *, pupil_function=None,
                     probe_initial=None, n_probe_modes=1,
                     energy_ev=None, psize_cm=None, sign_convention=1,
                     extra_defocus_cm=None, data_for_ifft=None,
                     data_for_rescale=None, raw_data_type='magnitude',
                     normalize_fft=False, rescale_intensity=False,
                     seed: Optional[int] = None,
                     **kwargs) -> np.ndarray:
    """Initial probe ``[n_modes, py, px, 2]`` float32.

    probe_type:
      'gaussian'          kwargs: probe_mag_sigma, probe_phase_sigma,
                          probe_phase_max
      'aperture_defocus'  kwargs: aperture_radius, probe_defocus_cm,
                          (beamstop_radius)
      'ifft'              back-propagate the mean measured magnitude
      'supplied'/'fixed'  probe_initial = (mag, phase)
      'plane'             unit amplitude
    then the pupil, an extra defocus and the intensity rescale to the data.
    """
    lmbda_nm = wavelength_nm(energy_ev) if energy_ev else None
    if probe_type == 'gaussian':
        mag, phase = generate_gaussian_map(
            probe_size, 1.0, kwargs['probe_mag_sigma'],
            kwargs['probe_phase_max'], kwargs['probe_phase_sigma'])
        pr, pi = mag * np.cos(phase), mag * np.sin(phase)
    elif probe_type == 'aperture_defocus':
        mag = generate_disk(probe_size, kwargs['aperture_radius'])
        beamstop_radius = kwargs.get('beamstop_radius', 0)
        if beamstop_radius > 0:
            mag = mag * (1 - generate_disk(probe_size, beamstop_radius))
        wave = _fresnel_propagate_np(mag.astype(np.complex128),
                                     kwargs['probe_defocus_cm'] * 1e7,
                                     lmbda_nm, psize_cm * 1e7,
                                     sign_convention)
        pr, pi = wave.real, wave.imag
    elif probe_type == 'ifft':
        dat = np.abs(np.asarray(data_for_ifft))
        if raw_data_type == 'intensity':
            dat = np.sqrt(dat)
        mean_mag = dat.mean(axis=tuple(range(dat.ndim - 2)))
        if sign_convention == 1:
            wave = np.fft.ifft2(np.fft.ifftshift(mean_mag))
        else:
            wave = np.fft.fft2(np.fft.ifftshift(mean_mag))
        pr, pi = wave.real, wave.imag
    elif probe_type in ('supplied', 'fixed'):
        mag, phase = probe_initial
        pr, pi = mag * np.cos(phase), mag * np.sin(phase)
    elif probe_type == 'plane':
        pr = np.ones(probe_size)
        pi = np.zeros(probe_size)
    else:
        raise ValueError(f'invalid probe_type {probe_type}')

    if pupil_function is not None:
        pr = pr * pupil_function
        pi = pi * pupil_function
    if extra_defocus_cm is not None:
        wave = _fresnel_propagate_np(pr + 1j * pi, extra_defocus_cm * 1e7,
                                     lmbda_nm, psize_cm * 1e7,
                                     sign_convention)
        pr, pi = wave.real, wave.imag
    if rescale_intensity and data_for_rescale is not None:
        dat = np.abs(np.asarray(data_for_rescale))
        if raw_data_type == 'magnitude':
            dat = dat ** 2
        total = np.sum(np.mean(np.abs(dat), axis=(0, 1)))
        if normalize_fft:
            target = total
        elif sign_convention == 1:
            # An unnormalized FFT multiplies the total power by the
            # number of pixels.
            target = total / np.prod(probe_size)
        else:
            target = total * np.prod(probe_size)
        s = np.sqrt(target / np.sum(pr ** 2 + pi ** 2))
        pr, pi = pr * s, pi * s

    probe = np.stack([pr, pi], axis=-1).astype(np.float32)   # [py, px, 2]
    if probe.ndim == 3:
        probe = np.tile(probe[None], (n_probe_modes, 1, 1, 1))
        if n_probe_modes > 1:
            # Break the modes' degeneracy with small noise.
            rng = np.random.default_rng(seed)
            probe[1:] += rng.normal(0, probe.std() * 0.1,
                                    size=probe[1:].shape).astype(np.float32)
    return probe
