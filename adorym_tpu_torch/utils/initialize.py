"""Object and probe initialization (``adorym_tpu/utils/initialize.py``):
host-side numpy, run once at setup; the same numpy Generator draws as the
JAX package, so both start from identical arrays."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def initialize_object(obj_size: Tuple[int, int, int],
                      unknown_type='delta_beta', object_type='normal',
                      random_guess_means_sigmas=(8.7e-7, 5.1e-8, 1e-7, 1e-8),
                      non_negativity=False,
                      seed: Optional[int] = None) -> np.ndarray:
    """Initial object ``[y, x, z, 2]`` float32, Gaussian-random with the
    given means and sigmas of delta and beta."""
    rng = np.random.default_rng(seed)
    md, mb, sd, sb = random_guess_means_sigmas
    obj_delta = rng.normal(md, sd, size=obj_size)
    obj_beta = rng.normal(mb, sb, size=obj_size)

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


def _gaussian_map(size, mag_max, mag_sigma, phase_max, phase_sigma):
    """Centered Gaussian magnitude and phase maps."""
    py = np.arange(size[0]) - (size[0] - 1.0) / 2
    px = np.arange(size[1]) - (size[1] - 1.0) / 2
    pxx, pyy = np.meshgrid(px, py)
    r2 = pxx ** 2 + pyy ** 2
    return (mag_max * np.exp(-r2 / (2 * mag_sigma ** 2)),
            phase_max * np.exp(-r2 / (2 * phase_sigma ** 2)))


def initialize_probe(probe_size, probe_type, *, n_probe_modes=1,
                     seed: Optional[int] = None, **kwargs) -> np.ndarray:
    """Initial probe ``[n_modes, py, px, 2]`` float32.

    probe_type:
      'gaussian'  kwargs: probe_mag_sigma, probe_phase_sigma, probe_phase_max
      'plane'     unit amplitude
    (the other types are ROADMAP A, I/O and initialisation).
    """
    if probe_type == 'gaussian':
        mag, phase = _gaussian_map(
            probe_size, 1.0, kwargs['probe_mag_sigma'],
            kwargs['probe_phase_max'], kwargs['probe_phase_sigma'])
        pr, pi = mag * np.cos(phase), mag * np.sin(phase)
    elif probe_type == 'plane':
        pr = np.ones(probe_size)
        pi = np.zeros(probe_size)
    else:
        raise NotImplementedError(f'probe_type {probe_type!r}: ROADMAP A, '
                                  'I/O and initialisation')
    probe = np.stack([pr, pi], axis=-1).astype(np.float32)   # [py, px, 2]
    probe = np.tile(probe[None], (n_probe_modes, 1, 1, 1))
    if n_probe_modes > 1:
        # Break mode degeneracy with small noise.
        rng = np.random.default_rng(seed)
        probe[1:] += rng.normal(0, probe.std() * 0.1,
                                size=probe[1:].shape).astype(np.float32)
    return probe
