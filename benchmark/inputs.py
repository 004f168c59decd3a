"""A cell's inputs, made from ``--seed``: the measured magnitudes, the
object's starting value and the probe on the device (one
``torch.Generator`` there, a few large calls), the scan positions and the
angles from the traffic and configuration files.

Nothing here reads the program: the same inputs go to the program and to
the plain reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    data: torch.Tensor          # [n_theta, n_pos, py, px] f32 magnitudes
    obj: torch.Tensor           # [y, x, z, 2] f32 (delta, beta or re, im)
    probe: torch.Tensor         # [n_modes, py, px, 2] f32 (real, imag)
    positions: np.ndarray       # [n_pos, 2] float64, (y, x) pixels
    theta: np.ndarray           # [n_theta] float32 radians


def positions(traffic: dict) -> np.ndarray:
    """The scan table of a ``row_grid`` mix: ``grid[0]`` rows of
    ``grid[1]`` spots at ``stride_px``, the first at ``origin_px``, row by
    row (one row a minibatch when ``minibatch_size == grid[1]``)."""
    if traffic['kind'] != 'row_grid':
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    ny, nx = traffic['grid']
    s = traffic['stride_px']
    y0, x0 = traffic['origin_px']
    ys = y0 + s * np.arange(ny)
    xs = x0 + s * np.arange(nx)
    yy, xx = np.meshgrid(ys, xs, indexing='ij')
    return np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)


def angles(config: dict) -> np.ndarray:
    return np.linspace(config['theta_start'], config['theta_end'],
                       config['n_theta'], endpoint=False).astype(np.float32)


def gaussian_probe(config: dict, device) -> torch.Tensor:
    """The mode-0 probe ``[py, px, 2]``: a centred Gaussian magnitude of
    peak 1 with a Gaussian phase of peak ``phase_max``."""
    p = config['probe']
    py, px = config['probe_size']
    y = torch.arange(py, dtype=torch.float64, device=device) - (py - 1) / 2
    x = torch.arange(px, dtype=torch.float64, device=device) - (px - 1) / 2
    r2 = y[:, None] ** 2 + x[None, :] ** 2
    mag = torch.exp(-r2 / (2 * p['mag_sigma_px'] ** 2))
    phase = p['phase_max'] * torch.exp(-r2 / (2 * p['phase_sigma_px'] ** 2))
    return torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)],
                       -1).float()


#: The two forms of ``object_init``: each channel's mean and sigma, or the
#: delta_beta object's by name.
BY_CHANNEL = ('means', 'sigmas')
DELTA_BETA = ('delta_mean', 'delta_sigma', 'beta_mean', 'beta_sigma')


def object_start(config: dict):
    """``(means, sigmas)`` of the object's two channels from the
    configuration's ``object_init``: ``{"means": [m0, m1], "sigmas": [s0,
    s1]}`` (a real_imag vacuum start: means ``[1, 0]``, sigmas ``[0,
    0]``), or ``delta_mean``, ``delta_sigma``, ``beta_mean`` and
    ``beta_sigma``; any other set of keys fails."""
    o = config['object_init']
    if set(o) == set(BY_CHANNEL):
        means, sigmas = list(o['means']), list(o['sigmas'])
        if len(means) != 2 or len(sigmas) != 2:
            raise ValueError(f"configuration {config.get('name')!r}: "
                             'object_init means and sigmas take two '
                             'channels each')
    elif set(o) == set(DELTA_BETA):
        means = [o['delta_mean'], o['beta_mean']]
        sigmas = [o['delta_sigma'], o['beta_sigma']]
    else:
        raise ValueError(f"configuration {config.get('name')!r}: "
                         f'object_init has keys {sorted(o)}; it takes '
                         f'{list(BY_CHANNEL)} or {list(DELTA_BETA)}')
    return [float(m) for m in means], [float(s) for s in sigmas]


def make(config: dict, traffic: dict, seed: int, device) -> Inputs:
    """Every input of one run from ``seed``; the same seed gives the same
    inputs."""
    means, sigmas = object_start(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    pos = positions(traffic)
    py, px = config['probe_size']
    d = config['data']
    if d['kind'] != 'uniform':
        raise ValueError(f"unknown data kind {d['kind']!r}")
    data = torch.rand((config['n_theta'], len(pos), py, px), generator=gen,
                      device=device)
    if d['low'] != 0.0 or d['high'] != 1.0:
        data.mul_(d['high'] - d['low']).add_(d['low'])
    obj = torch.randn(tuple(config['obj_size']) + (2,), generator=gen,
                      device=device)
    for ch in range(2):
        obj[..., ch].mul_(sigmas[ch]).add_(means[ch])
    p = config['probe']
    base = gaussian_probe(config, device)
    weights = p['mode_weights']
    noise = torch.randn((len(weights),) + tuple(base.shape), generator=gen,
                        device=device)
    probe = torch.stack([w * base for w in weights])
    if p['mode_noise']:
        probe[1:] += p['mode_noise'] * noise[1:]
    if len(weights) != config['n_probe_modes']:
        raise ValueError('probe mode_weights must give n_probe_modes modes')
    return Inputs(data=data, obj=obj, probe=probe, positions=pos,
                  theta=angles(config))
