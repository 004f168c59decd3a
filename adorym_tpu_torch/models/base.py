"""Measurement losses and detection (``adorym_tpu/models/base.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class _SafeSqrt(torch.autograd.Function):
    """sqrt whose derivative is clamped: ``0.5 / max(sqrt(x), 1e-6)``, in
    reverse and in forward mode.  Where the predicted intensity underflows
    to 0 in f32 the true derivative is infinite and would turn the whole
    gradient into NaN."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(y)
        ctx.save_for_forward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return grad * 0.5 / torch.clamp(y, min=1e-6)

    @staticmethod
    def jvp(ctx, dx):
        (y,) = ctx.saved_tensors
        return dx * 0.5 / torch.clamp(y, min=1e-6)


def safe_sqrt(x):
    return _SafeSqrt.apply(x)


def mismatch_loss(pred_mag, measured, loss_type='lsq',
                  raw_data_type='magnitude', poisson_multiplier=1.0,
                  beamstop_mask=None, per_item=False):
    """Data-mismatch loss on detected magnitudes:

      * ``lsq``: ``mean((pred - |I|)^2)`` (``sqrt(|I|)`` for intensity data)
      * ``poisson``: ``mean(pred^2 m - d m log(pred^2 m))`` with
        ``d = |I|^2`` (magnitude data) or ``|I|`` (intensity data).

    ``beamstop_mask``: optional {0,1} detector map; the mean runs over the
    unmasked pixels.  ``per_item=True`` returns the per-pattern means
    ``[N]``."""
    measured = torch.abs(measured)
    if loss_type == 'lsq':
        target = measured if raw_data_type == 'magnitude' else torch.sqrt(measured)
        per_pixel = (pred_mag - target) ** 2
    elif loss_type == 'poisson':
        m = poisson_multiplier
        d = measured ** 2 if raw_data_type == 'magnitude' else measured
        pred_i = pred_mag ** 2 * m
        per_pixel = pred_i - d * m * torch.log(torch.clamp(pred_i, min=1e-12))
    else:
        raise ValueError(f'unknown loss_function_type {loss_type}')
    pixel_axes = tuple(range(1, per_pixel.dim()))
    if beamstop_mask is not None:
        mask = beamstop_mask.to(per_pixel.dtype)
        if per_item:
            return (per_pixel * mask).sum(pixel_axes) / mask.sum()
        return (per_pixel * mask).sum() / (mask.sum() * pred_mag.shape[0])
    if per_item:
        return per_pixel.mean(pixel_axes)
    return per_pixel.mean()


def make_beamstop_mask(beamstop) -> Optional[np.ndarray]:
    """Threshold a raw beamstop map into a {0,1} float32 mask."""
    if beamstop is None:
        return None
    return (np.asarray(beamstop) >= 1e-5).astype(np.float32)


def incoherent_mode_sum(exit_waves):
    """Detected magnitude ``sqrt(sum_m |psi_m|^2)`` of per-mode waves
    ``[n_modes, ..., y, x]``."""
    inten = (exit_waves.real ** 2 + exit_waves.imag ** 2).sum(0)
    return safe_sqrt(inten)
