"""Object-prior regularizers (``adorym_tpu/models/regularizers.py``): each
is a small frozen dataclass whose ``__call__(obj, weight_l1=None,
axis_offset=0)`` returns a scalar tensor, differentiable by autograd.  The
reweighted-L1 weights are an explicit tensor the Reconstructor refreshes
(``Reconstructor._weight_l1_refresh``)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..ops.image import (image_gradient, pearson_corr_along_last,
                         total_variation_3d)


@dataclasses.dataclass(frozen=True)
class Regularizer:
    unknown_type: str = 'delta_beta'

    def __call__(self, obj, weight_l1=None, axis_offset=0):
        return 0.0


def _mag_phase_channels(obj, unknown_type):
    c0 = obj[..., 0]
    c1 = obj[..., 1]
    if unknown_type == 'real_imag':
        return torch.sqrt(c0 ** 2 + c1 ** 2), torch.atan2(c1, c0)
    return c0, c1


@dataclasses.dataclass(frozen=True)
class L1Regularizer(Regularizer):
    """Mean absolute delta and beta (delta_beta), or the magnitude's
    deviation from its mean and the phase (real_imag)."""
    alpha_d: float = 0.0
    alpha_b: float = 0.0

    def __call__(self, obj, weight_l1=None, axis_offset=0):
        reg = 0.0
        if self.unknown_type == 'delta_beta':
            if self.alpha_d:
                reg = reg + self.alpha_d * torch.mean(torch.abs(obj[..., 0]))
            if self.alpha_b:
                reg = reg + self.alpha_b * torch.mean(torch.abs(obj[..., 1]))
        else:
            om, ph = _mag_phase_channels(obj, 'real_imag')
            if self.alpha_d:
                reg = reg + self.alpha_d * torch.mean(
                    torch.abs(om - torch.mean(om)))
            if self.alpha_b:
                reg = reg + self.alpha_b * torch.mean(torch.abs(ph))
        return reg


@dataclasses.dataclass(frozen=True)
class ReweightedL1Regularizer(Regularizer):
    """L1 weighted by ``weight_l1`` (the object's shape), which the
    Reconstructor refreshes every 10 batches (immediate) or every angle
    (per angle)."""
    alpha_d: float = 0.0
    alpha_b: float = 0.0

    def __call__(self, obj, weight_l1=None, axis_offset=0):
        if weight_l1 is None:
            raise ValueError('ReweightedL1Regularizer needs weight_l1')
        reg = 0.0
        if self.unknown_type == 'delta_beta':
            if self.alpha_d:
                reg = reg + self.alpha_d * torch.mean(
                    weight_l1[..., 0] * torch.abs(obj[..., 0]))
            if self.alpha_b:
                reg = reg + self.alpha_b * torch.mean(
                    weight_l1[..., 1] * torch.abs(obj[..., 1]))
        else:
            om, ph = _mag_phase_channels(obj, 'real_imag')
            wm = weight_l1[..., 0] ** 2 + weight_l1[..., 1] ** 2
            if self.alpha_d:
                reg = reg + self.alpha_d * torch.mean(
                    wm * torch.abs(om - torch.mean(om)))
            if self.alpha_b:
                reg = reg + self.alpha_b * torch.mean(wm * torch.abs(ph))
        return reg


@dataclasses.dataclass(frozen=True)
class TVRegularizer(Regularizer):
    """3D total variation of both channels (of the intensity and the phase
    for real_imag)."""
    gamma: float = 0.0

    def __call__(self, obj, weight_l1=None, axis_offset=0):
        if self.unknown_type == 'delta_beta':
            o1, o2 = obj[..., 0], obj[..., 1]
        else:
            r, i = obj[..., 0], obj[..., 1]
            o1, o2 = r ** 2 + i ** 2, torch.atan2(i, r)
        return self.gamma * (total_variation_3d(o1, axis_offset)
                             + total_variation_3d(o2, axis_offset))


@dataclasses.dataclass(frozen=True)
class CorrRegularizer(Regularizer):
    """Inter-slice Pearson correlation."""
    gamma: float = 0.0

    def __call__(self, obj, weight_l1=None, axis_offset=0):
        o1, o2 = _mag_phase_channels(obj, self.unknown_type)
        return self.gamma * (pearson_corr_along_last(o1)
                             + pearson_corr_along_last(o2))


@dataclasses.dataclass(frozen=True)
class GradCorrRegularizer(Regularizer):
    """Correlation of the slices' gradient maps."""
    gamma: float = 0.0

    def __call__(self, obj, weight_l1=None, axis_offset=0):
        o1, o2 = _mag_phase_channels(obj, self.unknown_type)
        nd = o1.dim()
        axes = (nd - 3, nd - 2)
        g1 = image_gradient(o1, axes)
        g2 = image_gradient(o2, axes)
        return self.gamma * (pearson_corr_along_last(g1)
                             + pearson_corr_along_last(g2))


def total_regularization(reg_list: Sequence[Regularizer], obj,
                         weight_l1=None, axis_offset=0):
    reg = 0.0
    for r in reg_list:
        reg = reg + r(obj, weight_l1=weight_l1, axis_offset=axis_offset)
    return reg
