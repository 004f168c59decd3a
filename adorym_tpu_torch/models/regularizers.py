"""Object-prior regularizers (``adorym_tpu/models/regularizers.py``): each
is a small frozen dataclass whose ``__call__(obj, weight_l1=None,
axis_offset=0, shard=None)`` returns a scalar tensor, differentiable by
autograd.  The reweighted-L1 weights are an explicit tensor the
Reconstructor refreshes (``Reconstructor._weight_l1_refresh``).

``shard``: the object is one y slab of an object split over a mesh's
'op' axis (:class:`..parallel.halo.SlabShard`); the value is then the
whole object's on every rank: means and the correlations' sums go over
the axis, and the circular y differences take the previous slab's last
row."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..ops.image import (image_gradient, pearson_corr_along_last,
                         total_variation_3d)


@dataclasses.dataclass(frozen=True)
class Regularizer:
    unknown_type: str = 'delta_beta'

    def __call__(self, obj, weight_l1=None, axis_offset=0, shard=None):
        return 0.0


def _mean(x, shard):
    if shard is None:
        return torch.mean(x)
    return shard.sum(torch.sum(x)) / (x.numel() * shard.n)


def _tv3d_sharded(arr, shard):
    """:func:`total_variation_3d` of a y slab (axes 0, 1, 2)."""
    ext = shard.prev_rows(arr, 1)
    res = torch.sum(torch.abs(ext[:-1] - ext[1:]))
    for ax in (1, 2):
        res = res + torch.sum(torch.abs(torch.roll(arr, 1, dims=ax) - arr))
    return shard.sum(res) / (arr.numel() * shard.n)


def _pearson_sharded(arr, shard):
    """:func:`pearson_corr_along_last` of a y slab ``[y, x, z]``."""
    n = arr.shape[0] * arr.shape[1] * shard.n
    mean = shard.sum(torch.sum(arr, dim=(0, 1))) / n
    centered = arr - mean
    nom = shard.sum(torch.sum(torch.prod(centered, dim=-1)))
    std = torch.sqrt(shard.sum(torch.sum(centered ** 2, dim=(0, 1))) / n)
    return torch.abs(nom / torch.prod(std))


def _image_gradient_sharded(arr, shard):
    """:func:`image_gradient` of a y slab over axes (y, x)."""
    ext = shard.prev_rows(arr, 1)
    return (ext[:-1] - arr) ** 2 + (torch.roll(arr, 1, dims=1) - arr) ** 2


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

    def __call__(self, obj, weight_l1=None, axis_offset=0, shard=None):
        reg = 0.0
        if self.unknown_type == 'delta_beta':
            if self.alpha_d:
                reg = reg + self.alpha_d * _mean(torch.abs(obj[..., 0]),
                                                 shard)
            if self.alpha_b:
                reg = reg + self.alpha_b * _mean(torch.abs(obj[..., 1]),
                                                 shard)
        else:
            om, ph = _mag_phase_channels(obj, 'real_imag')
            if self.alpha_d:
                reg = reg + self.alpha_d * _mean(
                    torch.abs(om - _mean(om, shard)), shard)
            if self.alpha_b:
                reg = reg + self.alpha_b * _mean(torch.abs(ph), shard)
        return _finish(reg, shard)


@dataclasses.dataclass(frozen=True)
class ReweightedL1Regularizer(Regularizer):
    """L1 weighted by ``weight_l1`` (the object's shape), which the
    Reconstructor refreshes every 10 batches (immediate) or every angle
    (per angle)."""
    alpha_d: float = 0.0
    alpha_b: float = 0.0

    def __call__(self, obj, weight_l1=None, axis_offset=0, shard=None):
        if weight_l1 is None:
            raise ValueError('ReweightedL1Regularizer needs weight_l1')
        reg = 0.0
        if self.unknown_type == 'delta_beta':
            if self.alpha_d:
                reg = reg + self.alpha_d * _mean(
                    weight_l1[..., 0] * torch.abs(obj[..., 0]), shard)
            if self.alpha_b:
                reg = reg + self.alpha_b * _mean(
                    weight_l1[..., 1] * torch.abs(obj[..., 1]), shard)
        else:
            om, ph = _mag_phase_channels(obj, 'real_imag')
            wm = weight_l1[..., 0] ** 2 + weight_l1[..., 1] ** 2
            if self.alpha_d:
                reg = reg + self.alpha_d * _mean(
                    wm * torch.abs(om - _mean(om, shard)), shard)
            if self.alpha_b:
                reg = reg + self.alpha_b * _mean(wm * torch.abs(ph), shard)
        return _finish(reg, shard)


@dataclasses.dataclass(frozen=True)
class TVRegularizer(Regularizer):
    """3D total variation of both channels (of the intensity and the phase
    for real_imag)."""
    gamma: float = 0.0

    def __call__(self, obj, weight_l1=None, axis_offset=0, shard=None):
        if self.unknown_type == 'delta_beta':
            o1, o2 = obj[..., 0], obj[..., 1]
        else:
            r, i = obj[..., 0], obj[..., 1]
            o1, o2 = r ** 2 + i ** 2, torch.atan2(i, r)
        if shard is not None:
            return _finish(self.gamma * (_tv3d_sharded(o1, shard)
                                         + _tv3d_sharded(o2, shard)), shard)
        return self.gamma * (total_variation_3d(o1, axis_offset)
                             + total_variation_3d(o2, axis_offset))


@dataclasses.dataclass(frozen=True)
class CorrRegularizer(Regularizer):
    """Inter-slice Pearson correlation."""
    gamma: float = 0.0

    def __call__(self, obj, weight_l1=None, axis_offset=0, shard=None):
        o1, o2 = _mag_phase_channels(obj, self.unknown_type)
        if shard is not None:
            return _finish(self.gamma * (_pearson_sharded(o1, shard)
                                         + _pearson_sharded(o2, shard)),
                           shard)
        return self.gamma * (pearson_corr_along_last(o1)
                             + pearson_corr_along_last(o2))


@dataclasses.dataclass(frozen=True)
class GradCorrRegularizer(Regularizer):
    """Correlation of the slices' gradient maps."""
    gamma: float = 0.0

    def __call__(self, obj, weight_l1=None, axis_offset=0, shard=None):
        o1, o2 = _mag_phase_channels(obj, self.unknown_type)
        if shard is not None:
            return _finish(self.gamma * (
                _pearson_sharded(_image_gradient_sharded(o1, shard), shard)
                + _pearson_sharded(_image_gradient_sharded(o2, shard),
                                   shard)), shard)
        nd = o1.dim()
        axes = (nd - 3, nd - 2)
        g1 = image_gradient(o1, axes)
        g2 = image_gradient(o2, axes)
        return self.gamma * (pearson_corr_along_last(g1)
                             + pearson_corr_along_last(g2))


def total_regularization(reg_list: Sequence[Regularizer], obj,
                         weight_l1=None, axis_offset=0, shard=None):
    reg = 0.0
    for r in reg_list:
        if shard is None:
            reg = reg + r(obj, weight_l1=weight_l1, axis_offset=axis_offset)
        else:
            reg = reg + r(obj, weight_l1=weight_l1, axis_offset=axis_offset,
                          shard=shard)
    return reg


def _finish(reg, shard):
    """A sharded regularizer's value (the whole object's, on every rank)
    into the backward once (:meth:`..parallel.halo.SlabShard.finish`)."""
    if shard is None or not torch.is_tensor(reg):
        return reg
    return shard.finish(reg)
