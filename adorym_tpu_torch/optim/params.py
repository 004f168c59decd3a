"""Refinable parameters, optimizer specs, constraints and update gates
(``adorym_tpu/optim/params.py``).  Every parameter is a real float32
tensor (complex quantities are ``[..., 2]`` pairs):

  obj                  [y, x, z, 2]
  probe                [n_modes, py, px, 2]
  probe_defocus_mm     [1]
  probe_pos_offset     [n_theta, 2]
  prj_pos_offset       [n_theta, 2]
  probe_pos_correction [n_theta, n_pos, 2]   ([n_dists, 2] multi-distance)
  slice_pos_cm_ls      [n_slices]
  free_prop_cm         [n_dists]
  tilt_ls              [3, n_theta]
  prj_affine_ls        [n_dists, 2, 3]
  ctf_lg_kappa         [1]

A fixed tilt (``fixed_tilt``) is a ``tilt_ls`` leaf without an optimizer
spec: the model reads it and nothing updates it."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import ReconConfig
from .optimizers import OptSpec

_FIRST_ORDER_KINDS = ('adam', 'momentum', 'gd')

_EYE_2X3 = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0))


def build_aux_params(cfg: ReconConfig, n_theta: int, n_pos: int,
                     device='cpu', probe_pos_correction_init=None,
                     slice_pos_cm_ls=None, free_prop_cm=None,
                     tilt_init=None, prj_affine_init=None,
                     ctf_lg_kappa_init=None) -> Dict[str, torch.Tensor]:
    """The auxiliary refinable parameters beyond obj/probe that the config
    switches on, at their initial values on ``device``: zeros for the
    defocus and the offsets; ``probe_pos_correction`` from its ``_init``
    or zeros (``[n_dists, 2]`` with several distances, else ``[n_theta,
    n_pos, 2]``); ``slice_pos_cm_ls`` from ``slice_pos_cm_ls``;
    ``free_prop_cm`` from ``free_prop_cm`` or the geometry's distances;
    ``tilt_ls`` (refined or fixed) from ``tilt_init`` or zeros;
    ``prj_affine_ls`` from its ``_init`` or the identity at each distance;
    ``ctf_lg_kappa`` from its ``_init`` or log10 of the configured
    ``ctf_kappa``."""
    r = cfg.refine
    geo = cfg.geometry

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    params: Dict[str, torch.Tensor] = {}
    if r.optimize_probe_defocusing:
        params['probe_defocus_mm'] = t(np.zeros(1))
    if r.optimize_probe_pos_offset:
        params['probe_pos_offset'] = t(np.zeros((n_theta, 2)))
    if r.optimize_prj_pos_offset:
        params['prj_pos_offset'] = t(np.zeros((n_theta, 2)))
    if r.optimize_all_probe_pos:
        if probe_pos_correction_init is not None:
            params['probe_pos_correction'] = t(probe_pos_correction_init)
        elif geo.n_dists > 1:
            # One registration shift per distance.
            params['probe_pos_correction'] = t(np.zeros((geo.n_dists, 2)))
        else:
            params['probe_pos_correction'] = t(np.zeros((n_theta, n_pos, 2)))
    if r.optimize_slice_pos:
        if slice_pos_cm_ls is None:
            raise ValueError('optimize_slice_pos needs slice_pos_cm_ls')
        params['slice_pos_cm_ls'] = t(slice_pos_cm_ls)
    if r.optimize_free_prop:
        fp = free_prop_cm if free_prop_cm is not None else geo.free_prop_cm
        if isinstance(fp, str):
            raise ValueError('optimize_free_prop needs a finite '
                             f'free_prop_cm, got {fp!r}')
        params['free_prop_cm'] = t(np.atleast_1d(np.asarray(fp)))
    if r.tilt_active:
        params['tilt_ls'] = t(tilt_init if tilt_init is not None
                              else np.zeros((3, n_theta)))
    if r.optimize_prj_affine:
        params['prj_affine_ls'] = t(
            prj_affine_init if prj_affine_init is not None
            else np.tile(np.asarray(_EYE_2X3)[None], (geo.n_dists, 1, 1)))
    if r.optimize_ctf_lg_kappa:
        if ctf_lg_kappa_init is None:
            ctf_lg_kappa_init = float(np.log10(cfg.train.ctf_kappa))
        params['ctf_lg_kappa'] = t(np.full(1, ctf_lg_kappa_init))
    return params


def _aux_spec(name: str, kind: str, lr: float) -> OptSpec:
    if kind not in _FIRST_ORDER_KINDS:
        raise ValueError(
            f'optimizer kind {kind!r} for {name!r}: auxiliary parameters '
            f'support first-order kinds {_FIRST_ORDER_KINDS} only')
    return OptSpec(kind=kind, step_size=lr)


def build_opt_specs(cfg: ReconConfig) -> Dict[str, OptSpec]:
    """Per-leaf optimizer specs: the object's configured optimizer (a
    first-order kind, or ``'cg'`` / ``'curveball'``, whose state the
    Reconstructor keeps itself); each refined auxiliary leaf its own
    first-order kind and learning rate."""
    r = cfg.refine
    t = cfg.train
    specs: Dict[str, OptSpec] = {}
    if t.optimize_object:
        specs['obj'] = OptSpec(kind=t.optimizer, step_size=t.learning_rate)
    aux = [
        ('probe', r.optimize_probe, r.probe_optimizer,
         r.probe_learning_rate),
        ('probe_defocus_mm', r.optimize_probe_defocusing,
         r.probe_defocusing_optimizer, r.probe_defocusing_learning_rate),
        ('probe_pos_offset', r.optimize_probe_pos_offset,
         r.probe_pos_offset_optimizer, r.probe_pos_offset_learning_rate),
        ('prj_pos_offset', r.optimize_prj_pos_offset,
         r.prj_pos_offset_optimizer, r.prj_pos_offset_learning_rate),
        ('probe_pos_correction', r.optimize_all_probe_pos,
         r.all_probe_pos_optimizer, r.all_probe_pos_learning_rate),
        ('slice_pos_cm_ls', r.optimize_slice_pos,
         r.slice_pos_optimizer, r.slice_pos_learning_rate),
        ('free_prop_cm', r.optimize_free_prop,
         r.free_prop_optimizer, r.free_prop_learning_rate),
        ('tilt_ls', r.optimize_tilt, r.tilt_optimizer, r.tilt_learning_rate),
        ('prj_affine_ls', r.optimize_prj_affine,
         r.prj_affine_optimizer, r.prj_affine_learning_rate),
        ('ctf_lg_kappa', r.optimize_ctf_lg_kappa,
         r.ctf_lg_kappa_optimizer, r.ctf_lg_kappa_learning_rate),
    ]
    for name, on, kind, lr in aux:
        if on:
            specs[name] = _aux_spec(name, kind, lr)
    return specs


def apply_param_constraints(params: Dict[str, torch.Tensor],
                            cfg: ReconConfig) -> Dict[str, torch.Tensor]:
    """Post-update stabilizers of the auxiliary refinables:
    ``probe_pos_correction`` loses its mean over all leading axes (the
    positions cannot drift together), slice 0 of ``slice_pos_cm_ls`` stays
    at 0, and distance 0's ``prj_affine_ls`` stays the identity."""
    params = dict(params)
    if 'probe_pos_correction' in params:
        ppc = params['probe_pos_correction']
        params['probe_pos_correction'] = ppc - ppc.mean(
            dim=tuple(range(ppc.dim() - 1)), keepdim=True)
    if 'slice_pos_cm_ls' in params:
        sp = params['slice_pos_cm_ls']
        params['slice_pos_cm_ls'] = sp - sp[0]
    if 'prj_affine_ls' in params:
        aff = params['prj_affine_ls'].clone()
        aff[0] = torch.tensor(_EYE_2X3, dtype=aff.dtype, device=aff.device)
        params['prj_affine_ls'] = aff
    return params


def apply_object_constraints(obj: torch.Tensor, cfg: ReconConfig,
                             mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Object-side constraints after each update: non-negativity,
    phase-only/absorption-only projections, finite-support mask."""
    t = cfg.train
    if t.non_negativity and t.unknown_type != 'real_imag':
        obj = torch.clamp(obj, min=0.0)
    if t.unknown_type == 'delta_beta':
        if t.object_type == 'absorption_only':
            obj = obj.clone()
            obj[..., 0] = 0.0
        elif t.object_type == 'phase_only':
            obj = obj.clone()
            obj[..., 1] = 0.0
    else:
        re, im = obj[..., 0], obj[..., 1]
        norm = torch.sqrt(re ** 2 + im ** 2)
        if t.object_type == 'absorption_only':
            obj = torch.stack([norm, torch.zeros_like(im)], -1)
        elif t.object_type == 'phase_only':
            safe = torch.clamp(norm, min=1e-12)
            obj = torch.stack([re / safe, im / safe], -1)
    if mask is not None:
        m = mask.to(obj.dtype)
        while m.dim() < obj.dim():
            m = m[..., None]
        if t.unknown_type == 'real_imag':
            vac = torch.stack([torch.ones_like(obj[..., 0]),
                               torch.zeros_like(obj[..., 1])], -1)
            obj = obj * m + vac * (1 - m)
        else:
            obj = obj * m
    return obj


def probe_update_gate(cfg: ReconConfig, global_batch_index: int) -> bool:
    """Probe-update window: update only when
    ``probe_update_delay <= i < probe_update_limit``."""
    r = cfg.refine
    hi = r.probe_update_limit if r.probe_update_limit is not None else np.inf
    return r.probe_update_delay <= global_batch_index < hi


def aux_update_gate(cfg: ReconConfig, global_batch_index: int) -> bool:
    """Auxiliary refinables (everything but obj/probe) stay frozen until
    ``other_params_update_delay`` global batches have run."""
    return global_batch_index >= cfg.refine.other_params_update_delay
