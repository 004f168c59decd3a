"""Refinable parameters, optimizer specs, constraints and update gates:
the obj/probe subset of ``adorym_tpu/optim/params.py``.  Every parameter
is a real float32 tensor (complex quantities are ``[..., 2]`` pairs):
obj ``[y, x, z, 2]``, probe ``[n_modes, py, px, 2]``."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import ReconConfig
from .optimizers import OptSpec

#: Refinements beyond obj/probe (ROADMAP A, remaining model families and
#: refinables), by their config flag.
_AUX_FLAGS = ('optimize_probe_defocusing', 'optimize_probe_pos_offset',
              'optimize_prj_pos_offset', 'optimize_all_probe_pos',
              'optimize_slice_pos', 'optimize_free_prop', 'optimize_tilt',
              'fixed_tilt', 'optimize_prj_affine', 'optimize_ctf_lg_kappa')

_FIRST_ORDER_KINDS = ('adam', 'momentum', 'gd')


def build_aux_params(cfg: ReconConfig, n_theta: int, n_pos: int,
                     device='cpu') -> Dict[str, torch.Tensor]:
    """The auxiliary refinable parameters beyond obj/probe: none in this
    slice; a run that asks for one raises."""
    on = [f for f in _AUX_FLAGS if getattr(cfg.refine, f)]
    if on:
        raise NotImplementedError(
            f'refinables {on}: ROADMAP A, remaining model families and '
            'refinables (only obj and probe are ported)')
    return {}


def _aux_spec(name: str, kind: str, lr: float) -> OptSpec:
    if kind not in _FIRST_ORDER_KINDS:
        raise ValueError(
            f'optimizer kind {kind!r} for {name!r}: auxiliary parameters '
            f'support first-order kinds {_FIRST_ORDER_KINDS} only')
    return OptSpec(kind=kind, step_size=lr)


def build_opt_specs(cfg: ReconConfig) -> Dict[str, OptSpec]:
    """Per-leaf optimizer specs: the object's configured optimizer and,
    when refined, the probe's."""
    r = cfg.refine
    t = cfg.train
    if t.optimizer not in _FIRST_ORDER_KINDS:
        raise NotImplementedError(
            f'object optimizer {t.optimizer!r}: ROADMAP A, API and tools '
            '(second-order optimizers)')
    specs: Dict[str, OptSpec] = {}
    if t.optimize_object:
        specs['obj'] = OptSpec(kind=t.optimizer, step_size=t.learning_rate)
    if r.optimize_probe:
        specs['probe'] = _aux_spec('probe', r.probe_optimizer,
                                   r.probe_learning_rate)
    return specs


def apply_param_constraints(params: Dict[str, torch.Tensor],
                            cfg: ReconConfig) -> Dict[str, torch.Tensor]:
    """Post-update stabilizers of the auxiliary refinables; obj and probe
    have none, so this returns ``params`` as they are."""
    return dict(params)


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
