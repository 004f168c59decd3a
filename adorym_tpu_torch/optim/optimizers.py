"""First-order optimizers as pure (init, apply) functions on tensors
(``adorym_tpu/optim/optimizers.py``), with the reference's exact math.

The step counter is a host int here; the bias corrections and the GD step
schedule are computed in float32 as the JAX package computes them."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptSpec:
    """Static optimizer hyperparameters for one parameter leaf."""
    kind: str = 'adam'               # adam | momentum | gd
    step_size: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-7                # reference default
    gamma: float = 0.9               # momentum decay
    dynamic_rate: bool = True        # GD step-halving schedule
    first_downrate_iteration: int = 92


def opt_init(spec: OptSpec, param) -> Dict[str, Any]:
    """State for one leaf."""
    if spec.kind == 'adam':
        return {'m': torch.zeros_like(param), 'v': torch.zeros_like(param)}
    if spec.kind == 'momentum':
        return {'v': torch.zeros_like(param)}
    if spec.kind == 'gd':
        return {}
    raise ValueError(f'unknown optimizer kind {spec.kind}')


def _gd_step_size(spec: OptSpec, i_batch: int) -> float:
    """GD dynamic halving: the step halves whenever ``i_batch`` crosses
    ``f*(2^n - 1)``, n = 1, 2, ..."""
    if not spec.dynamic_rate:
        return spec.step_size
    f = np.float32(spec.first_downrate_iteration)
    n = np.floor(np.log2(np.float32(max(i_batch - 1, 0)) / f
                         + np.float32(1.0)))
    return float(np.float32(spec.step_size)
                 * np.float32(0.5) ** np.float32(max(n, 0.0)))


def opt_apply(spec: OptSpec, param, grad, state: Dict[str, Any],
              i_batch: int):
    """One update for one leaf; returns ``(param, state)``.

      adam:     bias-corrected, eps after the sqrt
      momentum: velocity = gamma*v + lr*g; x -= v
      gd:       x -= lr(i) * g
    """
    if spec.kind == 'adam':
        m = spec.b1 * state['m'] + (1 - spec.b1) * grad
        v = spec.b2 * state['v'] + (1 - spec.b2) * grad * grad
        t = np.float32(i_batch + 1)
        bc1 = float(np.float32(1) - np.float32(spec.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(spec.b2) ** t)
        param = param - spec.step_size * (m / bc1) / (torch.sqrt(v / bc2)
                                                      + spec.eps)
        return param, {'m': m, 'v': v}
    if spec.kind == 'momentum':
        v = spec.gamma * state['v'] + spec.step_size * grad
        return param - v, {'v': v}
    if spec.kind == 'gd':
        return param - _gd_step_size(spec, i_batch) * grad, state
    raise ValueError(f'unknown optimizer kind {spec.kind}')


def tree_init(specs: Dict[str, OptSpec], params: Dict[str, Any]):
    """Optimizer state for every leaf that has a spec."""
    return {k: opt_init(specs[k], params[k]) for k in specs}


def tree_apply(specs: Dict[str, OptSpec], params: Dict[str, Any],
               grads: Dict[str, Any], states: Dict[str, Any], i_batch: int,
               update_mask: Optional[Dict[str, bool]] = None):
    """Per-leaf updates; ``update_mask[k]`` False leaves leaf ``k`` and its
    state unchanged (probe update windows, auxiliary delays)."""
    new_params = dict(params)
    new_states = dict(states)
    for k, spec in specs.items():
        if update_mask is not None and not update_mask.get(k, True):
            continue
        new_params[k], new_states[k] = opt_apply(spec, params[k], grads[k],
                                                 states[k], i_batch)
    return new_params, new_states
