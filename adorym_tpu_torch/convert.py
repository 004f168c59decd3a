"""Carry parameters and optimizer state between the JAX package and the
port.  Both keep the same layouts — obj ``[y, x, z, 2]``, probe
``[n_modes, py, px, 2]``, Adam ``m``/``v`` per leaf, momentum ``v`` — so
the conversion is a change of array type and device; the optimizer's
step counter travels as a plain int."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def params_from_jax(params_np: Dict[str, Any],
                    opt_state_np: Optional[Dict[str, Dict[str, Any]]] = None,
                    device='cuda'
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Optional[Dict[str, Dict[str, torch.Tensor]]]]:
    """JAX-package parameters (and optimizer state), as numpy arrays or
    anything ``np.asarray`` takes, to float32 tensors on ``device``."""
    def to_t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32),
                               device=device)

    params = {k: to_t(v) for k, v in params_np.items()}
    if opt_state_np is None:
        return params, None
    state = {k: {n: to_t(a) for n, a in st.items()}
             for k, st in opt_state_np.items()}
    return params, state


def params_to_numpy(params: Dict[str, torch.Tensor],
                    opt_state: Optional[Dict[str, Dict[str, torch.Tensor]]]
                    = None):
    """The port's parameters (and optimizer state) as numpy arrays in the
    JAX package's layouts."""
    out = {k: v.detach().cpu().numpy() for k, v in params.items()}
    if opt_state is None:
        return out, None
    return out, {k: {n: a.detach().cpu().numpy() for n, a in st.items()}
                 for k, st in opt_state.items()}
