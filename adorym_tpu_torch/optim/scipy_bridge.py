"""scipy.optimize for whole-dataset batch optimization of the object
(``adorym_tpu/optim/scipy_bridge.py``): the loss, its gradient (autograd)
and the Gauss-Newton ``hessp`` (:func:`.second_order.make_gvp`) evaluated
on the device, wrapped as float64 numpy callables for
``scipy.optimize.minimize``.  Meant, as in the reference, for
single-minibatch (full-batch) problems, where CG and Newton-CG
convergence theory applies."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..recon import resolve_device
from .second_order import make_gvp


def scipy_minimize_object(loss_obj_fn: Callable, obj0, method='CG',
                          options: Optional[dict] = None,
                          pred_fn: Optional[Callable] = None,
                          loss_pred_fn: Optional[Callable] = None,
                          step_size: float = 1.0, device=None):
    """Minimize ``loss_obj_fn(obj)`` over the object with scipy.

    ``obj0``: an array or a tensor; ``loss_obj_fn`` maps a float32 tensor
    of its shape on the device (``None`` means CUDA) to a scalar tensor.  ``pred_fn`` and
    ``loss_pred_fn`` give Newton-CG and the trust-region methods the
    Gauss-Newton ``hessp``.  Returns the optimized object, a float32 numpy
    array."""
    import scipy.optimize

    dev = resolve_device(device)
    if torch.is_tensor(obj0):
        obj0 = obj0.detach().cpu().numpy()
    shape = tuple(np.shape(obj0))

    def to_t(x):
        return torch.as_tensor(np.asarray(x, np.float32).reshape(shape),
                               device=dev)

    def fun(x):
        with torch.no_grad():
            return float(loss_obj_fn(to_t(x)))

    def jac(x):
        o = to_t(x).requires_grad_(True)
        with torch.enable_grad():
            g, = torch.autograd.grad(loss_obj_fn(o), o)
        return g.double().cpu().numpy().ravel() * step_size

    hessp = None
    if pred_fn is not None and loss_pred_fn is not None:
        def hessp(x, p):
            gvp, _, _ = make_gvp(pred_fn, loss_pred_fn, to_t(x))
            with torch.no_grad():
                out = gvp(to_t(p))
            return out.double().cpu().numpy().ravel()

    res = scipy.optimize.minimize(fun, np.asarray(obj0, np.float64).ravel(),
                                  method=method, jac=jac, hessp=hessp,
                                  options=options)
    return np.asarray(res.x, np.float32).reshape(shape)
