"""Second-order object optimizers: Curveball (Gauss-Newton) and conjugate
gradients with an Armijo line search (``adorym_tpu/optim/second_order.py``).

The Gauss-Newton-vector product is reverse mode (``torch.autograd.grad``
through one retained forward), forward mode (``torch.autograd.forward_ad``
dual tensors, through the multislice kernels' forward-mode rules) and the
loss's Hessian along the prediction (``torch.func``).  The Armijo search's
``lax.while_loop`` is a host loop here: its condition is read on the host,
one synchronization a loss evaluation (:data:`LINE_SEARCH_EVALS` counts
them).  Scalars stay float32 tensors on the object's device, so the
arithmetic is the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

#: ``jnp.linalg.pinv``'s default cut-off for Curveball's 2x2 system,
#: ``10 max(m, n) eps`` of f32; ``torch.linalg.pinv``'s own default is ten
#: times smaller and keeps singular values the JAX package drops (Curveball's
#: first step, at z = 0, has a singular system by construction).
PINV_RTOL = float(10 * 2 * np.finfo(np.float32).eps)

#: Loss evaluations of the Armijo search, each a host synchronization.
LINE_SEARCH_EVALS = {'count': 0}


# ---------------------------------------------------------------------------
# Gauss-Newton-vector product
# ---------------------------------------------------------------------------

def make_gvp(pred_fn: Callable, loss_pred_fn: Callable, obj, reduce=None):
    """Return ``(gvp, full_grad, pred)`` for the Gauss-Newton curvature
    ``J^T H J`` at ``obj``.

    ``pred_fn(obj) -> prediction``; ``loss_pred_fn(pred) -> scalar`` (the
    data mismatch only: the curvature is the loss's with respect to the
    prediction, so regularizers drop out).  ``J v`` is a forward-mode pass
    through ``pred_fn``; ``J^T u`` a reverse pass through one retained
    forward.  ``reduce``: a sum of this process's products with the other
    data-parallel ranks' (each rank's prediction covers its share of the
    batch), applied to the gradient and to every product."""
    red = reduce or (lambda t: t)
    x = obj.detach().requires_grad_(True)
    with torch.enable_grad():
        pred_g = pred_fn(x)
    pred = pred_g.detach()
    loss_grad_fn = torch.func.grad(loss_pred_fn)

    def vjp_from_pred(u):
        return torch.autograd.grad(pred_g, x, grad_outputs=u,
                                   retain_graph=True)[0]

    def jvp_to_pred(v):
        with torch.no_grad(), fwAD.dual_level():
            out = pred_fn(fwAD.make_dual(obj.detach(), v))
            return fwAD.unpack_dual(out).tangent

    def hvp(v):
        return torch.func.jvp(loss_grad_fn, (pred,), (v,))[1]

    def gvp(v):
        return red(vjp_from_pred(hvp(jvp_to_pred(v))))

    full_grad = red(vjp_from_pred(loss_grad_fn(pred)))
    return gvp, full_grad, pred


# ---------------------------------------------------------------------------
# Curveball
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CurveballSpec:
    alpha: float = 1.0
    lmbda_init: float = 1.0
    lmbda_factor: float = 0.999   # trust-region adaptation rate


def curveball_init(obj) -> Dict:
    return {'z': torch.zeros_like(obj),
            'lmbda': torch.ones((), dtype=torch.float32, device=obj.device)}


def _dot(a, b):
    return torch.sum(a * b)


def curveball_step(pred_fn, loss_pred_fn, loss_obj_fn, obj, state,
                   spec: CurveballSpec = CurveballSpec(), reduce=None,
                   psum=None):
    """One Curveball update:

      dz   = GVP(z) + lambda z + grad
      (beta, rho) from the 2x2 subspace system
      z   <- rho z - beta dz;  obj <- obj + alpha z
      lambda adapted from the quadratic model's fit ratio gamma.

    The gradient and ``loss_0`` are the data term's (``loss_pred_fn``),
    ``loss_1`` the full loss's (``loss_obj_fn``, regularizers included),
    as in the JAX package.  Under a mesh ``reduce`` sums the data term and
    the curvature products over the data axis and ``psum`` the dot
    products of the object's slabs over the object axis.  Returns ``(obj,
    state, loss_0)``."""
    z, lmbda = state['z'], state['lmbda']
    gvp, g, pred = make_gvp(pred_fn, loss_pred_fn, obj, reduce)
    ps = psum or (lambda t: t)

    def _dot(a, b):
        return ps(torch.sum(a * b))

    with torch.no_grad():
        loss_0 = loss_pred_fn(pred)
        if reduce is not None:
            loss_0 = reduce(loss_0)
        gz = gvp(z)
        dz = gz + lmbda * z + g
        gdz = gvp(dz)
        a11 = _dot(dz, gdz) + lmbda * _dot(dz, dz)
        a12 = _dot(z, gdz) + lmbda * _dot(z, dz)
        a22 = _dot(z, gz) + lmbda * _dot(z, z)
        b1 = _dot(g, dz)
        b2 = _dot(g, z)
        a = torch.stack([torch.stack([a11, a12]), torch.stack([a12, a22])])
        b = torch.stack([b1, b2])[:, None]
        a_inv_b = torch.linalg.pinv(a, rtol=PINV_RTOL) @ b
        p = -a_inv_b
        beta, rho = -p[0, 0], p[1, 0]
        z_new = rho * z - beta * dz
        obj_new = obj + spec.alpha * z_new
        loss_1 = loss_obj_fn(obj_new)
        d_quad = -0.5 * torch.sum(a_inv_b * b)
        gamma = (loss_1 - loss_0) / torch.where(d_quad == 0,
                                                torch.ones_like(d_quad),
                                                d_quad)
        lmbda_new = torch.where(
            gamma > 1.5, lmbda * spec.lmbda_factor,
            torch.where(gamma < 0.5, lmbda / spec.lmbda_factor, lmbda))
    return obj_new, {'z': z_new, 'lmbda': lmbda_new}, loss_0


# ---------------------------------------------------------------------------
# Conjugate gradient + Armijo line search
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CGSpec:
    initial_stepsize: float = 10.0
    contraction_factor: float = 0.5
    optimism: float = 2.0
    suff_decr: float = 1e-4
    stepsize_threshold_low: float = 1e-10
    maxiter: int = 16
    normalize_alpha: bool = True


def cg_init(obj) -> Dict:
    dev = obj.device
    return {'s': torch.zeros_like(obj),
            'g_old': torch.zeros_like(obj),
            'alpha_suggested': torch.zeros((), dtype=torch.float32,
                                           device=dev),
            'first': torch.ones((), dtype=torch.bool, device=dev)}


@torch.no_grad()
def _armijo_search(loss_obj_fn, obj, s, g, f0, alpha0, spec: CGSpec,
                   psum=None):
    """Backtracking Armijo line search, the JAX package's
    ``lax.while_loop`` as a host loop with the same condition and
    bookkeeping: the first evaluation at ``alpha0``, then the step
    contracted while the sufficient decrease fails and the step stays
    above ``stepsize_threshold_low``, at most ``maxiter + 1`` evaluations.
    Returns ``(newx, newf, alpha, step_count)``; a step that does not
    lower the loss is refused (``newx = obj``, ``alpha = 0``).  ``psum``:
    the sum of a dot product over the object's slabs (a mesh)."""
    df0 = torch.sum(s * g)
    if psum is not None:
        df0 = psum(df0)
    alpha = alpha0
    newf = torch.full((), float('inf'), dtype=torch.float32, device=obj.device)
    count = 0
    while count <= spec.maxiter:
        if count > 0:
            not_done = newf > f0 + spec.suff_decr * alpha * df0
            if not bool(not_done & (alpha > spec.stepsize_threshold_low)):
                break
            alpha = alpha * spec.contraction_factor
        newf = loss_obj_fn(obj + alpha * s)
        LINE_SEARCH_EVALS['count'] += 1
        count += 1
    ok = (newf <= f0).to(obj.dtype)
    newx = ok * (obj + alpha * s) + (1.0 - ok) * obj
    return (newx, torch.where(ok > 0, newf, f0),
            torch.where(ok > 0, alpha, torch.zeros_like(alpha)), count)


@torch.no_grad()
def cg_step(loss_obj_fn, obj, g, f0, state, spec: CGSpec = CGSpec(),
            psum=None):
    """One Polak-Ribiere CG update with the adaptive line search: the
    direction falls back to steepest descent where it is not a descent
    direction; the first trial step is the last accepted one's suggestion
    (after 1 evaluation, ``optimism`` times it; after 2, the same; after
    more, ``optimism`` times the contracted step), else
    ``initial_stepsize`` over the direction's norm.  ``psum``: the sum of
    a dot product over the object's slabs (a mesh).  Returns ``(obj,
    state, loss)``."""
    ps = psum or (lambda t: t)
    d = -g
    d_old = -state['g_old']
    beta_num = ps(torch.sum(d * (d - d_old)))
    beta_den = ps(torch.sum(d_old * d_old))
    beta = torch.where(
        state['first'], torch.zeros_like(beta_num),
        torch.clamp(beta_num / torch.where(beta_den == 0,
                                           torch.ones_like(beta_den),
                                           beta_den), min=0.0))
    s = d + beta * state['s']
    s = torch.where(ps(torch.sum(s * g)) >= 0, d, s)

    s_norm = torch.sqrt(ps(torch.sum(s * s)))
    alpha_default = (spec.initial_stepsize / torch.clamp(s_norm, min=1e-30)
                     if spec.normalize_alpha else
                     torch.full_like(s_norm, spec.initial_stepsize))
    a_sug = state['alpha_suggested']
    alpha0 = torch.where(a_sug > 0, a_sug, alpha_default)

    newx, newf, alpha, count = _armijo_search(loss_obj_fn, obj, s, g, f0,
                                              alpha0, spec, psum)
    suggested = alpha if count == 2 else spec.optimism * alpha
    new_state = {'s': s, 'g_old': g,
                 'alpha_suggested': suggested.to(torch.float32),
                 'first': torch.zeros((), dtype=torch.bool,
                                      device=obj.device)}
    return newx, new_state, newf
