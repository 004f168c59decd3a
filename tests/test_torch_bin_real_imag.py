"""The real_imag z binning in one pass (``propagate.bin_real_imag``) against
the JAX package's ``_pad_z_to_multiple`` and ``_bin_slices`` of both
channels, value and VJP, on seeded inputs with exact zeros and short tail
bins; and the propagator's real_imag branch built on it, whose autograd
graph holds no product or channel-select backward.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adorym_tpu.ops import propagate as jprop
from adorym_tpu_torch.ops import propagate as tprop


def _stack(nz, seed=0, dtype=np.float32):
    """Packed patches ``[3, 4, 5, nz, 2]`` near 1 (a transmission), with
    exact zeros: one in a bin, two in another bin of the same pixel's
    real channel, and a whole slice of both channels."""
    rng = np.random.default_rng(seed)
    x = (1.0 + 0.3 * rng.normal(size=(3, 4, 5, nz, 2))).astype(np.float32)
    x[0, 0, 0, 1, 0] = 0.0
    x[1, 2, 3, 0, 0] = x[1, 2, 3, nz - 1, 0] = 0.0
    x[2, 1, 4, nz // 2, :] = 0.0
    return x.astype(dtype)


def _jax_bin(stack, binning, cot):
    """JAX's binning of both channels and the real loss ``sum(Re t c0 +
    Im t c1)`` with its gradient on the packed stack."""
    def f(x):
        chans = []
        for c in (0, 1):
            a = jnp.moveaxis(x[..., c], -1, 0)
            a = jprop._pad_z_to_multiple(a, binning, 'real_imag')
            chans.append(jprop._bin_slices(a, binning, 'real_imag'))
        loss = jnp.sum(chans[0].astype(jnp.float32) * cot[..., 0]
                       + chans[1].astype(jnp.float32) * cot[..., 1])
        return loss, chans

    (_, chans), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(stack))
    return [np.asarray(c.astype(jnp.float32)) for c in chans], grad


def _torch_bin(stack, binning, cot, dtype=torch.float32):
    x = torch.from_numpy(np.asarray(stack, np.float32)).to(dtype)
    x.requires_grad_()
    t = tprop.bin_real_imag(x, binning)
    c = torch.from_numpy(cot)
    loss = (t.real * c[..., 0] + t.imag * c[..., 1]).sum()
    (grad,) = torch.autograd.grad(loss, x)
    return t.detach(), grad


#: (nz, binning): bins of 4 with a tail of 3, whole bins of 8, a tail bin
#: alone, and no binning.
CASES = [(11, 4), (16, 8), (5, 8), (6, 1)]


# f32: products of at most 8 factors in another order than XLA's, a few
# ulps; 1e-6 relative elementwise (exact zeros compare exactly).
@pytest.mark.parametrize('nz,binning', CASES)
def test_bin_real_imag_matches_jax(nz, binning):
    """Value and VJP in f32: ``t`` is complex64 ``[S, N, py, px]`` with
    ``S = ceil(nz / binning)``, each channel the product over its bin."""
    stack = _stack(nz, seed=nz)
    n_bins = -(-nz // binning)
    cot = np.random.default_rng(1).normal(size=(n_bins, 3, 4, 5, 2)).astype(
        np.float32)
    (re_j, im_j), g_j = _jax_bin(stack, binning, cot)
    t, g = _torch_bin(stack, binning, cot)
    assert t.dtype == torch.complex64 and tuple(t.shape) == (n_bins, 3, 4, 5)
    np.testing.assert_allclose(t.real.numpy(), re_j, rtol=1e-6)
    np.testing.assert_allclose(t.imag.numpy(), im_j, rtol=1e-6)
    assert g.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-6)


def test_bin_real_imag_zeros_give_exact_gradients():
    """A bin with one zero passes the product of the others to that slice
    alone; a bin with two zeros passes nothing."""
    stack = _stack(11, seed=11)
    cot = np.ones((3, 3, 4, 5, 2), np.float32)
    _, g = _torch_bin(stack, 4, cot)
    g = g.numpy()
    # Pixel (0, 0, 0), real channel: slice 1 of the first bin is zero.
    want = np.prod(stack[0, 0, 0, [0, 2, 3], 0])
    assert g[0, 0, 0, 1, 0] == pytest.approx(want, rel=1e-6)
    assert np.all(g[0, 0, 0, [0, 2, 3], 0] == 0.0)
    # Pixel (1, 2, 3), real channel: zeros in the first and the tail bin
    # (slices 0 and 10), one each.
    assert np.all(g[1, 2, 3, 1:4, 0] == 0.0) and g[1, 2, 3, 0, 0] != 0.0


# bf16 storage: JAX multiplies in bf16 and returns bf16; the port
# multiplies the same bf16 values in f32 and keeps the product in f32, so
# the two differ by JAX's roundings (up to 2^-8 relative after a product
# of 4).  The gradients are bf16 both sides, each rounded from products of
# 3 factors: within 2 bf16 ulps of the larger magnitude.
@pytest.mark.parametrize('nz,binning', [(11, 4), (16, 8)])
def test_bin_real_imag_bf16_within_bf16_rounding(nz, binning):
    stack = _stack(nz, seed=nz + 1, dtype=jnp.bfloat16)
    n_bins = -(-nz // binning)
    cot = np.random.default_rng(2).normal(size=(n_bins, 3, 4, 5, 2)).astype(
        np.float32)
    (re_j, im_j), g_j = _jax_bin(stack, binning, cot)
    t, g = _torch_bin(stack, binning, cot, torch.bfloat16)
    assert g.dtype == torch.bfloat16
    # The exact product of the bf16 inputs, in f64.
    x = np.asarray(stack, np.float64)
    pad = n_bins * binning - nz
    x = np.concatenate([x, np.ones(x.shape[:3] + (pad, 2))], 3)
    exact = x.reshape(3, 4, 5, n_bins, binning, 2).prod(4)
    exact = np.moveaxis(exact, 3, 0)
    np.testing.assert_allclose(t.real.numpy(), exact[..., 0], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(t.imag.numpy(), exact[..., 1], rtol=1e-6,
                               atol=1e-7)
    for got, want in ((t.real.numpy(), re_j), (t.imag.numpy(), im_j)):
        assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want) + 1e-7)
    gf, gj = g.float().numpy(), np.asarray(g_j.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(gf), np.abs(gj))
                                   + 1e-30)) - 7)
    assert np.all(np.abs(gf - gj) <= 2 * ulp)


def _backward_nodes(t):
    """Every autograd node behind ``t``, by name, and the names of the
    nodes that pass a gradient straight to a leaf."""
    seen, todo, names, into_leaf = set(), [t.grad_fn], set(), set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        for f, _ in fn.next_functions:
            if type(f).__name__ == 'AccumulateGrad':
                into_leaf.add(type(fn).__name__)
            todo.append(f)
    return names, into_leaf


@pytest.mark.parametrize('binning', [1, 3, 8])
def test_propagator_real_imag_branch_bins_in_one_pass(binning):
    """``multislice_propagate`` with a real_imag ``db_stack``: the same
    exit wave as from the channels binned apart (the stack's own channels,
    given as delta and beta without the stack), and a graph in which the
    stack's gradient comes from ``BinRealImag`` alone, with no product
    backward anywhere."""
    rng = np.random.default_rng(binning)
    nz, n = 10, 8
    stack = torch.from_numpy(
        (1.0 + 0.05 * rng.normal(size=(3, n, n, nz, 2))).astype(np.float32))
    wave = torch.from_numpy((rng.normal(size=(1, 3, n, n))
                             + 1j * rng.normal(size=(1, 3, n, n))).astype(
                                 np.complex64))
    kw = dict(energy_ev=5000.0, psize_cm=1e-7, binning=binning,
              unknown_type='real_imag', fused=False)
    x = stack.clone().requires_grad_()
    out = tprop.multislice_propagate(x[..., 0], x[..., 1], wave,
                                     db_stack=x, **kw)
    ref = tprop.multislice_propagate(stack[..., 0], stack[..., 1], wave,
                                     **kw)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    nodes, into_leaf = _backward_nodes(out)
    assert into_leaf == {'BinRealImagBackward'}
    assert not any(name.startswith(('ProdBackward', 'CumprodBackward'))
                   for name in nodes), nodes
