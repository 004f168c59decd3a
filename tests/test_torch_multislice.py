"""The port's multislice kernels, plain versions, against the JAX package's
Pallas kernel pairs (``multislice_db_stored_packed`` and
``multislice_fused``, interpret mode).

Both take the same numpy inputs; gradients are compared on real
parameters (db, and the wave as a real pair), where PyTorch's and JAX's
complex conventions agree.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adorym_tpu.ops import pallas_multislice as pm
from adorym_tpu.ops import propagate as jprop
from adorym_tpu_torch.ops import cuda_multislice as cm
from adorym_tpu_torch.ops import cuda_multislice_fused as cmf
from adorym_tpu_torch.ops import propagate as tprop

K1, S_SIGN = 25.0, 1.0


def _inputs(S, M, N, n, seed=0):
    rng = np.random.default_rng(seed)
    db = rng.uniform(0, 0.02, (S, 2, N, n, n)).astype(np.float32)
    wpair = (rng.normal(size=(M, N, n, n, 2)) * 0.5).astype(np.float32)
    cot = rng.normal(size=(M, N, n, n, 2)).astype(np.float32)
    return db, wpair, cot


def _jax(db, wpair, cot, n, final, dtype):
    h = jprop.fresnel_kernel((n, n), (1.0, 1.0, 1.0), 0.1, 20.0)
    fmats = (jprop.final_prop_mats((n, n), (1.0, 1.0), 0.1, 'inf')[:2]
             if final else (None, None))

    def f(db, wp):
        wave = (wp[..., 0] + 1j * wp[..., 1]).astype(jnp.complex64)
        out = pm.multislice_db_stored_packed(db, wave, h, K1, S_SIGN, True,
                                             False, *fmats)
        return jnp.sum(jnp.real(out) * cot[..., 0]
                       + jnp.imag(out) * cot[..., 1]), out

    (_, out), (gdb, gw) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(db, dtype), jnp.asarray(wpair))
    return (np.asarray(out), np.asarray(gdb.astype(jnp.float32)),
            np.asarray(gw))


def _torch(db, wpair, cot, n, final, dtype):
    h = tprop.fresnel_kernel((n, n), (1.0, 1.0, 1.0), 0.1, 20.0)
    fmats = (tprop.final_prop_mats((n, n), (1.0, 1.0), 0.1, 'inf')[:2]
             if final else (None, None))
    db_t = torch.from_numpy(db).to(dtype).requires_grad_()
    wp = torch.from_numpy(wpair).requires_grad_()
    out = cm.multislice_db_stored_packed(db_t, torch.view_as_complex(wp), h,
                                         K1, S_SIGN, *fmats)
    c = torch.from_numpy(cot)
    loss = (out.real * c[..., 0] + out.imag * c[..., 1]).sum()
    gdb, gw = torch.autograd.grad(loss, (db_t, wp))
    return (out.detach().numpy(), gdb.float().numpy(), gw.numpy())


def _close(a, b, rtol):
    """Max error relative to the largest reference magnitude."""
    err = np.max(np.abs(a - b)) / np.max(np.abs(b))
    assert err < rtol, err


@pytest.mark.parametrize('M', [1, 2])
@pytest.mark.parametrize('final', [False, True])
def test_plain_matches_pallas_f32(M, final):
    """f32: forward to 1e-5, gradients to 1e-4 of the largest value."""
    db, wpair, cot = _inputs(4, M, 3, 16)
    o_j, gdb_j, gw_j = _jax(db, wpair, cot, 16, final, jnp.float32)
    o_t, gdb_t, gw_t = _torch(db, wpair, cot, 16, final, torch.float32)
    _close(o_t, o_j, 1e-5)
    _close(gdb_t, gdb_j, 1e-4)
    _close(gw_t, gw_j, 1e-4)


@pytest.mark.parametrize('final', [False, True])
def test_plain_matches_pallas_bf16(final):
    """bf16 db: the same bf16 values in; the Pallas kernel rounds its
    records and gdb to bf16 where the plain version keeps f32, so the
    gradients agree to bf16 precision only (loose: 3e-2)."""
    db, wpair, cot = _inputs(4, 2, 3, 16, seed=1)
    o_j, gdb_j, gw_j = _jax(db, wpair, cot, 16, final, jnp.bfloat16)
    o_t, gdb_t, gw_t = _torch(db, wpair, cot, 16, final, torch.bfloat16)
    _close(o_t, o_j, 1e-5)
    _close(gdb_t, gdb_j, 3e-2)
    _close(gw_t, gw_j, 3e-2)


def test_fold_prop_mats_match():
    """The folded per-axis Fresnel matrices, built in complex64 both
    sides."""
    h_j = jprop.fresnel_kernel((12, 16), (1.0, 1.0, 1.0), 0.1, 20.0)
    py_j, px_j = pm._fold_prop_mats(jnp.real(h_j), jnp.imag(h_j), 12, 16)
    h_t = tprop.fresnel_kernel((12, 16), (1.0, 1.0, 1.0), 0.1, 20.0)
    py_t, px_t = cm._fold_prop_mats(h_t)
    np.testing.assert_allclose(py_t.numpy(), np.asarray(py_j), atol=2e-6)
    np.testing.assert_allclose(px_t.numpy(), np.asarray(px_j), atol=2e-6)


def test_bound_counts():
    """The flagship numbers the bounds are built from: the transforms
    counted as FFTs, 31 propagations and the far field, 11.7 GFLOP."""
    assert cm.fft2_flops(72, 72) == pytest.approx(
        5 * 72 * 72 * np.log2(72 * 72))
    assert cm.flops(32, 1, 529, 72, 72) == pytest.approx(11.70e9, rel=1e-3)
    assert cm.flops(32, 1, 529, 72, 72, backward=True) == pytest.approx(
        12.22e9, rel=1e-3)
    assert cm.bytes_moved(32, 1, 529, 72, 72, 4) == pytest.approx(
        1.448e9, rel=1e-3)
    # One block per (patch, mode): the wave, a scratch plane, two mats.
    assert cm.smem_bytes(72, 72) == 165888


# -- K5: the general fused multislice ---------------------------------------

def _fused_inputs(S, M, N, n, seed=0):
    rng = np.random.default_rng(seed)
    tpair = (rng.normal(size=(S, N, n, n, 2)) * 0.1).astype(np.float32)
    tpair[..., 0] += 1.0
    wpair = (rng.normal(size=(M, N, n, n, 2)) * 0.5).astype(np.float32)
    cot = rng.normal(size=(M, N, n, n, 2)).astype(np.float32)
    return tpair, wpair, cot


# Paraxial: the separable Fresnel kernel.  Non-paraxial at a wavelength
# long enough that the square root bends the phase and the evanescent
# corners of the spectrum are masked: H is not separable.
TRANSFER = {'paraxial': dict(lmbda=0.1, dist=20.0, approx=True),
            'non_paraxial': dict(lmbda=1.6, dist=3.0, approx=False)}


def _kernel(mod, n, which):
    kw = TRANSFER[which]
    return mod.fresnel_kernel((n, n), (1.0, 1.0, 1.0), kw['lmbda'],
                              kw['dist'], fresnel_approx=kw['approx'])


@pytest.mark.parametrize('which', sorted(TRANSFER))
@pytest.mark.parametrize('M', [1, 2])
def test_fused_plain_matches_pallas(M, which):
    """S=4 steps, N=3 patches of 16x16: forward to 1e-5, the gradients on
    t and on the wave, each as a real pair, to 1e-4 of the largest
    value."""
    n = 16
    tpair, wpair, cot = _fused_inputs(4, M, 3, n)
    h_j = _kernel(jprop, n, which)

    def f(tp, wp):
        t = (tp[..., 0] + 1j * tp[..., 1]).astype(jnp.complex64)
        wave = (wp[..., 0] + 1j * wp[..., 1]).astype(jnp.complex64)
        out = pm.multislice_fused(t, wave, h_j, True)
        return jnp.sum(jnp.real(out) * cot[..., 0]
                       + jnp.imag(out) * cot[..., 1]), out

    (_, o_j), (gt_j, gw_j) = jax.value_and_grad(f, argnums=(0, 1),
                                                has_aux=True)(
        jnp.asarray(tpair), jnp.asarray(wpair))
    tp = torch.from_numpy(tpair).requires_grad_()
    wp = torch.from_numpy(wpair).requires_grad_()
    out = cmf.multislice_fused(torch.view_as_complex(tp),
                               torch.view_as_complex(wp),
                               _kernel(tprop, n, which))
    c = torch.from_numpy(cot)
    gt_t, gw_t = torch.autograd.grad(
        (out.real * c[..., 0] + out.imag * c[..., 1]).sum(), (tp, wp))
    _close(out.detach().numpy(), np.asarray(o_j), 1e-5)
    _close(gt_t.numpy(), np.asarray(gt_j), 1e-4)
    _close(gw_t.numpy(), np.asarray(gw_j), 1e-4)


def test_non_paraxial_kernel_is_not_separable():
    """The case the delta/beta kernel's folded matrices cannot take."""
    h = _kernel(tprop, 16, 'non_paraxial')
    sep = h[:, :1] * h[:1, :] / h[0, 0]
    assert float((h - sep).abs().max()) > 0.1
    assert int((h == 0).sum()) > 0


def test_fused_single_step_is_the_modulation():
    tpair, wpair, _ = _fused_inputs(1, 2, 3, 8)
    t = torch.view_as_complex(torch.from_numpy(tpair))
    w = torch.view_as_complex(torch.from_numpy(wpair))
    out = cmf.multislice_fused(t, w, _kernel(tprop, 8, 'paraxial'))
    np.testing.assert_array_equal(out.numpy(), (w * t[0]).numpy())


def test_fused_bound_counts():
    """The real_imag flagship numbers the bounds are built from: 31
    propagations counted as FFTs, 11.5 GFLOP (0.17 ms at 67 TFLOP/s),
    under 1.45 GB forward and 2.15 GB backward (0.43 / 0.64 ms at 3.35
    TB/s): bound by bytes."""
    assert cmf.flops(32, 1, 529, 72, 72) == pytest.approx(11.53e9, rel=1e-3)
    assert cmf.flops(32, 1, 529, 72, 72, backward=True) == pytest.approx(
        12.05e9, rel=1e-3)
    assert cmf.bytes_moved(32, 1, 529, 72, 72) == pytest.approx(
        1.448e9, rel=1e-3)
    assert cmf.bytes_moved(32, 1, 529, 72, 72, backward=True) == (
        pytest.approx(2.150e9, rel=1e-3))
    assert cmf.smem_bytes(1, 72, 72) == 124416
    assert cmf.smem_bytes(3, 72, 72) == 207360
    assert cmf.smem_bytes(4, 72, 72) > cm.MAX_SMEM_BYTES
