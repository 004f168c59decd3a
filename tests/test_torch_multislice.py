"""The port's multislice kernel, plain version, against the JAX package's
Pallas kernel pair (``multislice_db_stored_packed``, interpret mode).

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
    """The flagship numbers the bounds are built from."""
    assert cm.flops(32, 1, 529, 72, 72) == pytest.approx(75.8e9, rel=1e-3)
    assert cm.bytes_moved(32, 1, 529, 72, 72, 4) == pytest.approx(
        1.448e9, rel=1e-3)
    assert cm.smem_bytes(1, 72, 72) == 165888
