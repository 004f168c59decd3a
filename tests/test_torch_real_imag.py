"""The port's general fused multislice path against the JAX package's
Reconstructor on the same inputs: ``unknown_type='real_imag'`` (the grid
gather, full-depth patches binned by product, the general multislice),
delta_beta with the grid gather instead of the z-major extraction, and
delta_beta with a non-paraxial transfer function.

JAX runs with ``fused_multislice='on'`` so it reaches its Pallas kernels in
interpret mode; the port's ``'on'`` on the CPU runs the kernels' plain
versions.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import adorym_tpu.config as jcfg
import adorym_tpu.utils.profiling as jprof
from adorym_tpu.optim import params as jparams
from adorym_tpu.recon import Reconstructor as JaxReconstructor
from adorym_tpu.utils import initialize as jinit
import adorym_tpu_torch as pt
from adorym_tpu_torch.optim import params as tparams
from adorym_tpu_torch.utils import initialize as tinit
import adorym_tpu_torch.utils.profiling as tprof


def _setup(unknown_type, n=32, pn=16, n_theta=3, k=4, stride=4, seed=0):
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, np.pi, n_theta, endpoint=False)
    xs = np.arange(k) * stride
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    data = rng.random((n_theta, len(pos), pn, pn)).astype(np.float32)
    obj0 = (rng.random((n, n, n, 2)) * 1e-3).astype(np.float32)
    if unknown_type == 'real_imag':
        obj0[..., 0] += 1.0          # vacuum is (1, 0)
    return data, pos, theta, obj0


def _cfg(mod, unknown_type='real_imag', optimizer='gd', lr=1e-3,
         zmajor='on', n=32, pn=16, mb=4, binning=2, free_prop_cm='inf',
         fresnel_approx=True, fused='on', object_type='normal'):
    return mod.ReconConfig(
        geometry=mod.Geometry(obj_size=(n, n, n), probe_size=(pn, pn),
                              energy_ev=5000., psize_cm=1e-7,
                              free_prop_cm=free_prop_cm, binning=binning,
                              fresnel_approx=fresnel_approx),
        train=mod.TrainConfig(minibatch_size=mb, learning_rate=lr,
                              optimizer=optimizer, rotate_out_of_loop=True,
                              update_scheme='per angle',
                              unknown_type=unknown_type,
                              object_type=object_type,
                              fused_multislice=fused, zmajor_extract=zmajor))


def _both(n_epochs, **kw):
    data, pos, theta, obj0 = _setup(kw.get('unknown_type', 'real_imag'))
    jr = JaxReconstructor(_cfg(jcfg, **kw), data=data, probe_pos=pos,
                          theta_ls=theta, obj_init=obj0.copy())
    tr = pt.Reconstructor(_cfg(pt, **kw), data=data, probe_pos=pos,
                          theta_ls=theta, obj_init=obj0.copy(), device='cpu')
    jl = [jr.run_epoch(e) for e in range(n_epochs)]
    tl = [tr.run_epoch(e) for e in range(n_epochs)]
    return (np.asarray(jl), np.asarray(tl), np.asarray(jr.params['obj']),
            tr.obj, obj0)


def test_real_imag_gd_trajectory_matches_jax():
    """real_imag at 32^3, binning 2, 3 angles, a 4x4 grid, plain GD over 3
    epochs: losses to rtol 1e-5, the object's total update to 1e-4 of its
    largest entry (f32 noise of FFT vs DFT-matmul steps)."""
    jl, tl, jo, to, obj0 = _both(3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.max(np.abs(to - jo)) < 1e-4 * np.max(np.abs(jo - obj0))


@pytest.mark.parametrize('object_type', ['normal', 'phase_only',
                                         'absorption_only'])
def test_real_imag_init_and_constraints_match_jax(object_type):
    """The real_imag branches of ``initialize_object`` (the same draw from
    the same seed) and of ``apply_object_constraints`` (the projection
    after each update, without and with a finite-support mask, whose
    outside is set to vacuum), against the JAX package's."""
    kw = dict(unknown_type='real_imag', object_type=object_type, seed=3)
    np.testing.assert_array_equal(tinit.initialize_object((6, 5, 4), **kw),
                                  jinit.initialize_object((6, 5, 4), **kw))
    rng = np.random.default_rng(1)
    obj = (rng.normal(size=(6, 5, 4, 2)) * 0.1).astype(np.float32)
    obj[..., 0] += 1.0
    mask = (rng.random((6, 5, 4)) > 0.3).astype(np.float32)
    cj, ct = (_cfg(mod, object_type=object_type) for mod in (jcfg, pt))
    for m in (None, mask):
        want = jparams.apply_object_constraints(
            jnp.asarray(obj), cj, None if m is None else jnp.asarray(m))
        got = tparams.apply_object_constraints(
            torch.from_numpy(obj), ct, None if m is None
            else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_real_imag_adam_epoch_matches_jax_loosely():
    """Adam normalizes each entry's step, so f32 noise in a near-zero
    gradient can flip the entry's step sign: the loss tightly, the update
    loosely."""
    jl, tl, jo, to, obj0 = _both(1, optimizer='adam', lr=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.mean(np.abs(to - jo)) < 1e-2 * np.mean(np.abs(jo - obj0))


def test_delta_beta_grid_gather_matches_jax():
    """delta_beta with ``zmajor_extract='off'``: the chunk's patches come
    from the grid gather (``extract_grid2d_best``) in the patch-major
    layout, into the delta/beta kernel's plain version."""
    jl, tl, jo, to, obj0 = _both(3, unknown_type='delta_beta', zmajor='off')
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.max(np.abs(to - jo)) < 1e-4 * np.max(np.abs(jo - obj0))


@pytest.mark.parametrize('free_prop_cm', ['inf', 1e-5])
def test_non_paraxial_delta_beta_matches_jax(free_prop_cm):
    """delta_beta with ``fresnel_approx=False``: the delta/beta kernel does
    not take a transfer function that is not separable, so the general
    fused multislice runs, then the detector propagation (Fraunhofer, or
    the non-paraxial Fresnel transfer function at a finite distance)."""
    jl, tl, jo, to, obj0 = _both(2, unknown_type='delta_beta',
                                 fresnel_approx=False,
                                 free_prop_cm=free_prop_cm)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.max(np.abs(to - jo)) < 1e-4 * np.max(np.abs(jo - obj0))


def test_real_imag_flagship_chunk_on_an_80gb_card(monkeypatch):
    """The real_imag flagship moves full-depth patches (no prebin) and
    budgets six patch stacks per row: on an 80 GB card both packages'
    formulas give one whole angle (23 rows of the 23x23 grid) per chunk."""
    hbm = 85.0e9
    monkeypatch.setattr(jprof, 'hbm_limit_bytes', lambda *a: hbm)
    monkeypatch.setattr(tprof, 'hbm_limit_bytes', lambda *a: hbm)
    xs = np.arange(23) * 8 - 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    data = np.zeros((1, len(pos), 72, 72), np.float32)
    obj0 = np.zeros((256, 256, 256, 2), np.float32)
    kw = dict(optimizer='adam', lr=1e-7, n=256, pn=72, mb=23, binning=8,
              zmajor='auto', fused='auto')
    jr = JaxReconstructor(_cfg(jcfg, **kw), data=data, probe_pos=pos,
                          obj_init=obj0)
    tr = pt.Reconstructor(_cfg(pt, **kw), data=data, probe_pos=pos,
                          obj_init=obj0, device='cpu')
    assert not tr._prebin and not jr._prebin
    assert (tr._fuse_g, tr._grid_scatter_rows) == (jr._fuse_g,
                                                   jr._grid_scatter_rows)
    assert tr._grid_scatter_rows == 23
