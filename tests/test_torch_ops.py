"""The port's ops, models and optimizers against their JAX counterparts,
on the same numpy inputs (f32; tolerances state their reason)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adorym_tpu.models import base as jbase
from adorym_tpu.ops import fourier as jfourier
from adorym_tpu.ops import patches as jpatches
from adorym_tpu.ops import propagate as jprop
from adorym_tpu.ops import rotate as jrot
from adorym_tpu.optim import optimizers as jopt
from adorym_tpu.optim import params as jparams
from adorym_tpu.utils import initialize as jinit
import adorym_tpu.config as jcfg
from adorym_tpu_torch.models import base as tbase
from adorym_tpu_torch.ops import fourier as tfourier
from adorym_tpu_torch.ops import patches as tpatches
from adorym_tpu_torch.ops import propagate as tprop
from adorym_tpu_torch.ops import rotate as trot
from adorym_tpu_torch.optim import optimizers as topt
from adorym_tpu_torch.optim import params as tparams
from adorym_tpu_torch.utils import initialize as tinit
import adorym_tpu_torch.config as tcfg

RNG = np.random.default_rng(0)


def _c(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(
        np.abs(np.asarray(b)))


# -- fourier ---------------------------------------------------------------

@pytest.mark.parametrize('name', ['fft2', 'ifft2', 'fft2_and_shift',
                                  'ifft2_and_shift'])
def test_fourier_transforms(name):
    x = _c((2, 3, 12, 10))
    want = getattr(jfourier, name)(jnp.asarray(x))
    got = getattr(tfourier, name)(torch.from_numpy(x))
    assert _rel(got.numpy(), want) < 1e-6


@pytest.mark.parametrize('n,inverse', [(8, False), (9, True), (72, False)])
def test_dft_matrix(n, inverse):
    np.testing.assert_array_equal(tfourier.dft_matrix(n, inverse),
                                  jfourier.dft_matrix(n, inverse))


# -- propagate -------------------------------------------------------------

@pytest.mark.parametrize('approx', [True, False])
def test_fresnel_kernel(approx):
    args = ((16, 12), (2.0, 2.5, 1.0), 0.248, 300.0)
    want = jprop.fresnel_kernel(*args, fresnel_approx=approx)
    got = tprop.fresnel_kernel(*args, fresnel_approx=approx)
    # Phases up to ~10 rad: f32 cos/sin of two libraries differ by ulps.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize('fp,norm,sign', [('inf', False, 1), ('inf', True, 1),
                                          ('inf', False, -1), (1e-4, False, 1)])
def test_final_prop_mats_and_free_space(fp, norm, sign):
    shape, voxel, lmbda = (12, 16), (1.0, 1.0, 1.0), 0.248
    want = jprop.final_prop_mats(shape, voxel, lmbda, fp, sign, norm)
    got = tprop.final_prop_mats(shape, voxel, lmbda, fp, sign, norm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x = _c((2, 12, 16))
    w_fs = jprop.free_space_propagate(jnp.asarray(x), fp, lmbda, voxel, sign,
                                      norm)
    g_fs = tprop.free_space_propagate(torch.from_numpy(x), fp, lmbda, voxel,
                                      sign, norm)
    assert _rel(g_fs.numpy(), w_fs) < 1e-5
    # The matrix pair IS the free-space propagation.
    ay, ax = got[0], got[1]
    assert _rel((ay @ torch.from_numpy(x) @ ax.T).numpy(), w_fs) < 1e-5


def test_slice_modulator_and_binning():
    d = RNG.uniform(0, 0.01, (5, 3, 8, 8)).astype(np.float32)
    b = RNG.uniform(0, 0.01, (5, 3, 8, 8)).astype(np.float32)
    want = jprop.slice_modulator(jnp.asarray(d), jnp.asarray(b), 25.0)
    got = tprop.slice_modulator(torch.from_numpy(d), torch.from_numpy(b), 25.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    for axis in (0, 2):
        np.testing.assert_allclose(
            tprop.bin_z_sum(torch.from_numpy(d), 2, axis).numpy(),
            np.asarray(jprop.bin_z_sum(jnp.asarray(d), 2, axis)), rtol=1e-6)


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('binning,prebinned', [(1, False), (2, False),
                                               (2, True)])
def test_multislice_propagate(fused, binning, prebinned):
    """Both branches of the port (plain FFT scan; fused = the kernel's
    plain version) against the JAX scan, with the far field folded."""
    n, nz = 16, 6
    obj = RNG.uniform(0, 2e-3, (3, n, n, nz, 2)).astype(np.float32)
    wave = _c((2, 3, n, n), seed=4) * 0.3
    kw = dict(binning=binning, prebinned=prebinned,
              final_prop={'free_prop_cm': 'inf', 'normalize_fft': False})
    want = jprop.multislice_propagate(
        jnp.asarray(obj[..., 0]), jnp.asarray(obj[..., 1]), jnp.asarray(wave),
        5000.0, 1e-7, fused=False, **kw)
    o = torch.from_numpy(obj)
    got = tprop.multislice_propagate(o[..., 0], o[..., 1],
                                     torch.from_numpy(wave), 5000.0, 1e-7,
                                     fused=fused, db_stack=o, **kw)
    # FFT vs folded DFT matmuls over up to 6 steps.
    assert _rel(got.numpy(), want) < 1e-5


def test_multislice_propagate_unported_branches_raise():
    """What ``multislice_propagate`` leaves out, as the JAX package does:
    one slice repeated over binned steps, and a detector propagation after
    a propagation in -z."""
    o = torch.zeros((1, 8, 8, 2))
    w = torch.ones((1, 1, 8, 8), dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match='binning'):
        tprop.multislice_propagate(o, o, w, 5000.0, 1e-7, repeats=3,
                                   binning=2)
    with pytest.raises(ValueError, match='backprop'):
        tprop.multislice_propagate(o, o, w, 5000.0, 1e-7, backprop=True,
                                   final_prop={'free_prop_cm': 'inf'})


def test_stored_switch_sized_from_device(monkeypatch):
    """The stored-records switch is an eighth of the device's memory (the
    JAX package's 16e9 default on the CPU); above it the invertible kernel
    K4 runs in place of K1, with the same result."""
    from adorym_tpu_torch.ops import cuda_multislice as cm
    assert tprop._db_stored_max_bytes('cpu') == pytest.approx(16e9 / 8)
    calls = []
    for name in ('multislice_db_packed', 'multislice_db_stored_packed'):
        real = getattr(cm, name)
        monkeypatch.setattr(cm, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    obj = torch.from_numpy(RNG.uniform(0, 1e-3, (1, 8, 8, 4, 2))
                           .astype(np.float32))
    w = torch.ones((1, 1, 8, 8), dtype=torch.complex64)
    kw = dict(fused=True, db_stack=obj)
    out = tprop.multislice_propagate(obj[..., 0], obj[..., 1], w, 5000.0,
                                     1e-7, **kw)
    assert out.shape == w.shape
    # 4 steps of one 8x8 complex wave hold 2 KiB of records.
    monkeypatch.setattr(tprop, 'hbm_limit_bytes', lambda device: 8 * 1024.0)
    out_k4 = tprop.multislice_propagate(obj[..., 0], obj[..., 1], w, 5000.0,
                                        1e-7, **kw)
    assert calls == ['multislice_db_stored_packed', 'multislice_db_packed']
    np.testing.assert_array_equal(out_k4.numpy(), out.numpy())


# -- patches ---------------------------------------------------------------

def _grid_pos(k=4, stride=4, y0=-2, x0=1):
    xs = np.arange(k) * stride
    yy, xx = np.meshgrid(xs + y0, xs + x0, indexing='ij')
    return np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)


def test_pad_and_extract():
    pos = _grid_pos()
    pad = tpatches.calculate_pad((20, 20), pos, (8, 8))
    np.testing.assert_array_equal(pad, jpatches.calculate_pad((20, 20), pos,
                                                              (8, 8)))
    obj = RNG.normal(size=(20, 20, 5, 2)).astype(np.float32)
    for ut in ('delta_beta', 'real_imag'):
        np.testing.assert_array_equal(
            tpatches.pad_object(torch.from_numpy(obj), pad, ut).numpy(),
            np.asarray(jpatches.pad_object(jnp.asarray(obj), pad, ut)))
    obj_pad = np.asarray(jpatches.pad_object(jnp.asarray(obj), pad))
    pos_int = (pos + pad[:, 0]).astype(np.int32)
    want = np.asarray(jpatches.extract_patches(jnp.asarray(obj_pad),
                                               jnp.asarray(pos_int), (8, 8)))
    got = tpatches.extract_patches(torch.from_numpy(obj_pad.copy()), pos_int,
                                   (8, 8))
    np.testing.assert_array_equal(got.numpy(), want)
    zm = np.ascontiguousarray(obj_pad.transpose(2, 3, 0, 1))
    want_z = np.asarray(jpatches.extract_patches_zmajor(
        jnp.asarray(zm), jnp.asarray(pos_int), (8, 8)))
    got_z = tpatches.extract_patches_zmajor(torch.from_numpy(zm), pos_int,
                                            (8, 8))
    np.testing.assert_array_equal(got_z.numpy(), want_z)


def test_extract_clamps_like_dynamic_slice():
    obj = RNG.normal(size=(10, 10, 2)).astype(np.float32)
    pos = np.asarray([[-3, 2], [7, 9]], np.int32)
    want = jpatches.extract_patches(jnp.asarray(obj), jnp.asarray(pos), (4, 4))
    got = tpatches.extract_patches(torch.from_numpy(obj), pos, (4, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('pos,mb,probe', [
    (_grid_pos(), 4, (8, 8)), (_grid_pos(stride=3), 4, (8, 8)),
    (_grid_pos(k=5), 5, (8, 8)), (_grid_pos()[:14], 4, (8, 8)),
    (RNG.integers(0, 20, (16, 2)).astype(np.float64), 4, (8, 8))])
def test_grid_detection(pos, mb, probe):
    for name in ('detect_row_grid', 'detect_full_grid'):
        assert (getattr(tpatches, name)(pos, mb, probe)
                == getattr(jpatches, name)(pos, mb, probe)), name


# -- rotate ----------------------------------------------------------------

@pytest.mark.parametrize('method', ['bilinear', 'nearest'])
@pytest.mark.parametrize('theta', [0.0, 0.7, -2.1])
def test_rotate(method, theta):
    obj = RNG.normal(size=(6, 11, 9, 2)).astype(np.float32)
    want = jrot.rotate(jnp.asarray(obj), np.float32(theta), method=method)
    got = trot.rotate(torch.from_numpy(obj), float(np.float32(theta)),
                      method=method)
    # Coordinates from f32 cos/sin of two libraries: an ulp apart.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize('method', ['bilinear', 'nearest'])
def test_rotate_expanded_from_binned_z(method):
    g = RNG.normal(size=(5, 10, 4, 2)).astype(np.float32)
    th = float(np.float32(-0.9))
    want = jrot.rotate_expanded_from_binned_z(jnp.asarray(g), th, 3, 11,
                                              method=method)
    got = trot.rotate_expanded_from_binned_z(torch.from_numpy(g), th, 3, 11,
                                             method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# -- models ----------------------------------------------------------------

def test_safe_sqrt_gradient_clamped():
    x = np.asarray([0.0, 1e-14, 0.25, 4.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jbase.safe_sqrt(v)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(tbase.safe_sqrt(xt).sum(), xt)
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize('loss,raw', [('lsq', 'magnitude'),
                                      ('lsq', 'intensity'),
                                      ('poisson', 'magnitude'),
                                      ('poisson', 'intensity')])
@pytest.mark.parametrize('beamstop', [False, True])
def test_mismatch_loss(loss, raw, beamstop):
    waves = _c((2, 3, 8, 8), seed=5)
    meas = RNG.random((3, 8, 8)).astype(np.float32)
    bs = (RNG.random((8, 8)) > 0.2).astype(np.float32) if beamstop else None
    pred_j = jbase.incoherent_mode_sum(jnp.asarray(waves))
    pred_t = tbase.incoherent_mode_sum(torch.from_numpy(waves))
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), rtol=1e-6)
    for per_item in (False, True):
        want = jbase.mismatch_loss(pred_j, jnp.asarray(meas), loss, raw, 1.5,
                                   None if bs is None else jnp.asarray(bs),
                                   per_item)
        got = tbase.mismatch_loss(pred_t, torch.from_numpy(meas), loss, raw,
                                  1.5, None if bs is None
                                  else torch.from_numpy(bs), per_item)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_array_equal(tbase.make_beamstop_mask(meas),
                                  jbase.make_beamstop_mask(meas))


# -- optimizers, params, init ---------------------------------------------

@pytest.mark.parametrize('kind', ['adam', 'momentum', 'gd'])
def test_optimizer_steps(kind):
    spec_kw = dict(kind=kind, step_size=1e-2, first_downrate_iteration=2)
    rng = np.random.default_rng(7)
    p = rng.normal(size=(4, 5, 2)).astype(np.float32)
    st_j = jopt.opt_init(jopt.OptSpec(**spec_kw), jnp.asarray(p))
    st_t = topt.opt_init(topt.OptSpec(**spec_kw), torch.from_numpy(p))
    pj, pt = jnp.asarray(p), torch.from_numpy(p)
    for i in range(6):
        g = rng.normal(size=p.shape).astype(np.float32)
        pj, st_j = jopt.opt_apply(jopt.OptSpec(**spec_kw), pj, jnp.asarray(g),
                                  st_j, jnp.asarray(i, jnp.int32))
        pt, st_t = topt.opt_apply(topt.OptSpec(**spec_kw), pt,
                                  torch.from_numpy(g), st_t, i)
    # f32 update arithmetic in the same order; the bias corrections' pow
    # may round an ulp apart, so allow a few ulps of the O(1) parameters.
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6,
                               atol=5e-7)


def test_specs_gates_and_constraints():
    geo = dict(obj_size=(4, 4, 4), probe_size=(4, 4))
    kw = dict(optimize_probe=True, probe_update_delay=2,
              probe_update_limit=5)
    cj = jcfg.ReconConfig(geometry=jcfg.Geometry(**geo),
                          refine=jcfg.RefineConfig(**kw),
                          train=jcfg.TrainConfig(non_negativity=True,
                                                 object_type='phase_only'))
    ct = tcfg.ReconConfig(geometry=tcfg.Geometry(**geo),
                          refine=tcfg.RefineConfig(**kw),
                          train=tcfg.TrainConfig(non_negativity=True,
                                                 object_type='phase_only'))
    sj, st = jparams.build_opt_specs(cj), tparams.build_opt_specs(ct)
    assert {k: vars(v) for k, v in sj.items()} == {k: vars(v)
                                                  for k, v in st.items()}
    for i in range(7):
        assert tparams.probe_update_gate(ct, i) == bool(
            jparams.probe_update_gate(cj, i))
        assert tparams.aux_update_gate(ct, i) == bool(
            jparams.aux_update_gate(cj, i))
    obj = RNG.normal(size=(4, 4, 4, 2)).astype(np.float32)
    mask = (RNG.random((4, 4, 4)) > 0.3).astype(np.float32)
    want = jparams.apply_object_constraints(jnp.asarray(obj), cj,
                                            jnp.asarray(mask))
    got = tparams.apply_object_constraints(torch.from_numpy(obj), ct,
                                           torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_initialize():
    np.testing.assert_array_equal(
        tinit.initialize_object((6, 5, 4), seed=3),
        jinit.initialize_object((6, 5, 4), seed=3))
    kw = dict(probe_mag_sigma=3.0, probe_phase_sigma=2.0, probe_phase_max=0.5)
    for ptype in ('plane', 'gaussian'):
        np.testing.assert_array_equal(
            tinit.initialize_probe((8, 8), ptype, n_probe_modes=2, seed=1,
                                   **kw),
            jinit.initialize_probe((8, 8), ptype, n_probe_modes=2, seed=1,
                                   **kw))


def test_config_fields_and_defaults_match():
    import dataclasses
    for name in ('Geometry', 'LossConfig', 'RefineConfig', 'TrainConfig',
                 'ParallelConfig', 'IOConfig', 'ReconConfig'):
        def fields(mod):
            return [(f.name, dataclasses.asdict(f.default)
                     if dataclasses.is_dataclass(f.default) else f.default)
                    for f in dataclasses.fields(getattr(mod, name))]
        assert fields(jcfg) == fields(tcfg), name
