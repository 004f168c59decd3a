"""The ptychography model's refinables in the port against the JAX package
on the CPU: the Fourier shift, per-spot probes, probe defocus and offset,
the projection offset and a refined distance, the parameter registry and
its constraints, and 3-epoch trajectories of position correction on the
generic, band and per-angle steps, the offsets, the defocus, the update
delay, the per-parameter optimizer kinds and a checkpoint with auxiliary
leaves that crosses packages.

Tolerances: forwards and gradients at 1e-5 of the largest value (1e-4
where the gradient sums over a whole propagation's phase; f32 on both
sides); GD trajectories' per-epoch losses at rtol 1e-5 and each refined
leaf's update at :data:`UPDATE_TOL` of the update's largest entry, the
bound ``tests/test_torch_immediate.py`` holds the object's update to (the
positions after 3 epochs are 1e-5 px, mean-free, and the two packages'
f32 sums put them 3e-10 px apart, 2.8e-5 of the largest); Adam at 1e-3,
as in ``tests/test_torch_api.py`` (Adam turns f32 noise into sign
flips).  Under a Fraunhofer far field the projection offset's gradient is
zero up to rounding (a shift of the exit wave only adds a phase ramp to
the far field, whose magnitude is measured), so its trajectories use a
finite distance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adorym_tpu as jpkg
import adorym_tpu_torch as pt
from adorym_tpu.models import ptychography as jpm
from adorym_tpu.ops import fourier as jfourier
from adorym_tpu.optim import params as jparams
from adorym_tpu.recon import Reconstructor as JaxReconstructor
from adorym_tpu.simulate import simulate as jsimulate
from adorym_tpu.utils.initialize import initialize_probe
from adorym_tpu_torch.models import ptychography as tpm
from adorym_tpu_torch.ops import fourier as tfourier
from adorym_tpu_torch.ops import propagate as tprop
from adorym_tpu_torch.optim import params as tparams


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors (several test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _probe(pn, n_modes=1, seed=0):
    p = initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                         psize_cm=1e-7, probe_mag_sigma=pn / 4,
                         probe_phase_sigma=pn / 4, probe_phase_max=0.3)
    if n_modes == 1:
        return p
    rng = np.random.default_rng(seed)
    return np.concatenate([p] + [
        (w * p + rng.normal(0, 0.02, p.shape)).astype(np.float32)
        for w in (0.4, 0.15, 0.06)[:n_modes - 1]])


def _grads_jax(fn, *args):
    """Value and gradients of the real functional ``fn`` (JAX)."""
    val, grads = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    return float(val), [np.asarray(g) for g in grads]


def _grads_torch(fn, *args):
    ts = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    val = fn(*ts)
    grads = torch.autograd.grad(val, ts, allow_unused=True)
    return float(val.detach()), [np.zeros(t.shape, np.float32) if g is None
                                 else g.numpy() for g, t in zip(grads, ts)]


def _cplx(x, lib):
    return x[..., 0] + 1j * x[..., 1] if lib is jnp else torch.complex(
        x[..., 0], x[..., 1])


def _functional(out, g, lib):
    """A fixed real functional of a complex output: sum(Re out g0 + Im out
    g1)."""
    return lib.sum(out.real * g[..., 0] + out.imag * g[..., 1])


# -- ops/fourier.py ----------------------------------------------------------

@pytest.mark.parametrize('batch', [(), (5,), (2, 3)])
def test_fourier_shift_and_gradients(batch):
    """``fourier_shift`` of batched complex images by batched shifts, and
    its gradient in the image (its real pairs) and in the shift."""
    rng = np.random.default_rng(len(batch))
    img = rng.normal(size=batch + (12, 10, 2)).astype(np.float32)
    shift = rng.uniform(-2, 2, batch + (2,)).astype(np.float32)
    g = rng.normal(size=batch + (12, 10, 2)).astype(np.float32)

    def jfn(x, s):
        return _functional(jfourier.fourier_shift(_cplx(x, jnp), s),
                           jnp.asarray(g), jnp)

    def tfn(x, s):
        return _functional(tfourier.fourier_shift(_cplx(x, torch), s),
                           torch.tensor(g), torch)
    jv, jg = _grads_jax(jfn, img, shift)
    tv, tg = _grads_torch(tfn, img, shift)
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    for a, b in zip(tg, jg):
        assert _rel(a, b) < 1e-5
    out = tfourier.fourier_shift(_cplx(torch.tensor(img), torch),
                                 torch.tensor(shift))
    ref = jfourier.fourier_shift(_cplx(jnp.asarray(img), jnp), shift)
    assert _rel(torch.view_as_real(out).numpy(),
                np.stack([np.real(ref), np.imag(ref)], -1)) < 1e-5


def test_shift_phase_ramp_matches_and_integer_shift_rolls():
    rng = np.random.default_rng(1)
    shifts = rng.uniform(-3, 3, (7, 2)).astype(np.float32)
    ramp_t = tfourier.shift_phase_ramp((16, 20), torch.tensor(shifts))
    ramp_j = np.asarray(jfourier.shift_phase_ramp((16, 20), shifts))
    assert ramp_t.shape == (7, 16, 20)
    assert np.max(np.abs(ramp_t.numpy() - ramp_j)) < 1e-5
    img = torch.tensor(rng.normal(size=(16, 20)).astype(np.complex64))
    moved = tfourier.fourier_shift(img, torch.tensor([2.0, -3.0]))
    np.testing.assert_allclose(moved.numpy(),
                               np.roll(img.numpy(), (2, -3), (0, 1)),
                               atol=1e-5)


def test_fresnel_kernel_differentiable_in_distance():
    """A tensor distance (a refined ``free_prop_cm`` or defocus) gives the
    JAX package's kernel, and its gradient through a propagation."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(2, 24, 24, 2)).astype(np.float32)
    g = rng.normal(size=(2, 24, 24, 2)).astype(np.float32)
    voxel = (10.0, 10.0, 10.0)

    def jfn(d):
        out = jpkg.ops.propagate.free_space_propagate(
            _cplx(jnp.asarray(w), jnp), d[0], 0.07, voxel)
        return _functional(out, jnp.asarray(g), jnp)

    def tfn(d):
        out = tprop.free_space_propagate(_cplx(torch.tensor(w), torch), d[0],
                                         0.07, voxel)
        return _functional(out, torch.tensor(g), torch)
    d0 = np.array([0.05], np.float32)
    jv, jg = _grads_jax(jfn, d0)
    tv, tg = _grads_torch(tfn, d0)
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    assert _rel(tg[0], jg[0]) < 1e-4


# -- models/ptychography.py --------------------------------------------------

def _model_cfg(mod, refine, n=16, pn=16, nz=1, free_prop_cm='inf',
               fuse='auto'):
    return mod.ReconConfig(
        geometry=mod.Geometry(obj_size=(n, n, nz), probe_size=(pn, pn),
                              energy_ev=5000.0, psize_cm=1e-7,
                              free_prop_cm=free_prop_cm,
                              two_d_mode=nz == 1),
        train=mod.TrainConfig(fuse_farfield=fuse),
        refine=mod.RefineConfig(**refine))


@pytest.mark.parametrize('n_modes', [1, 3])
def test_shifted_probes(n_modes):
    """Per-spot probes from ``probe_pos_correction[i_theta, ind_batch]``:
    values and the gradients in the probe and the corrections."""
    rng = np.random.default_rng(n_modes)
    probe = _probe(16, n_modes)
    ppc = rng.uniform(-1.5, 1.5, (2, 9, 2)).astype(np.float32)
    inds = np.array([4, 0, 7, 7, 2])
    g = rng.normal(size=(5, n_modes, 16, 16, 2)).astype(np.float32)
    cfgs = {m: _model_cfg(m, dict(optimize_all_probe_pos=True))
            for m in (jpkg, pt)}

    def jfn(p, c):
        out = jpm.shifted_probes(jpm.complex_probe(p),
                                 {'probe_pos_correction': c},
                                 {'i_theta': 1, 'ind_batch': jnp.asarray(inds)},
                                 cfgs[jpkg])
        return _functional(out, jnp.asarray(g), jnp)

    def tfn(p, c):
        out = tpm.shifted_probes(tpm.complex_probe(p),
                                 {'probe_pos_correction': c},
                                 {'i_theta': 1, 'ind_batch': inds}, cfgs[pt])
        assert out.shape == (5, n_modes, 16, 16)
        return _functional(out, torch.tensor(g), torch)
    jv, jg = _grads_jax(jfn, probe, ppc)
    tv, tg = _grads_torch(tfn, probe, ppc)
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    for a, b in zip(tg, jg):
        assert _rel(a, b) < 1e-5


@pytest.mark.parametrize('refine', [
    dict(optimize_probe_defocusing=True),
    dict(optimize_probe_pos_offset=True),
    dict(optimize_probe_defocusing=True, optimize_probe_pos_offset=True)])
def test_prepare_probe_defocus_and_offset(refine):
    rng = np.random.default_rng(5)
    probe = _probe(16, 2)
    aux = {'probe_defocus_mm': np.array([0.2], np.float32),
           'probe_pos_offset': rng.uniform(-2, 2, (3, 2)).astype(np.float32)}
    g = rng.normal(size=(2, 16, 16, 2)).astype(np.float32)
    cfgs = {m: _model_cfg(m, refine) for m in (jpkg, pt)}

    def fn(mod, lib, gg):
        def f(p, df, off):
            params = {'probe': p, 'probe_defocus_mm': df,
                      'probe_pos_offset': off}
            out = mod.prepare_probe(params, {'i_theta': 2}, cfgs[
                jpkg if mod is jpm else pt])
            return _functional(out, gg, lib)
        return f
    args = (probe, aux['probe_defocus_mm'], aux['probe_pos_offset'])
    jv, jg = _grads_jax(fn(jpm, jnp, jnp.asarray(g)), *args)
    tv, tg = _grads_torch(fn(tpm, torch, torch.tensor(g)), *args)
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    for a, b in zip(tg, jg):
        if np.any(b):
            assert _rel(a, b) < 1e-4
        else:
            assert not np.any(a)


@pytest.mark.parametrize('refine,fp', [
    (dict(optimize_prj_pos_offset=True), 5e-5),
    (dict(optimize_prj_pos_offset=True), 2e-5),
    (dict(optimize_free_prop=True), 2e-5),
    (dict(optimize_all_probe_pos=True, optimize_prj_pos_offset=True), 'inf')])
def test_predict_from_patches_unfolded_far_field(refine, fp):
    """The far field left out of the multislice (the projection offset's
    shift of the exit wave, a refined distance), 3-D patches of 4 slices:
    the predicted magnitudes and the gradients in the patches and every
    refined leaf, against the JAX package."""
    rng = np.random.default_rng(7)
    n_spots, pn, nz = 4, 16, 4
    sub = np.stack([rng.random((n_spots, pn, pn, nz)) * 1e-3,
                    rng.random((n_spots, pn, pn, nz)) * 3e-5],
                   -1).astype(np.float32)
    aux = {'probe': _probe(pn),
           'prj_pos_offset': np.array([[0.7, -1.3]], np.float32),
           'free_prop_cm': np.array([3e-5], np.float32),
           'probe_pos_correction': rng.uniform(
               -1, 1, (1, n_spots, 2)).astype(np.float32)}
    names = list(aux)
    cfgs = {m: _model_cfg(m, refine, pn=pn, nz=nz, free_prop_cm=fp)
            for m in (jpkg, pt)}
    assert tpm.unfolded_far_field(cfgs[pt])
    g = rng.random((n_spots, pn, pn)).astype(np.float32)
    batch = {'i_theta': 0, 'theta': 0.0, 'ind_batch': np.arange(n_spots)}

    def fn(mod, lib, gg, cfg):
        def f(s, *leaves):
            out = mod.predict_from_patches(dict(zip(names, leaves)), batch,
                                           s, cfg)
            return lib.sum(out * gg)
        return f
    jv, jg = _grads_jax(fn(jpm, jnp, jnp.asarray(g), cfgs[jpkg]), sub,
                        *aux.values())
    tv, tg = _grads_torch(fn(tpm, torch, torch.tensor(g), cfgs[pt]), sub,
                          *aux.values())
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    for name, a, b in zip(['patches'] + names, tg, jg):
        if name == 'prj_pos_offset' and fp == 'inf':
            # Zero up to rounding in both: the far field's magnitude does
            # not see a shift of the exit wave.
            assert np.max(np.abs(a)) < 1e-3 * np.max(np.abs(jg[1]))
        elif np.any(b):
            assert _rel(a, b) < 1e-4, name
        else:
            assert not np.any(a), name


# -- optim/params.py ---------------------------------------------------------

REFINE_CASES = [
    dict(optimize_probe_defocusing=True, probe_defocusing_optimizer='gd'),
    dict(optimize_probe_pos_offset=True, optimize_prj_pos_offset=True,
         prj_pos_offset_learning_rate=0.3, probe_pos_offset_optimizer='momentum'),
    dict(optimize_all_probe_pos=True, all_probe_pos_learning_rate=0.2,
         optimize_probe=True, probe_optimizer='gd'),
    dict(optimize_free_prop=True, optimize_prj_affine=True,
         optimize_all_probe_pos=True, free_prop_optimizer='momentum')]


@pytest.mark.parametrize('refine', REFINE_CASES)
@pytest.mark.parametrize('n_dists', [1, 3])
def test_build_aux_params_and_specs(refine, n_dists):
    fp = (0.01, 0.02, 0.05) if n_dists > 1 else 0.02
    cfgs = {}
    for m in (jpkg, pt):
        cfgs[m] = m.ReconConfig(
            geometry=m.Geometry(obj_size=(8, 8, 1), probe_size=(8, 8),
                                free_prop_cm=fp, n_dists=n_dists),
            refine=m.RefineConfig(**refine))
    jp = jparams.build_aux_params(cfgs[jpkg], 3, 7, free_prop_cm=fp)
    tp = tparams.build_aux_params(cfgs[pt], 3, 7, free_prop_cm=fp)
    assert list(tp) == list(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    js = jparams.build_opt_specs(cfgs[jpkg])
    ts = tparams.build_opt_specs(cfgs[pt])
    assert list(ts) == list(js)
    for k in js:
        assert (ts[k].kind, ts[k].step_size) == (js[k].kind, js[k].step_size)


def test_build_aux_params_inits_and_unported_raise():
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(8, 8, 1), probe_size=(8, 8),
                             free_prop_cm=(0.01, 0.02), n_dists=2),
        refine=pt.RefineConfig(optimize_all_probe_pos=True,
                               optimize_prj_affine=True))
    init = np.arange(4, dtype=np.float32).reshape(2, 2)
    aff = np.ones((2, 2, 3), np.float32)
    p = tparams.build_aux_params(cfg, 1, 2, probe_pos_correction_init=init,
                                 prj_affine_init=aff)
    np.testing.assert_array_equal(p['probe_pos_correction'].numpy(), init)
    np.testing.assert_array_equal(p['prj_affine_ls'].numpy(), aff)
    # Slice positions, tilt and kappa build as in the JAX package; slice
    # positions need their initial values.
    for flag in ('optimize_tilt', 'fixed_tilt', 'optimize_ctf_lg_kappa'):
        on = cfg.replace(refine=pt.RefineConfig(**{flag: True}))
        jon = jpkg.ReconConfig(geometry=jpkg.Geometry(obj_size=(8, 8, 1),
                                                      probe_size=(8, 8)),
                               refine=jpkg.RefineConfig(**{flag: True}))
        tp = tparams.build_aux_params(on, 1, 2)
        jp = jparams.build_aux_params(jon, 1, 2)
        assert sorted(tp) == sorted(jp)
        for k in jp:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    with pytest.raises(ValueError, match='slice_pos_cm_ls'):
        tparams.build_aux_params(
            cfg.replace(refine=pt.RefineConfig(optimize_slice_pos=True)), 1, 2)
    with pytest.raises(ValueError, match='first-order'):
        tparams.build_opt_specs(cfg.replace(refine=pt.RefineConfig(
            optimize_all_probe_pos=True,
            all_probe_pos_optimizer='curveball')))


def test_apply_param_constraints():
    rng = np.random.default_rng(9)
    leaves = {'probe_pos_correction': rng.normal(size=(2, 5, 2)),
              'prj_affine_ls': rng.normal(size=(3, 2, 3)),
              'probe_defocus_mm': rng.normal(size=(1,))}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    cfgs = {m: m.ReconConfig(geometry=m.Geometry(obj_size=(8, 8, 1),
                                                 probe_size=(8, 8)))
            for m in (jpkg, pt)}
    jo = jparams.apply_param_constraints(
        {k: jnp.asarray(v) for k, v in leaves.items()}, cfgs[jpkg])
    to = tparams.apply_param_constraints(
        {k: torch.tensor(v) for k, v in leaves.items()}, cfgs[pt])
    for k in leaves:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   atol=1e-7)
    np.testing.assert_allclose(to['probe_pos_correction'].numpy().mean(
        (0, 1)), 0, atol=1e-6)


# -- trajectories: the Reconstructor on each step --------------------------

def _scan(n, pn, stride):
    xs = np.arange(0, n - pn + 1, stride)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    return np.stack([yy.ravel(), xx.ravel()], -1).astype(float)


def _problem(kind):
    """Inputs of one trajectory: ``'2d'`` (the generic step, a 2D object,
    jittered positions), ``'band'`` (the immediate band step, 16^3, grid
    rows) or ``'angle'`` (the per-angle step, the same grid)."""
    rng = np.random.default_rng({'2d': 0, 'band': 1, 'angle': 2}[kind])
    if kind == '2d':
        n, pn, nz, theta = 32, 16, 1, np.zeros(1)
        pos = _scan(n, pn, 4)
        true = pos + rng.uniform(-1.5, 1.5, pos.shape)
    else:
        n, pn, nz, theta = 16, 8, 16, np.array([0.0, 0.9])
        pos = _scan(n + 4, pn, 4) - 2
        true = pos
    obj = np.stack([rng.random((n, n, nz)) * 1e-3,
                    rng.random((n, n, nz)) * 3e-5], -1).astype(np.float32)
    probe = _probe(pn)
    return n, pn, nz, theta, pos, true, obj, probe


def _traj_cfg(mod, kind, refine, n, pn, nz, free_prop_cm='inf', lr=1e-3,
              mb=None):
    per_angle = kind == 'angle'
    return mod.ReconConfig(
        geometry=mod.Geometry(obj_size=(n, n, nz), probe_size=(pn, pn),
                              energy_ev=5000.0, psize_cm=1e-7,
                              free_prop_cm=free_prop_cm, binning=2 if nz > 1
                              else 1, two_d_mode=nz == 1),
        train=mod.TrainConfig(
            minibatch_size=mb or (5 if kind == '2d' else 4),
            learning_rate=lr, optimizer='gd', seed=0,
            update_scheme='per angle' if per_angle else 'immediate',
            rotate_out_of_loop=per_angle),
        refine=mod.RefineConfig(**refine))


def _both(kind, refine, n_epochs=3, free_prop_cm='inf', sim_refine=None,
          sim_params=None, lr=None, mb=None, aux_init=None):
    """Simulate with the JAX package (at the true positions, or with
    ``sim_params`` through the refinement's own forward), then run
    ``n_epochs`` in both packages from the same start; returns the two
    Reconstructors and their per-epoch losses."""
    n, pn, nz, theta, pos, true, obj, probe = _problem(kind)
    if lr is None:
        # The 3-D object's GD step: 1e-3 makes the band's loss climb.
        lr = 1e-3 if kind == '2d' else 1e-4
    jcfg = _traj_cfg(jpkg, kind, refine, n, pn, nz, free_prop_cm, lr, mb)
    tcfg = _traj_cfg(pt, kind, refine, n, pn, nz, free_prop_cm, lr, mb)
    if sim_params is None:
        data = jsimulate(jcfg, obj, probe, true, theta)
    else:
        params = {'obj': jnp.asarray(obj), 'probe': jnp.asarray(probe),
                  **{k: jnp.asarray(v) for k, v in sim_params.items()}}
        scfg = jcfg.replace(refine=jpkg.RefineConfig(**sim_refine))
        data = np.stack([np.asarray(jpm.predict(
            params, {'i_theta': i, 'theta': float(th),
                     'pos_batch': jnp.asarray(pos, jnp.float32),
                     'ind_batch': jnp.arange(len(pos))}, scfg,
            jparams_pad(scfg, pos))) for i, th in enumerate(theta)])
    obj0 = (obj * 0.5).astype(np.float32)
    jr = JaxReconstructor(jcfg, data=data, probe_pos=pos, theta_ls=theta,
                          obj_init=obj0, probe_init=probe, aux_init=aux_init)
    tr = pt.Reconstructor(tcfg, data=data, probe_pos=pos, theta_ls=theta,
                          obj_init=obj0, probe_init=probe, aux_init=aux_init,
                          device='cpu')
    tr.start = {k: v.detach().clone() for k, v in tr.params.items()}
    jl = [jr.run_epoch(e) for e in range(n_epochs)]
    tl = [tr.run_epoch(e) for e in range(n_epochs)]
    return jr, tr, np.asarray(jl), np.asarray(tl)


def jparams_pad(cfg, pos):
    from adorym_tpu.ops.patches import calculate_pad
    return calculate_pad(cfg.geometry.obj_size[:2], pos,
                         cfg.geometry.probe_size)


#: A refined leaf's update after the trajectory, port against JAX,
#: relative to the update's largest entry: the object's bound in
#: ``tests/test_torch_immediate.py`` (the JAX package's own two forward
#: forms give updates 2.2e-4 apart there).
UPDATE_TOL = 5e-4


def _check_leaves(jr, tr, names, tol=UPDATE_TOL):
    """Each leaf's update from the common start, port against JAX, within
    ``tol`` of the update's largest entry plus 4 f32 ulps of the leaf's
    largest entry (a probe near 1 moves by about 1e-5 in 3 epochs, 100
    ulps, so its update is quantized at 1e-2)."""
    for k in names:
        a0 = tr.start[k].numpy()
        a = tr.params[k].detach().numpy() - a0
        b = np.asarray(jr.params[k]) - a0
        assert a.shape == b.shape, k
        assert np.any(b), k
        ulps = 4 * np.finfo(np.float32).eps * np.max(np.abs(a0 + b))
        err = np.max(np.abs(a - b))
        assert err < tol * np.max(np.abs(b)) + ulps, (k, _rel(a, b))


POS = dict(optimize_all_probe_pos=True, all_probe_pos_learning_rate=0.5,
           all_probe_pos_optimizer='gd')


@pytest.mark.parametrize('kind', ['2d', 'band', 'angle'])
def test_position_correction_trajectory(kind):
    """3 GD epochs with ``optimize_all_probe_pos`` on the generic step
    (2D, jittered data), the band step (grid rows, K6's plain form) and
    the per-angle step: losses, object and refined positions."""
    refine = dict(POS, optimize_probe=kind == '2d', probe_optimizer='gd',
                  probe_learning_rate=1e-3)
    jr, tr, jl, tl = _both(kind, refine)
    if kind == 'band':
        assert tr._band
    if kind == 'angle':
        assert tr._grid_scatter_rows is not None
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.any(tr.params['probe_pos_correction'].numpy() != 0)
    _check_leaves(jr, tr, ['obj', 'probe_pos_correction']
                  + (['probe'] if kind == '2d' else []))


@pytest.mark.parametrize('kind', ['2d', 'band'])
def test_probe_defocus_trajectory(kind):
    """Data simulated with a 50 nm probe defocus (at 1 nm pixels the
    Fresnel phase reaches 20 rad; at the JAX test's 0.3 mm it reaches
    1e5 rad, where f32 rounds it by 1e-2 and both packages' gradients are
    noise), refined from 0."""
    refine = dict(optimize_probe_defocusing=True,
                  probe_defocusing_learning_rate=(1e-6 if kind == '2d'
                                                  else 1e-8),
                  probe_defocusing_optimizer='gd')
    jr, tr, jl, tl = _both(
        kind, refine, sim_refine=refine,
        sim_params={'probe_defocus_mm': np.array([5e-5], np.float32)})
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tr.params['probe_defocus_mm'].item() != 0
    _check_leaves(jr, tr, ['obj', 'probe_defocus_mm'])


@pytest.mark.parametrize('kind', ['2d', 'angle'])
def test_probe_pos_offset_trajectory(kind):
    refine = dict(optimize_probe_pos_offset=True,
                  probe_pos_offset_learning_rate=0.5,
                  probe_pos_offset_optimizer='gd')
    n_theta = 1 if kind == '2d' else 2
    jr, tr, jl, tl = _both(
        kind, refine, sim_refine=refine,
        sim_params={'probe_pos_offset': np.tile(
            np.array([[0.8, -0.6]], np.float32), (n_theta, 1))})
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _check_leaves(jr, tr, ['obj', 'probe_pos_offset'])


@pytest.mark.parametrize('kind,fp', [('2d', 2e-5), ('angle', 2e-5),
                                     ('band', 2e-5)])
def test_prj_pos_offset_trajectory(kind, fp):
    """The projection offset shifts the exit wave: the far field (or the
    finite distance) runs after the multislice, unfolded."""
    refine = dict(optimize_prj_pos_offset=True,
                  prj_pos_offset_learning_rate=0.5,
                  prj_pos_offset_optimizer='gd')
    n_theta = 1 if kind == '2d' else 2
    jr, tr, jl, tl = _both(
        kind, refine, free_prop_cm=fp, sim_refine=refine,
        sim_params={'prj_pos_offset': np.tile(
            np.array([[1.2, -0.7]], np.float32), (n_theta, 1))})
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _check_leaves(jr, tr, ['obj', 'prj_pos_offset'])


def test_free_prop_refinement_trajectory():
    """A refined single distance (near-field ptychography, 200 nm at 1 nm
    pixels), started 20% long of the distance the data were made at."""
    refine = dict(optimize_free_prop=True, free_prop_learning_rate=1e-10,
                  free_prop_optimizer='gd')
    jr, tr, jl, tl = _both('2d', refine, free_prop_cm=2e-5,
                           aux_init={'free_prop_cm': np.array([2.4e-5])})
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _check_leaves(jr, tr, ['obj', 'free_prop_cm'])


@pytest.mark.parametrize('delay,moves', [(10_000, False), (3, True)])
def test_other_params_update_delay(delay, moves):
    """Auxiliary leaves stay frozen for ``other_params_update_delay``
    global batches; the object trains either way."""
    refine = dict(POS, other_params_update_delay=delay)
    jr, tr, jl, tl = _both('2d', refine, n_epochs=2)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    ppc = tr.params['probe_pos_correction'].numpy()
    assert np.any(ppc != 0) == moves
    _check_leaves(jr, tr, ['obj'] + (['probe_pos_correction'] if moves
                                     else []))


@pytest.mark.parametrize('kind_', ['gd', 'momentum', 'adam'])
def test_per_parameter_optimizer_kinds(kind_):
    """``all_probe_pos_optimizer`` and ``probe_pos_offset_optimizer``
    pick each leaf's first-order kind; Adam's trajectory is compared at
    1e-3 (the bound of ``tests/test_torch_api.py``: Adam turns f32 noise
    into sign flips)."""
    refine = dict(optimize_all_probe_pos=True,
                  all_probe_pos_learning_rate=0.05,
                  all_probe_pos_optimizer=kind_,
                  optimize_probe_pos_offset=True,
                  probe_pos_offset_learning_rate=0.05,
                  probe_pos_offset_optimizer=kind_)
    jr, tr, jl, tl = _both('2d', refine)
    adam = kind_ == 'adam'
    np.testing.assert_allclose(tl, jl, rtol=1e-3 if adam else 1e-5)
    assert tr.specs['probe_pos_correction'].kind == kind_
    assert set(tr.opt_state['probe_pos_correction']) == set(
        jr.opt_state['probe_pos_correction'])
    if not adam:
        _check_leaves(jr, tr, ['probe_pos_correction', 'probe_pos_offset'])


def test_checkpoint_with_aux_leaves_crosses_packages(tmp_path):
    """A JAX checkpoint with refined positions and offsets (and their Adam
    state) resumed by the port, and the port's resumed by the JAX
    package: the next epoch's loss and leaves agree with the writer's own
    continuation."""
    from adorym_tpu_torch import convert
    refine = dict(optimize_all_probe_pos=True,
                  all_probe_pos_learning_rate=0.05,
                  optimize_probe_pos_offset=True,
                  probe_pos_offset_learning_rate=0.05)
    n, pn, nz, theta, pos, true, obj, probe = _problem('2d')
    data = jsimulate(_traj_cfg(jpkg, '2d', {}, n, pn, nz), obj, probe, true)
    kw = dict(data=data, probe_pos=pos, obj_init=(obj * 0.5),
              probe_init=probe)
    cfgs = {m: _traj_cfg(m, '2d', refine, n, pn, nz).replace(
        train=m.TrainConfig(minibatch_size=5, learning_rate=1e-3,
                            optimizer='adam'))
            for m in (jpkg, pt)}
    jr = JaxReconstructor(cfgs[jpkg], output_folder=str(tmp_path / 'j'),
                          **kw)
    jr.run_epoch(0)
    jr.save_checkpoint(1, 0)
    tr = pt.Reconstructor(cfgs[pt], output_folder=str(tmp_path / 'j'),
                          device='cpu', **kw)
    assert (tr._start_epoch, tr.i_opt_batch) == (1, jr.i_opt_batch)
    assert set(tr.opt_state['probe_pos_correction']) == {'m', 'v'}
    np.testing.assert_allclose(tr.run_epoch(1), jr.run_epoch(1), rtol=1e-3)
    for k in ('probe_pos_correction', 'probe_pos_offset'):
        # Adam steps of 0.05 px: a sign flipped by f32 noise moves an
        # entry by a step, so the leaves are held at two steps.
        assert np.max(np.abs(tr.params[k].numpy()
                             - np.asarray(jr.params[k]))) < 0.1
    # The port's checkpoint back into the JAX package.
    tr.save_checkpoint(2, 0)
    ck = convert.load_checkpoint(str(tmp_path / 'j' / 'checkpoint'),
                                 device='cpu')
    for k in ('probe_pos_correction', 'probe_pos_offset'):
        np.testing.assert_array_equal(ck['params'][k].numpy(),
                                      tr.params[k].numpy())
    jr2 = JaxReconstructor(cfgs[jpkg], output_folder=str(tmp_path / 'j'),
                           **kw)
    np.testing.assert_array_equal(
        np.asarray(jr2.params['probe_pos_correction']),
        tr.params['probe_pos_correction'].numpy())
    np.testing.assert_array_equal(
        np.asarray(jr2.opt_state['probe_pos_offset']['m']),
        tr.opt_state['probe_pos_offset']['m'].numpy())


def test_params_from_jax_carries_aux_leaves():
    from adorym_tpu_torch import convert
    rng = np.random.default_rng(4)
    p = {'obj': rng.random((4, 4, 1, 2)), 'probe': rng.random((1, 4, 4, 2)),
         'probe_pos_correction': rng.random((1, 3, 2)),
         'prj_affine_ls': rng.random((2, 2, 3))}
    st = {'probe_pos_correction': {'m': rng.random((1, 3, 2)),
                                   'v': rng.random((1, 3, 2))}}
    tp, ts = convert.params_from_jax(p, st, device='cpu')
    assert set(tp) == set(p)
    np.testing.assert_array_equal(ts['probe_pos_correction']['v'].numpy(),
                                  st['probe_pos_correction']['v'].astype(
                                      np.float32))


def test_intermediate_refined_params_tree(tmp_path):
    """``save_intermediate`` writes the refined leaves' history in the
    reference's layout, the same files as the JAX package."""
    refine = dict(POS, optimize_probe_pos_offset=True,
                  probe_pos_offset_optimizer='gd')
    n, pn, nz, theta, pos, true, obj, probe = _problem('2d')
    data = jsimulate(_traj_cfg(jpkg, '2d', {}, n, pn, nz), obj, probe, true)
    trees = {}
    for m, R, kw in ((jpkg, JaxReconstructor, {}),
                     (pt, pt.Reconstructor, {'device': 'cpu'})):
        cfg = _traj_cfg(m, '2d', refine, n, pn, nz).replace(
            io=m.IOConfig(save_intermediate=True, store_checkpoint=False,
                          use_checkpoint=False))
        out = tmp_path / m.__name__
        rec = R(cfg, data=data, probe_pos=pos, obj_init=obj * 0.5,
                probe_init=probe, output_folder=str(out), **kw)
        for e in range(2):
            rec.run_epoch(e)
            rec._save_intermediate(e, -1)
        inter = out / 'intermediate'
        trees[m] = sorted(str(p.relative_to(inter))
                          for p in inter.rglob('*.txt'))
        if m is pt:
            got = np.loadtxt(inter / 'probe_pos' /
                             'probe_pos_correction_1.txt')
            np.testing.assert_allclose(
                got, rec.params['probe_pos_correction'].numpy()
                .reshape(-1, 2), rtol=1e-6)
    assert trees[pt] == trees[jpkg]
    assert 'probe_pos/probe_pos_correction_1.txt' in trees[pt]
