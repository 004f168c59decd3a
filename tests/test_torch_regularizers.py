"""The port's regularizers, image helpers, finite support and 2D mode
against the JAX package on the same numpy inputs: each regularizer's value
and gradient, ``ops/image``, and GD trajectories with regularizers, a
support mask and shrink-wrap through the band step, the generic step, the
per-angle step and ``two_d_mode``.

The 3D trajectories are ``tests/test_torch_immediate.py``'s drive (24^3,
3x3 grid of 12^2 patterns, 3 angles, minibatch 3) and, per angle,
``tests/test_torch_recon.py``'s (32^3, 4x4 grid of 16^2, 3 angles).  The
regularizer weights are set so that the regularizers are about a tenth of
the loss.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import adorym_tpu.config as jcfg
import adorym_tpu.recon as jrecon
from adorym_tpu.models import regularizers as jregs
from adorym_tpu.ops import image as jimage
import adorym_tpu_torch as pt
import adorym_tpu_torch.recon as trecon
from adorym_tpu_torch.models import regularizers as tregs
from adorym_tpu_torch.ops import image as timage

from test_torch_immediate import UPDATE_TOL, _setup as _setup_imm

RNG = np.random.default_rng(20)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors: under a parallel
    test run, several workers' thread pools oversubscribe the cores and
    each of the many small ops waits on its pool (a 4 s test took 348 s)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _obj(unknown_type, shape=(6, 7, 5)):
    """A random object with entries of order 0.1 (the real_imag one
    around 1).  The correlation terms multiply five slices and square
    their product's scale: at entries of 1e-3 the JAX package's GradCorr
    gradient underflows to NaN in f32, and at a spread of 1e-3 around 1
    the mean-centring loses 3 to 4 digits in either package."""
    rng = np.random.default_rng(0 if unknown_type == 'delta_beta' else 1)
    obj = rng.normal(size=shape + (2,)) * 0.3
    if unknown_type == 'real_imag':
        obj[..., 0] += 1.0
    return obj.astype(np.float32)


def _value_and_grad_both(jfn, tfn, obj):
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(obj))
    t = torch.from_numpy(obj).requires_grad_()
    tv = tfn(t)
    tg, = torch.autograd.grad(tv, t)
    return float(jv), np.asarray(jg), float(tv.detach()), tg.numpy()


REGS = {'L1': dict(alpha_d=0.3, alpha_b=0.7),
        'ReweightedL1': dict(alpha_d=0.3, alpha_b=0.7),
        'TV': dict(gamma=0.5), 'Corr': dict(gamma=0.5),
        'GradCorr': dict(gamma=0.5)}


@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('unknown_type', ['delta_beta', 'real_imag'])
@pytest.mark.parametrize('name', list(REGS))
def test_regularizer_value_and_grad(name, unknown_type, weighted):
    """Value and gradient at rtol 1e-5 (relative to the largest gradient
    entry); ``weight_l1`` given or not (the reweighted form needs it)."""
    if name == 'ReweightedL1' and not weighted:
        with pytest.raises(ValueError, match='weight_l1'):
            tregs.ReweightedL1Regularizer(unknown_type)(
                torch.zeros(2, 2, 2, 2))
        return
    obj = _obj(unknown_type)
    w = (RNG.random(obj.shape).astype(np.float32) + 0.5) if weighted else None
    cls = f'{name}Regularizer'
    jr = getattr(jregs, cls)(unknown_type, **REGS[name])
    tr = getattr(tregs, cls)(unknown_type, **REGS[name])
    jv, jg, tv, tg = _value_and_grad_both(
        lambda o: jr(o, weight_l1=None if w is None else jnp.asarray(w)),
        lambda o: tr(o, weight_l1=None if w is None else torch.from_numpy(w)),
        obj)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    assert np.max(np.abs(tg - jg)) <= 1e-5 * np.max(np.abs(jg))


@pytest.mark.parametrize('axis_offset', [0, 1])
def test_total_regularization_and_axis_offset(axis_offset):
    """The sum over a list, TV taken over axes shifted by
    ``axis_offset`` (a leading batch axis)."""
    obj = _obj('delta_beta', (3, 5, 6, 4) if axis_offset else (5, 6, 4))
    w = RNG.random(obj.shape).astype(np.float32)
    kw = [('TVRegularizer', dict(gamma=0.2)),
          ('ReweightedL1Regularizer', dict(alpha_d=1.0, alpha_b=2.0)),
          ('CorrRegularizer', dict(gamma=0.1))]
    jl = [getattr(jregs, c)('delta_beta', **k) for c, k in kw]
    tl = [getattr(tregs, c)('delta_beta', **k) for c, k in kw]
    jv, jg, tv, tg = _value_and_grad_both(
        lambda o: jregs.total_regularization(jl, o, jnp.asarray(w),
                                             axis_offset),
        lambda o: tregs.total_regularization(tl, o, torch.from_numpy(w),
                                             axis_offset), obj)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    assert np.max(np.abs(tg - jg)) <= 1e-5 * np.max(np.abs(jg))


LOSS_CASES = [dict(alpha_d=1.0, alpha_b=0.1),
              dict(alpha_d=1.0, alpha_b=0.1, reweighted_l1=True),
              dict(gamma=0.2, corr_reg=0.1, grad_corr_reg=0.1)]


@pytest.mark.parametrize('loss', LOSS_CASES)
def test_build_regularizers_matches_jax(loss):
    for ut in ('delta_beta', 'real_imag'):
        def regs_of(mod, build):
            cfg = mod.ReconConfig(geometry=mod.Geometry(obj_size=(4, 4, 4),
                                                        probe_size=(2, 2)),
                                  loss=mod.LossConfig(**loss),
                                  train=mod.TrainConfig(unknown_type=ut))
            return [(type(r).__name__, vars(r)) for r in build(cfg)]
        assert (regs_of(pt, trecon.build_regularizers)
                == regs_of(jcfg, jrecon.build_regularizers))


@pytest.mark.parametrize('zero', [False, True])
def test_weight_l1_refresh_matches_jax(zero):
    """The reweighted-L1 weights; ones at a zero object."""
    obj = np.zeros((4, 5, 3, 2), np.float32) if zero else _obj('delta_beta')
    want = jrecon.Reconstructor._weight_l1_refresh(jnp.asarray(obj))
    got = trecon.Reconstructor._weight_l1_refresh(torch.from_numpy(obj))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    if zero:
        assert np.all(got.numpy() == 1.0)


IMAGE_CASES = ['total_variation', 'image_gradient', 'pearson', 'conversions',
               'generators', 'upsample_2x', 'ramp_filter']


@pytest.mark.parametrize('case', IMAGE_CASES)
def test_image_ops_match_jax(case):
    arr = RNG.normal(size=(6, 5, 4)).astype(np.float32)
    t = torch.from_numpy(arr)
    j = jnp.asarray(arr)
    if case == 'total_variation':
        pairs = [(timage.total_variation(t, (0, 2)),
                  jimage.total_variation(j, (0, 2))),
                 (timage.total_variation_3d(t), jimage.total_variation_3d(j))]
    elif case == 'image_gradient':
        pairs = [(timage.image_gradient(t, (0, 1)),
                  jimage.image_gradient(j, (0, 1)))]
    elif case == 'pearson':
        pairs = [(timage.pearson_corr_along_last(t),
                  jimage.pearson_corr_along_last(j))]
    elif case == 'conversions':
        a, b = torch.from_numpy(arr[..., :2]), torch.from_numpy(arr[..., 2:])
        pairs = list(zip(timage.mag_phase_to_real_imag(a, b),
                         jimage.mag_phase_to_real_imag(jnp.asarray(a.numpy()),
                                                       jnp.asarray(b.numpy()))))
        pairs += list(zip(timage.real_imag_to_mag_phase(a, b),
                          jimage.real_imag_to_mag_phase(
                              jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))))
    elif case == 'generators':
        # numpy in both packages: equal.
        for name, args in (('generate_gaussian_map', ((9, 8), 1.0, 3, 0.4, 2)),
                           ('generate_disk', ((9, 8), 3)),
                           ('generate_sphere', ((6, 7, 5), 2)),
                           ('generate_shell', ((6, 7, 5), 2)),
                           ('generate_ring', ((9, 8), 3))):
            np.testing.assert_array_equal(getattr(timage, name)(*args),
                                          getattr(jimage, name)(*args))
        return
    elif case == 'upsample_2x':
        np.testing.assert_array_equal(timage.upsample_2x(arr),
                                      jimage.upsample_2x(arr))
        return
    else:
        pairs = [(timage.ramp_filter(t, axis=1), jimage.ramp_filter(j, axis=1))]
    for got, want in pairs:
        got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6 * np.max(np.abs(want)))


# -- trajectories with regularizers and a support ---------------------------

def _support(shape, frac=0.4):
    """A support cylinder along y, the rotation axis; in 2D a disk."""
    y, x, z = shape
    if z == 1:
        yy, xx = np.meshgrid(np.arange(y) - (y - 1) / 2,
                             np.arange(x) - (x - 1) / 2, indexing='ij')
        disk = yy ** 2 + xx ** 2 <= (frac * min(y, x)) ** 2
        return disk[..., None].astype(np.float32)
    xx, zz = np.meshgrid(np.arange(x) - (x - 1) / 2,
                         np.arange(z) - (z - 1) / 2, indexing='ij')
    disk = xx ** 2 + zz ** 2 <= (frac * min(x, z)) ** 2
    return np.broadcast_to(disk[None], shape).astype(np.float32)


#: TV and reweighted L1 (the reference CI configuration's kind), TV with
#: plain L1, and TV alone.
REG_RW = dict(gamma=1.0, alpha_d=1.0, alpha_b=0.1, reweighted_l1=True)
REG_L1 = dict(gamma=1.0, alpha_d=1.0, alpha_b=0.1)
REG_TV = dict(gamma=1.0)


def _run(mod, args, n_epochs=3, geo=None, loss=None, mask=None, **train):
    kw, obj0, probe, pos, theta, data = args
    cfg = mod.ReconConfig(
        geometry=mod.Geometry(**{**kw, **(geo or {})}),
        loss=mod.LossConfig(**(loss or {})),
        train=mod.TrainConfig(**{'minibatch_size': 3, 'seed': 7,
                                 'learning_rate': 1e-5, 'optimizer': 'gd',
                                 **train}))
    kwargs = dict(data=data, probe_pos=pos, theta_ls=theta,
                  obj_init=obj0.copy(), probe_init=probe,
                  finite_support_mask=mask)
    if mod is pt:
        rec = pt.Reconstructor(cfg, device='cpu', **kwargs)
        obj = lambda: rec.obj  # noqa: E731
    else:
        rec = jrecon.Reconstructor(cfg, **kwargs)
        obj = lambda: np.asarray(rec.params['obj'])  # noqa: E731
    losses = np.asarray([rec.run_epoch(e) for e in range(n_epochs)])
    mask_out = rec.finite_support_mask
    if mask_out is not None:
        mask_out = np.asarray(mask_out.cpu() if torch.is_tensor(mask_out)
                              else mask_out)
    return rec, losses, obj(), mask_out


def _setup_per_angle(unknown_type='delta_beta'):
    """32^3, a 4x4 grid of 16^2 patterns at stride 4, 3 angles."""
    from test_torch_immediate import initialize_probe, simulate
    rng = np.random.default_rng(1)
    n, pn = 32, 16
    kw = dict(obj_size=(n, n, n), probe_size=(pn, pn), energy_ev=5000.0,
              psize_cm=1e-7, free_prop_cm='inf', binning=2)
    obj_true = np.stack([rng.random((n, n, n)) * 1e-3,
                         rng.random((n, n, n)) * 3e-5], -1).astype(np.float32)
    obj0 = np.stack([rng.random((n, n, n)) * 5e-4,
                     rng.random((n, n, n)) * 1.5e-5], -1).astype(np.float32)
    probe = np.asarray(initialize_probe(
        (pn, pn), 'gaussian', energy_ev=5000.0, psize_cm=1e-7,
        probe_mag_sigma=4, probe_phase_sigma=4, probe_phase_max=0.3),
        np.float32)
    xs = np.arange(4) * 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    theta = np.linspace(0, np.pi, 3, endpoint=False)
    data = np.asarray(simulate(
        jcfg.ReconConfig(geometry=jcfg.Geometry(**kw),
                         train=jcfg.TrainConfig(minibatch_size=4)),
        obj_true, probe, pos, theta))
    if unknown_type == 'real_imag':
        obj0 = obj0 * 10
        obj0[..., 0] += 1.0
    return kw, obj0, probe, pos, theta, data


def _setup_2d():
    """A 2D object (one slice), a 4x4 grid of 12^2 patterns, one angle."""
    from test_torch_immediate import initialize_probe, simulate
    rng = np.random.default_rng(2)
    n, pn = 30, 12
    kw = dict(obj_size=(n, n, 1), probe_size=(pn, pn), energy_ev=5000.0,
              psize_cm=1e-7, free_prop_cm='inf', two_d_mode=True)
    obj_true = np.stack([rng.random((n, n, 1)) * 2e-2,
                         rng.random((n, n, 1)) * 5e-4], -1).astype(np.float32)
    obj0 = np.stack([rng.random((n, n, 1)) * 1e-2,
                     rng.random((n, n, 1)) * 2.5e-4], -1).astype(np.float32)
    probe = np.asarray(initialize_probe(
        (pn, pn), 'gaussian', energy_ev=5000.0, psize_cm=1e-7,
        probe_mag_sigma=3, probe_phase_sigma=3, probe_phase_max=0.3),
        np.float32)
    xs = np.arange(4) * 6
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    theta = np.zeros(1)
    data = np.asarray(simulate(
        jcfg.ReconConfig(geometry=jcfg.Geometry(**kw),
                         train=jcfg.TrainConfig(minibatch_size=4)),
        obj_true, probe, pos, theta))
    return kw, obj0, probe, pos, theta, data


PER_ANGLE = dict(update_scheme='per angle', rotate_out_of_loop=True,
                 minibatch_size=4)

#: (setup, regularizers, shrink threshold, train keywords).  Every case
#: runs a support (a cylinder along y, a disk in 2D) with shrink-wrap.
#: The per-angle 3D cases take plain L1: per angle the JAX package weights
#: the ROTATED object by weights of the unrotated one, so an entry near
#: zero in one frame meets a large value in the other, and two objects
#: 1.1e-7 apart after an epoch give the next angle's reweighted L1 values
#: 6e-3 apart (JAX's formula on either object, measured); the port
#: computes the same formula.  real_imag takes TV alone: its reweighted L1
#: squares weights of 1/|imag| and diverges, and its plain L1 of the
#: phase sits at the kink of |phase| over the whole vacuum outside the
#: support (the losses then drift 1.2e-5 apart per angle; each term alone
#: with the support, 4.4e-6).
TRAJ_CASES = {
    'band': ('imm', REG_RW, 2e-4, dict()),
    'band_binned': ('imm', REG_RW, 2e-4, dict(geo=dict(binning=2))),
    'band_real_imag': ('imm_ri', REG_TV, 0.9,
                       dict(unknown_type='real_imag', learning_rate=1e-3)),
    'generic': ('imm_jitter', REG_RW, 2e-4, dict()),
    'per_angle': ('angle', REG_L1, 2e-4, dict(PER_ANGLE, shrink_cycle=8)),
    'per_angle_real_imag': ('angle_ri', REG_TV, 0.9,
                            dict(PER_ANGLE, shrink_cycle=8,
                                 unknown_type='real_imag',
                                 learning_rate=1e-3)),
    'two_d_immediate': ('2d', REG_RW, 5e-3,
                        dict(minibatch_size=4, learning_rate=1e-4,
                             shrink_cycle=2)),
    'two_d_per_angle': ('2d', REG_RW, 5e-3,
                        dict(update_scheme='per angle', minibatch_size=4,
                             learning_rate=1e-4, shrink_cycle=2)),
}


@pytest.mark.parametrize('case', list(TRAJ_CASES))
def test_regularized_gd_trajectory_matches_jax(case):
    """Losses over 3 GD epochs at rtol 1e-5 and the shrunk supports
    equal.  Both packages take the same step: the band step on grid rows
    (3D), the generic step on a jittered table and in 2D, the per-angle
    step with the rotation out of the loop (none in 2D).

    The object: TV and L1 have kinks, and an entry within a step of one
    follows f32 noise, so the JAX package's own two forward forms (the
    Pallas kernel in interpret mode and the plain scan) give objects up to
    2.7e-2 of the largest update apart on these drives.  The port, on the
    plain form, is held to twice that distance on the same drive, plus
    :data:`UPDATE_TOL`, within the final support."""
    kind, loss, thr, train = TRAJ_CASES[case]
    train = dict(train)
    geo = train.pop('geo', None)
    args = {'imm': _setup_imm,
            'imm_ri': lambda: _setup_imm(unknown_type='real_imag'),
            'imm_jitter': lambda: _setup_imm(jitter=True),
            'angle': _setup_per_angle,
            'angle_ri': lambda: _setup_per_angle('real_imag'),
            '2d': _setup_2d}[kind]()
    mask = _support(args[0]['obj_size'])
    train.setdefault('shrink_cycle', 4)
    kw = dict(geo=geo, loss=loss, mask=mask, shrink_threshold=thr, **train)
    jr, jl, jo, jm = _run(jcfg, args, **kw)
    _, _, jo_on, _ = _run(jcfg, args, fused_multislice='on', **kw)
    tr, tl, to, tm = _run(pt, args, **kw)
    assert (tr._band, tr._angles) == (kind == 'imm' or kind == 'imm_ri',
                                      'update_scheme' in train)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_array_equal(tm, jm)
    inside = jm > 0
    assert inside.any()
    upd = np.max(np.abs(jo - args[1])[inside])
    jax_own = np.max(np.abs(jo_on - jo)[inside])
    assert (np.max(np.abs(to - jo)[inside])
            <= 2 * jax_own + UPDATE_TOL * upd)
    if train.get('unknown_type') != 'real_imag':
        # The support did shrink, and holds the object.
        assert tm.sum() < mask.sum()
        assert np.all(to[mask == 0] == 0)
