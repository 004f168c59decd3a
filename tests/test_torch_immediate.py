"""The port's immediate scheme (the reference's default) against the JAX
package on the same numpy inputs: the rotation's transpose in both forms,
the binned rotation, the vacuum extraction, ``predict``, and GD
trajectories of the band step and of the generic exact-AD step.

The drive is ``tests/test_update_schemes.py``'s: a 24^3 object, a 12^2
probe at stride 6 (a 3x3 grid), 3 angles, minibatch 3.  The object starts
at a small random value, not at zero: at a zero object the Gaussian
probe's far-field tails underflow, and the loss's gradient there divides
f32 roundoff by those tails (the JAX package's own gradient moves by half
under a 1e-9 perturbation of a zero object), so two packages' FFTs cannot
agree on it.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import adorym_tpu.config as jcfg
import adorym_tpu.recon as jrecon
from adorym_tpu.models import ptychography as jmodel
from adorym_tpu.ops import patches as jpatches
from adorym_tpu.ops import rotate as jrot
from adorym_tpu.simulate import simulate
from adorym_tpu.utils.initialize import initialize_probe
import adorym_tpu_torch as pt
import adorym_tpu_torch.recon as trecon
from adorym_tpu_torch.models import ptychography as tmodel
from adorym_tpu_torch.ops import patches as tpatches
from adorym_tpu_torch.ops import rotate as trot

N, PN = 24, 12


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors: under a parallel
    test run, several workers' thread pools oversubscribe the cores and
    each of the many small ops waits on its pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(
        np.abs(np.asarray(b)))


# -- the rotation's transpose ------------------------------------------------

THETAS = [0.0, 0.3, np.pi / 2, 2.2, -1.1]


@pytest.mark.parametrize('theta', THETAS)
@pytest.mark.parametrize('method', ['bilinear', 'nearest'])
def test_rotate_adjoint(theta, method):
    """The transpose through autograd against JAX's ``jax.vjp`` of its
    rotation, f32 sums of up to 4 terms a voxel in other orders."""
    cot = np.random.default_rng(1).normal(size=(5, 14, 10, 2)).astype(
        np.float32)
    want = jrot.rotate_adjoint(jnp.asarray(cot), theta, method=method)
    got = trot.rotate_adjoint(torch.from_numpy(cot), theta, method=method)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize('theta', THETAS)
@pytest.mark.parametrize('plane,binning,nz', [
    ((16, 16), 1, None), ((14, 10), 1, None), ((10, 17), 1, None),
    ((16, 6), 3, 16), ((12, 4), 4, 13)])
def test_rotate_adjoint_taps(theta, plane, binning, nz):
    """The 9-tap gather against JAX's, on square and rectangular planes,
    binned or not (relative to the largest value, 1e-5: the same weights,
    sums of up to 9 terms in other orders); and against the port's own
    transpose through autograd of the expanded cotangent, which it must
    equal as a linear map."""
    cot = np.random.default_rng(2).normal(size=(3,) + plane + (2,)).astype(
        np.float32)
    want = jrot.rotate_adjoint_taps(jnp.asarray(cot), theta, binning=binning,
                                    nz_full=nz)
    got = trot.rotate_adjoint_taps(torch.from_numpy(cot), theta,
                                   binning=binning, nz_full=nz)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-5
    full = torch.from_numpy(cot)
    if binning > 1:
        full = torch.repeat_interleave(full, binning, dim=2)[:, :, :nz]
    exact = trot.rotate_adjoint(full, theta)
    assert _rel(got.numpy(), exact.numpy()) < 1e-5


@pytest.mark.parametrize('binning,nz', [(2, 12), (3, 10), (8, 24)])
@pytest.mark.parametrize('method', ['bilinear', 'nearest'])
def test_rotate_and_bin_z(binning, nz, method):
    obj = np.random.default_rng(3).normal(size=(4, 11, nz, 2)).astype(
        np.float32)
    want = jrot.rotate_and_bin_z(jnp.asarray(obj), 0.7, binning,
                                 method=method)
    got = trot.rotate_and_bin_z(torch.from_numpy(obj), 0.7, binning,
                                method=method)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-5


# -- vacuum extraction and predict -------------------------------------------

@pytest.mark.parametrize('unknown_type', ['delta_beta', 'real_imag'])
def test_extract_patches_vacuum(unknown_type):
    """Windows past every edge see vacuum; the gradient drops the vacuum
    part.  A copy: the values and the gradient are equal."""
    rng = np.random.default_rng(4)
    obj = rng.normal(size=(20, 18, 3, 2)).astype(np.float32)
    pos = np.array([[0, 0], [-3, 5], [15, -4], [-7, 12], [9, 9],
                    [17, 15]])
    cot = rng.normal(size=(len(pos), 6, 6, 3, 2)).astype(np.float32)
    want, vjp = jax.vjp(lambda o: jpatches.extract_patches_vacuum(
        o, jnp.asarray(pos), (6, 6), unknown_type=unknown_type),
        jnp.asarray(obj))
    t = torch.from_numpy(obj).requires_grad_()
    got = tpatches.extract_patches_vacuum(t, pos, (6, 6),
                                          unknown_type=unknown_type)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    g, = torch.autograd.grad(got, t, torch.from_numpy(cot))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('unknown_type', ['delta_beta', 'real_imag'])
@pytest.mark.parametrize('theta', [0.0, 1.3])
def test_predict(unknown_type, theta):
    """The whole forward, rotation and vacuum windows included (one window
    reaches past the padded object), against JAX's ``predict``; its
    gradient with respect to the object too.  f32 FFTs in two libraries:
    1e-5 of the largest value."""
    rng = np.random.default_rng(5)
    obj = np.stack([rng.random((N, N, N)) * 1e-3,
                    rng.random((N, N, N)) * 3e-5], -1).astype(np.float32)
    if unknown_type == 'real_imag':
        obj[..., 0] += 1.0
    probe = np.asarray(initialize_probe((PN, PN), 'gaussian',
                                        energy_ev=5000.0, psize_cm=1e-7,
                                        probe_mag_sigma=3,
                                        probe_phase_sigma=3,
                                        probe_phase_max=0.3), np.float32)
    pos = np.array([[0.0, 0.0], [-2.0, 6.4], [13.0, 15.6]], np.float32)
    pad = np.array([[2, 1], [0, 4]], np.int64)
    meas = rng.random((3, PN, PN)).astype(np.float32)

    def cfg(mod):
        return mod.ReconConfig(
            geometry=mod.Geometry(obj_size=(N, N, N), probe_size=(PN, PN),
                                  energy_ev=5000.0, psize_cm=1e-7,
                                  free_prop_cm='inf', binning=2),
            train=mod.TrainConfig(unknown_type=unknown_type))

    def jloss(o):
        pred = jmodel.predict({'obj': o, 'probe': jnp.asarray(probe)},
                              {'i_theta': 0, 'theta': jnp.float32(theta),
                               'pos_batch': jnp.asarray(pos)}, cfg(jcfg), pad)
        return jnp.mean((pred - meas) ** 2), pred

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(obj))
    t = torch.from_numpy(obj).requires_grad_()
    got = tmodel.predict({'obj': t, 'probe': torch.from_numpy(probe)},
                         {'i_theta': 0, 'theta': theta, 'pos_batch': pos},
                         cfg(pt), pad)
    g, = torch.autograd.grad(torch.mean((got - torch.from_numpy(meas)) ** 2),
                             t)
    assert _rel(got.detach().numpy(), want) < 1e-5
    assert _rel(g.numpy(), jg) < 1e-4


# -- trajectories --------------------------------------------------------------

def _setup(jitter=False, unknown_type='delta_beta', seed=0, shift=0):
    rng = np.random.default_rng(seed)
    kw = dict(obj_size=(N, N, N), probe_size=(PN, PN), energy_ev=5000.0,
              psize_cm=1e-7, free_prop_cm='inf')
    obj_true = np.stack([rng.random((N, N, N)) * 1e-3,
                         rng.random((N, N, N)) * 3e-5], -1).astype(np.float32)
    obj0 = np.stack([rng.random((N, N, N)) * 5e-4,
                     rng.random((N, N, N)) * 1.5e-5], -1).astype(np.float32)
    probe = np.asarray(initialize_probe(
        (PN, PN), 'gaussian', energy_ev=5000.0, psize_cm=1e-7,
        probe_mag_sigma=3, probe_phase_sigma=3, probe_phase_max=0.3),
        np.float32)
    xs = np.arange(0, N - PN + 1, 6)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float) + shift
    if jitter:
        pos = pos + rng.integers(-2, 3, pos.shape)
    theta = np.linspace(0, np.pi, 3, endpoint=False)
    data = np.asarray(simulate(
        jcfg.ReconConfig(geometry=jcfg.Geometry(**kw),
                         train=jcfg.TrainConfig(minibatch_size=3)),
        obj_true, probe, pos, theta))
    if unknown_type == 'real_imag':
        obj0 = obj0 * 10
        obj0[..., 0] += 1.0
    return kw, obj0, probe, pos, theta, data


def _run(mod, args, n_epochs=3, geo=None, loss=None, refine=None,
         probe=None, **train):
    kw, obj0, probe0, pos, theta, data = args
    cfg = mod.ReconConfig(
        geometry=mod.Geometry(**kw, **(geo or {})),
        loss=mod.LossConfig(**(loss or {})),
        refine=mod.RefineConfig(**(refine or {})),
        train=mod.TrainConfig(**{'minibatch_size': 3, 'seed': 7,
                                 'learning_rate': 1e-5, 'optimizer': 'gd',
                                 **train}))
    kwargs = dict(data=data, probe_pos=pos, theta_ls=theta,
                  obj_init=obj0.copy(),
                  probe_init=probe0 if probe is None else probe)
    if mod is pt:
        rec = pt.Reconstructor(cfg, device='cpu', **kwargs)
    else:
        rec = jrecon.Reconstructor(cfg, **kwargs)
    losses = np.asarray([rec.run_epoch(e) for e in range(n_epochs)])
    return rec, losses, np.asarray(rec.params['obj'] if mod is jcfg
                                   else rec.obj)


def _both(args, **kw):
    jr, jl, jo = _run(jcfg, args, **kw)
    tr, tl, to = _run(pt, args, **kw)
    return jr, tr, jl, tl, jo, to


#: The object's update after 3 GD epochs, port against JAX, relative to
#: the update's largest entry.  The JAX package's own two forms of the
#: forward (the Pallas kernel in interpret mode and the plain FFT scan)
#: give updates up to 2.2e-4 apart on this drive, so the bound is about
#: twice that.
UPDATE_TOL = 5e-4


BAND_CASES = {
    'delta_beta': dict(),
    'delta_beta_binned': dict(geo=dict(binning=2)),
    # The card's dispatch on the CPU: z-major band extraction and the
    # plain versions of K1 and K6, against JAX's Pallas K1 in interpret
    # mode (JAX's step_band has no z-major form).
    'kernel_plain_binned': dict(geo=dict(binning=2), fused_multislice='on',
                                zmajor_extract='on'),
    # A larger step: the object sits near 1, where an f32 ulp is 1.2e-7.
    'real_imag': dict(unknown_type='real_imag', learning_rate=1e-3),
    # The first row's band starts 4 rows above the object: vacuum going
    # in, dropped coming back (and the table padded in x).
    'rows_past_edge': dict(shift=-4, geo=dict(binning=2)),
    'interp_binned': dict(geo=dict(binning=2), imm_grad_rotation='interp'),
}


@pytest.mark.parametrize('case', list(BAND_CASES))
def test_band_step_gd_trajectory_matches_jax(case):
    """The band step, both packages choosing it (the table is grid rows):
    losses over 3 GD epochs to rtol 1e-5, the object's update to
    :data:`UPDATE_TOL`."""
    kw = dict(BAND_CASES[case])
    args = _setup(unknown_type=kw.get('unknown_type', 'delta_beta'),
                  shift=kw.pop('shift', 0))
    jr, tr, jl, tl, jo, to = _both(args, **kw)
    assert jr._rowgrid_stride == tr._rowgrid_stride == 6
    obj0 = args[1]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.max(np.abs(to - jo)) < UPDATE_TOL * np.max(np.abs(jo - obj0))


@pytest.mark.parametrize('binning', [1, 2])
def test_band_step_tap_adjoint_matches_jax(monkeypatch, binning):
    """The band step with the tap-gather adjoint forced in both packages
    (the JAX package's default form on a TPU)."""
    monkeypatch.setattr(jrecon, 'FORCE_ADJOINT_TAPS', True)
    monkeypatch.setattr(trecon, 'FORCE_ADJOINT_TAPS', True)
    args = _setup()
    jr, tr, jl, tl, jo, to = _both(args, geo=dict(binning=binning))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert (np.max(np.abs(to - jo))
            < UPDATE_TOL * np.max(np.abs(jo - args[1])))


@pytest.mark.parametrize('binning', [1, 2])
def test_generic_step_gd_trajectory_matches_jax(binning):
    """A jittered table, not grid rows: both packages take the generic
    exact-AD step (whole-object rotation inside autodiff), with windows
    past the object's edge padded."""
    args = _setup(jitter=True)
    jr, tr, jl, tl, jo, to = _both(args, geo=dict(binning=binning))
    assert jr._rowgrid_stride is None and tr._rowgrid_stride is None
    assert np.any(tr.pad_arr)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert (np.max(np.abs(to - jo))
            < UPDATE_TOL * np.max(np.abs(jo - args[1])))


@pytest.mark.parametrize('jitter', [False, True])
def test_refined_probe_modes_poisson_matches_jax(jitter):
    """Two probe modes refined with the object (GD, their own step) under
    the Poisson loss, band step and generic step."""
    args = _setup(jitter=jitter)
    probe = np.concatenate([args[2], 0.3 * np.roll(args[2], 2, axis=1)])
    kw = dict(loss=dict(loss_function_type='poisson'),
              refine=dict(optimize_probe=True, probe_optimizer='gd',
                          probe_learning_rate=1e-4),
              n_probe_modes=2, probe=probe)
    jr, tr, jl, tl, jo, to = _both(args, **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert (np.max(np.abs(to - jo))
            < UPDATE_TOL * np.max(np.abs(jo - args[1])))
    jp = np.asarray(jr.params['probe'])
    tp = tr.params['probe'].numpy()
    assert np.max(np.abs(tp - jp)) < UPDATE_TOL * np.max(np.abs(jp - probe))


def test_bf16_band_step_matches_jax_loosely():
    """run_bfloat16: the band rounds to bf16 before extraction in both
    packages; losses to 1e-4, the update to 1e-2.  Both through the
    multislice kernel (JAX's in interpret mode), which computes in f32: the
    JAX package's plain scan computes the modulator in bf16, the port's in
    f32 (a deliberate difference, ROADMAP C)."""
    args = _setup()
    jr, tr, jl, tl, jo, to = _both(args, n_epochs=2, geo=dict(binning=2),
                                   run_bfloat16=True, fused_multislice='on',
                                   zmajor_extract='on')
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert np.max(np.abs(to - jo)) < 1e-2 * np.max(np.abs(jo - args[1]))


@pytest.mark.parametrize('jitter', [False, True])
def test_adam_matches_jax_loosely(jitter):
    """Adam normalises each entry's step, so f32 noise in a near-zero
    gradient can flip its sign: the losses tightly, the update loosely.
    The step is 1e-6, 0.2% of the object's entries (1e-5 would move each
    by 2% a step)."""
    args = _setup(jitter=jitter)
    jr, tr, jl, tl, jo, to = _both(args, n_epochs=2, optimizer='adam',
                                   learning_rate=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.mean(np.abs(to - jo)) < 1e-2 * np.mean(np.abs(jo - args[1]))


def test_default_train_config_runs_the_band_step():
    """``TrainConfig()`` as it is (immediate, rotation in the loop, Adam,
    minibatch 23) on two grid rows of 23 spots at stride 1: the port runs
    it on the CPU, and its first epoch's loss is the JAX package's."""
    rng = np.random.default_rng(9)
    xs = np.arange(23)
    pos = np.stack([np.repeat([0, 6], 23), np.tile(xs, 2)], -1).astype(float)
    data = rng.random((2, len(pos), PN, PN)).astype(np.float32)
    obj0 = (rng.random((N, N, N, 2)) * 1e-4).astype(np.float32)
    losses = []
    for mod, R, kw in ((jcfg, jrecon.Reconstructor, {}),
                       (pt, pt.Reconstructor, {'device': 'cpu'})):
        cfg = mod.ReconConfig(geometry=mod.Geometry(
            obj_size=(N, N, N), probe_size=(PN, PN), energy_ev=5000.0,
            psize_cm=1e-7, free_prop_cm='inf'))
        assert cfg.train == mod.TrainConfig()
        rec = R(cfg, data=data, probe_pos=pos,
                theta_ls=np.array([0.0, 1.0]), obj_init=obj0, **kw)
        losses.append(rec.run_epoch(0))
    assert rec._rowgrid_stride == 1
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


@pytest.mark.parametrize('kw,exc,match', [
    (dict(train=dict(optimizer='curveball'), parallel=dict(data_axis=2)),
     ValueError, 'device meshes'),
    (dict(parallel=dict(data_axis=2)), ValueError, 'device meshes'),
    (dict(parallel=dict(object_axis=2)), ValueError, 'device meshes'),
    (dict(parallel=dict(offload_optimizer_state=True, data_axis=2)),
     ValueError, 'device meshes'),
    (dict(train=dict(optimizer='cg'),
          parallel=dict(offload_optimizer_state=True, offload_object=True)),
     ValueError, 'a first-order object optimizer'),
    (dict(parallel=dict(offload_object=True)), ValueError,
     "update_scheme='per angle' with rotate_out_of_loop")])
def test_unported_immediate_configs_raise(kw, exc, match):
    """What the immediate scheme refuses, under the second-order
    optimizers too: a config that asks for a mesh (with offload too) without one (no process
    group, no ``mesh=``) raises ValueError rather than run on one device;
    object offload, which needs the per-angle path, raises the JAX
    package's ``ValueError``."""
    args = _setup()
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(**args[0]),
        loss=pt.LossConfig(**kw.get('loss', {})),
        refine=pt.RefineConfig(**kw.get('refine', {})),
        train=pt.TrainConfig(minibatch_size=3, **kw.get('train', {})),
        parallel=pt.ParallelConfig(**kw.get('parallel', {})),
        io=pt.IOConfig(**kw.get('io', {})))
    with pytest.raises(exc, match=match):
        pt.Reconstructor(cfg, data=args[5], probe_pos=args[3],
                         theta_ls=args[4], obj_init=args[1], device='cpu')


@pytest.mark.parametrize('train', [{}], ids=['orbax'])
def test_orbax_immediate_runs_and_writes_sharded_checkpoint(tmp_path, train):
    """``use_orbax=True`` on the immediate scheme: the band step runs and
    its checkpoint is the sharded form (``checkpoint/dcp/``)."""
    args = _setup()
    cfg = pt.ReconConfig(geometry=pt.Geometry(**args[0]),
                         train=pt.TrainConfig(minibatch_size=3, **train),
                         io=pt.IOConfig(use_orbax=True))
    rec = pt.Reconstructor(cfg, data=args[5], probe_pos=args[3],
                           theta_ls=args[4], obj_init=args[1], device='cpu',
                           output_folder=str(tmp_path))
    assert rec._band and np.isfinite(rec.run_epoch(0))
    rec.save_checkpoint(1, 0)
    assert (tmp_path / 'checkpoint' / 'dcp' / '.metadata').is_file()
    assert not (tmp_path / 'checkpoint' / 'checkpoint.npz').exists()


def test_convert_carries_immediate_state_across():
    """The immediate scheme carries no state the per-angle one lacks: a
    JAX run continued in the port after ``params_from_jax`` (parameters,
    Adam moments, step counters) takes the JAX run's next epoch."""
    from adorym_tpu_torch import convert
    args = _setup()
    jr, _, _ = _run(jcfg, args, n_epochs=1, optimizer='adam',
                    learning_rate=1e-6)
    tr, _, _ = _run(pt, args, n_epochs=0, optimizer='adam',
                    learning_rate=1e-6)
    tr.params, tr.opt_state = convert.params_from_jax(
        {k: np.asarray(v) for k, v in jr.params.items()},
        {k: {n: np.asarray(a) for n, a in st.items()}
         for k, st in jr.opt_state.items()}, device='cpu')
    tr.i_opt_batch, tr.global_batch = jr.i_opt_batch, jr.global_batch
    assert tr.i_opt_batch == 9
    np.testing.assert_allclose(tr.run_epoch(1), jr.run_epoch(1), rtol=1e-5)


def test_make_batches_pads_like_jax():
    """A ragged row-grid table (the last batch repeats the last spot) and
    a random one under randomize_probe_pos (random spots): the same draws
    as the JAX package."""
    args = list(_setup())
    for pos, randomize in ((args[3][:-1], False), (args[3][:-2], True)):
        args[3] = pos
        args[5] = args[5][:, :len(pos)]
        recs = []
        for mod, R, kw in ((jcfg, jrecon.Reconstructor, {}),
                           (pt, pt.Reconstructor, {'device': 'cpu'})):
            cfg = mod.ReconConfig(
                geometry=mod.Geometry(**args[0]),
                train=mod.TrainConfig(minibatch_size=3,
                                      randomize_probe_pos=randomize))
            recs.append(R(cfg, data=args[5], probe_pos=pos,
                          theta_ls=args[4], obj_init=args[1], **kw))
        for seed in range(3):
            jb, tb = (r.make_batches(np.random.default_rng(seed))
                      for r in recs)
            assert ([(i, list(b)) for i, b in jb]
                    == [(i, list(b)) for i, b in tb])


def test_interp_on_generic_table_warns():
    args = _setup(jitter=True)
    cfg = pt.ReconConfig(geometry=pt.Geometry(**args[0]),
                         train=pt.TrainConfig(minibatch_size=3,
                                              imm_grad_rotation='interp'))
    with pytest.warns(UserWarning, match='exact-AD generic step'):
        pt.Reconstructor(cfg, data=args[5], probe_pos=args[3],
                         theta_ls=args[4], obj_init=args[1], device='cpu')
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        cfg = cfg.replace(train=pt.TrainConfig(minibatch_size=3))
        pt.Reconstructor(cfg, data=args[5], probe_pos=args[3],
                         theta_ls=args[4], obj_init=args[1], device='cpu')


def test_adjoint_form_auto_is_the_transpose(monkeypatch):
    """Auto takes the autograd transpose (faster on the H100 than the tap
    gather); forcing takes the taps, for bilinear interpolation only."""
    cfg = pt.ReconConfig(geometry=pt.Geometry(obj_size=(N, N, N),
                                              probe_size=(PN, PN)))
    assert not trecon._use_adjoint_taps(cfg)
    monkeypatch.setattr(trecon, 'FORCE_ADJOINT_TAPS', True)
    assert trecon._use_adjoint_taps(cfg)
    near = cfg.replace(train=pt.TrainConfig(interpolation='nearest'))
    assert not trecon._use_adjoint_taps(near)
