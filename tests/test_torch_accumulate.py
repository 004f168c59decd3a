"""The port's accumulate-then-update loop and the refinables it carries,
against the JAX package on the same numpy inputs: the per-angle scheme
with the rotation inside autodiff, the immediate scheme with
``rotate_out_of_loop`` (the gradient rotated back at -theta or by the
exact transpose), ``n_batch_per_update``, regularizers and shrink-wrap in
the loop, tilt (its precedence over ``rotate_out_of_loop``, fixed and
refined), refined slice positions, the refined kappa, the minus-logged
line-projection tomography, the multi-distance model's CTF under the
per-angle scheme, a resume in the middle of an angle, the API's keywords
and ``convert``'s carrying of the new leaves.

The 3D drive is ``tests/test_torch_immediate.py``'s (24^3, 12^2 probe at
stride 6, 3 angles, minibatch 3).  Tolerances as there: GD losses at rtol
1e-5 and the object's update at ``UPDATE_TOL`` of its largest entry; each
refined leaf's update likewise; Adam's losses at 1e-5 over one epoch from
a shared state (``convert``)."""

import numpy as np
import pytest
import torch

import adorym_tpu as jpkg
import adorym_tpu.config as jcfg
import adorym_tpu.recon as jrecon
from adorym_tpu.models import multidist as jmd
from adorym_tpu.simulate import simulate as jsimulate
from adorym_tpu.simulate import simulate_to_file as jsimulate_to_file
from adorym_tpu.utils.initialize import initialize_probe
import adorym_tpu_torch as pt
from adorym_tpu_torch.models import multidist as tmd
from test_torch_immediate import UPDATE_TOL, _run, _setup


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors (several test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _upd_close(t, j, start, tol=UPDATE_TOL):
    t, j = np.asarray(t), np.asarray(j)
    return np.max(np.abs(t - j)) <= tol * np.max(np.abs(j - np.asarray(start)))


def _probe(pn):
    return initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                            psize_cm=1e-7, probe_mag_sigma=pn / 4,
                            probe_phase_sigma=pn / 4, probe_phase_max=0.3)


# -- the loop's schemes --------------------------------------------------------

ACCUM_CASES = {
    # The rotation inside autodiff, one update an angle.
    'per_angle_in_loop': dict(update_scheme='per angle'),
    'per_angle_in_loop_binned': dict(update_scheme='per angle',
                                     geo=dict(binning=2)),
    'per_angle_in_loop_jitter': dict(update_scheme='per angle', jitter=True),
    'per_angle_in_loop_real_imag': dict(update_scheme='per angle',
                                        unknown_type='real_imag',
                                        learning_rate=1e-3),
    # Rotated once an angle, stale within it; an update a batch.
    'rol_immediate': dict(rotate_out_of_loop=True),
    'rol_immediate_exact': dict(rotate_out_of_loop=True,
                                exact_grad_rotation=True),
    'n_batch_per_update': dict(n_batch_per_update=2),
    'n_batch_per_update_rol': dict(n_batch_per_update=2,
                                   rotate_out_of_loop=True),
    # The per-angle scheme with more than one batch an update takes the
    # loop too (one update an angle, the gradient rotated back once).
    'per_angle_rol_n_batch': dict(update_scheme='per angle',
                                  rotate_out_of_loop=True,
                                  n_batch_per_update=2),
    # Regularizers on the object the loop differentiates at (the rotated
    # one under rotate_out_of_loop), reweighted L1 refreshed every 10
    # batches.
    'rol_immediate_regularized': dict(
        rotate_out_of_loop=True,
        loss=dict(alpha_d=1e-9, alpha_b=1e-10, reweighted_l1=True,
                  gamma=1e-9)),
}


@pytest.mark.parametrize('case', list(ACCUM_CASES))
def test_accumulate_gd_trajectory_matches_jax(case):
    """Both packages take the accumulate-then-update loop: the same
    update count, losses over 2 GD epochs at rtol 1e-5, the object's update
    to :data:`UPDATE_TOL`."""
    kw = dict(ACCUM_CASES[case])
    args = _setup(jitter=kw.pop('jitter', False),
                  unknown_type=kw.get('unknown_type', 'delta_beta'))
    jr, jl, jo = _run(jcfg, args, n_epochs=2, **kw)
    tr, tl, to = _run(pt, args, n_epochs=2, **kw)
    assert tr._accum and not tr._band and not tr._angles
    assert tr.i_opt_batch == jr.i_opt_batch
    assert tr.global_batch == jr.global_batch
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert _upd_close(to, jo, args[1])


def test_update_counts():
    """``i_opt_batch`` counts updates and ``global_batch`` batches: 3
    angles of 3 batches, 2 epochs."""
    args = _setup()
    counts = {}
    for name, kw in (('per angle', dict(update_scheme='per angle')),
                     ('rol', dict(rotate_out_of_loop=True)),
                     ('n2', dict(n_batch_per_update=2))):
        rec, _, _ = _run(pt, args, n_epochs=2, learning_rate=0.0, **kw)
        counts[name] = (rec.i_opt_batch, rec.global_batch)
    assert counts == {'per angle': (6, 18), 'rol': (18, 18), 'n2': (12, 18)}


def test_shrink_wrap_in_the_loop_matches_jax():
    """A support mask that shrinks every 2 batches on the loop's cadence,
    the per-angle scheme with the rotation inside autodiff: losses and the
    shrunk masks as JAX's."""
    args = _setup()
    kw_, obj0, probe, pos, theta, data = args
    out = []
    for mod in (jcfg, pt):
        cfg = mod.ReconConfig(
            geometry=mod.Geometry(**kw_),
            train=mod.TrainConfig(minibatch_size=3, seed=7, optimizer='gd',
                                  learning_rate=1e-5,
                                  update_scheme='per angle', shrink_cycle=2,
                                  shrink_threshold=2.5e-4))
        kw = dict(data=data, probe_pos=pos, theta_ls=theta,
                  obj_init=obj0.copy(), probe_init=probe,
                  finite_support_mask=np.ones(kw_['obj_size'], np.float32))
        rec = (pt.Reconstructor(cfg, device='cpu', **kw) if mod is pt
               else jrecon.Reconstructor(cfg, **kw))
        losses = [rec.run_epoch(e) for e in range(2)]
        out.append((losses, np.asarray(rec.finite_support_mask)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    np.testing.assert_array_equal(out[1][1], out[0][1])
    assert 0 < out[1][1].sum() < out[1][1].size


def test_resume_mid_angle_matches_jax(tmp_path):
    """A checkpoint every 2 batches lands inside an angle (3 batches an
    angle): resuming there starts a new accumulation, without the partial
    sum, in both packages; the port also resumes from the JAX package's
    checkpoint.  Momentum: the JAX package restores no state for a GD
    object (its checkpoint has none), so its resume needs one."""
    args = _setup()
    kw_, obj0, probe, pos, theta, data = args

    def make(mod, folder):
        cfg = mod.ReconConfig(
            geometry=mod.Geometry(**kw_),
            train=mod.TrainConfig(minibatch_size=3, seed=7,
                                  optimizer='momentum', learning_rate=1e-5,
                                  update_scheme='per angle'),
            io=mod.IOConfig(n_batch_per_checkpoint=2))
        kw = dict(data=data, probe_pos=pos, theta_ls=theta,
                  obj_init=obj0.copy(), probe_init=probe,
                  output_folder=str(folder))
        if mod is pt:
            return pt.Reconstructor(cfg, device='cpu', **kw)
        return jrecon.Reconstructor(cfg, **kw)

    objs = {}
    for name, mod in (('jax', jcfg), ('port', pt)):
        make(mod, tmp_path / name).run_epoch(0)
        rec = make(mod, tmp_path / name)
        assert (rec._start_epoch, rec._start_batch) == (0, 8)
        rec.run_epoch(0)
        objs[name] = np.asarray(rec.params['obj'])
        assert (rec.i_opt_batch, rec.global_batch) == (3, 9)
    cross = make(pt, tmp_path / 'jax')
    cross.run_epoch(0)
    assert _upd_close(objs['port'], objs['jax'], obj0)
    assert _upd_close(cross.obj, objs['jax'], obj0)


def test_adam_accumulate_matches_jax_loosely():
    """Adam through the loop (the rotation inside autodiff, per angle):
    the losses tightly, the update loosely (Adam turns f32 noise in a
    near-zero gradient into a full step)."""
    args = _setup()
    jr, jl, jo = _run(jcfg, args, n_epochs=2, optimizer='adam',
                      learning_rate=1e-6, update_scheme='per angle')
    tr, tl, to = _run(pt, args, n_epochs=2, optimizer='adam',
                      learning_rate=1e-6, update_scheme='per angle')
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.mean(np.abs(to - jo)) < 1e-2 * np.mean(np.abs(jo - args[1]))


# -- tilt ----------------------------------------------------------------------

def _tilt_setup(n=16, pn=16, seed=3, theta=(0.3, 0.9)):
    rng = np.random.default_rng(seed)
    obj_true = np.stack([rng.random((n, n, n)) * 1e-3,
                         rng.random((n, n, n)) * 3e-5], -1).astype(np.float32)
    probe = _probe(pn)
    pos = np.array([[0.0, 0.0]])
    geo = dict(obj_size=(n, n, n), probe_size=(pn, pn), energy_ev=5000.0,
               psize_cm=1e-7, free_prop_cm='inf')
    theta = np.asarray(theta, np.float32)
    data = np.asarray(jsimulate(
        jcfg.ReconConfig(geometry=jcfg.Geometry(**geo),
                         train=jcfg.TrainConfig(minibatch_size=1)),
        obj_true, probe, pos, theta))
    return obj_true, probe, pos, geo, theta, data


def _tilt_run(mod, setup, refine, n_epochs=3, aux_init=None, **train):
    obj_true, probe, pos, geo, theta, data = setup
    cfg = mod.ReconConfig(geometry=mod.Geometry(**geo),
                          refine=mod.RefineConfig(**refine),
                          train=mod.TrainConfig(minibatch_size=1, seed=7,
                                                **train))
    kw = dict(data=data, probe_pos=pos, probe_init=probe, theta_ls=theta,
              obj_init=(obj_true * 0.5).astype(np.float32),
              aux_init=aux_init)
    rec = (pt.Reconstructor(cfg, device='cpu', **kw) if mod is pt
           else jrecon.Reconstructor(cfg, **kw))
    losses = [rec.run_epoch(e) for e in range(n_epochs)]
    return rec, np.asarray(losses)


def test_tilt_precedence_over_rotate_out_of_loop():
    """Tilt with and without ``rotate_out_of_loop`` follows one trajectory
    (the model's tilt rotation replaces the view rotation, so the loop
    neither pre-rotates nor rotates back), the JAX package's
    ``test_tilt_precedence_over_rotate_out_of_loop`` in the port, and that
    trajectory is the JAX package's."""
    setup = _tilt_setup()
    refine = dict(optimize_tilt=True, tilt_learning_rate=1e-3)
    train = dict(learning_rate=1e-7, optimizer='adam',
                 update_scheme='per angle')
    recs = [_tilt_run(pt, setup, refine, rotate_out_of_loop=rol, **train)
            for rol in (False, True)]
    assert not recs[1][0]._rol and recs[1][0]._accum
    np.testing.assert_array_equal(recs[0][0].params['tilt_ls'].numpy(),
                                  recs[1][0].params['tilt_ls'].numpy())
    np.testing.assert_array_equal(recs[0][0].obj, recs[1][0].obj)
    np.testing.assert_array_equal(recs[0][1], recs[1][1])
    # Adam's steps are the learning rate's size whatever the gradient, so
    # the two packages' trajectories are held loosely (ROADMAP.md).
    jr, jl = _tilt_run(jcfg, setup, refine, rotate_out_of_loop=True, **train)
    np.testing.assert_allclose(recs[1][1], jl, rtol=1e-4)
    np.testing.assert_allclose(recs[1][0].params['tilt_ls'].numpy(),
                               np.asarray(jr.params['tilt_ls']), atol=1e-5)


@pytest.mark.parametrize('scheme', ['per angle', 'immediate'])
def test_tilt_gd_trajectory_matches_jax(scheme):
    """Refined tilts under GD, initialized at the view angles: the losses,
    the tilts' and the object's updates as JAX's.  The steps keep the
    loss within a factor of 2 of its start: where the residual shrinks
    tenfold, its f32 rounding in either package reaches 1e-5 of it."""
    setup = _tilt_setup()
    refine = dict(optimize_tilt=True, tilt_learning_rate=2e-3,
                  tilt_optimizer='gd')
    kw = dict(learning_rate=1e-5, optimizer='gd', update_scheme=scheme)
    jr, jl = _tilt_run(jcfg, setup, refine, **kw)
    tr, tl = _tilt_run(pt, setup, refine, **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] > 0.5 * tl[0]
    t0 = np.stack([setup[4], np.zeros(2), np.zeros(2)])
    jt = np.asarray(jr.params['tilt_ls'])
    assert np.max(np.abs(jt - t0)) > 1e-6
    assert _upd_close(tr.params['tilt_ls'].numpy(), jt, t0)
    assert _upd_close(tr.obj, np.asarray(jr.params['obj']),
                      setup[0] * 0.5)


def test_fixed_tilt_matches_jax():
    """Known tilts (``fixed_tilt``): no optimizer spec, the leaf never
    moves, and the losses of a GD run are JAX's."""
    setup = _tilt_setup(seed=4, theta=(0.5,))
    tilt = np.stack([setup[4], [0.1], [0.0]]).astype(np.float32)
    kw = dict(learning_rate=1e-4, optimizer='gd')
    jr, jl = _tilt_run(jcfg, setup, dict(fixed_tilt=True), n_epochs=2,
                       aux_init={'tilt_ls': tilt}, **kw)
    tr, tl = _tilt_run(pt, setup, dict(fixed_tilt=True), n_epochs=2,
                       aux_init={'tilt_ls': tilt}, **kw)
    assert 'tilt_ls' not in tr.specs
    np.testing.assert_array_equal(tr.params['tilt_ls'].numpy(), tilt)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_tilt_in_2d_raises():
    setup = _tilt_setup(n=8, pn=8, theta=(0.0,))
    cfg = pt.ReconConfig(geometry=pt.Geometry(obj_size=(8, 8, 1),
                                              probe_size=(8, 8),
                                              two_d_mode=True),
                         refine=pt.RefineConfig(fixed_tilt=True))
    with pytest.raises(NotImplementedError, match='two_d_mode'):
        pt.Reconstructor(cfg, data=setup[5], probe_pos=setup[2],
                         device='cpu')


# -- slice positions, kappa, line projections ----------------------------------

def _grid(n, pn, stride):
    xs = np.arange(0, n - pn + 1, stride)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    return np.stack([yy.ravel(), xx.ravel()], -1).astype(float)


def _refined_run(mod, geo, obj0, probe, pos, theta, data, refine,
                 n_epochs=2, aux_init=None, model=None, **train):
    cfg = mod.ReconConfig(geometry=mod.Geometry(**geo),
                          refine=mod.RefineConfig(**refine),
                          train=mod.TrainConfig(**{'seed': 7,
                                                   'optimizer': 'gd',
                                                   **train}))
    kw = dict(data=data, probe_pos=pos, probe_init=probe, theta_ls=theta,
              obj_init=obj0.copy(), aux_init=aux_init)
    if model is not None:
        kw['model'] = model
    rec = (pt.Reconstructor(cfg, device='cpu', **kw) if mod is pt
           else jrecon.Reconstructor(cfg, **kw))
    return rec, np.asarray([rec.run_epoch(e) for e in range(n_epochs)])


def test_slice_positions_gd_matches_jax():
    """Sparse slices at ``[0, 10e-4]`` cm refined (the reference's
    sparse-multislice test's geometry at 24^2), a grid scan, one view:
    both packages move the second slice the same way."""
    n, pn = 24, 12
    rng = np.random.default_rng(11)
    obj_true = np.stack([rng.random((n, n, 2)) * 3e-3,
                         rng.random((n, n, 2)) * 8e-5], -1).astype(np.float32)
    obj0 = (obj_true * 0.8).astype(np.float32)
    probe = _probe(pn)
    pos = _grid(n, pn, 6)
    geo = dict(obj_size=(n, n, 2), probe_size=(pn, pn), energy_ev=5000.0,
               psize_cm=1e-7, free_prop_cm='inf',
               slice_pos_cm_ls=(0.0, 10e-4))
    sim_geo = dict(geo, slice_pos_cm_ls=(0.0, 10.3e-4))
    data = np.asarray(jsimulate(
        jcfg.ReconConfig(geometry=jcfg.Geometry(**sim_geo)), obj_true,
        probe, pos, np.zeros(1)))
    refine = dict(optimize_slice_pos=True, slice_pos_optimizer='gd',
                  slice_pos_learning_rate=1e-12)
    out = [_refined_run(mod, geo, obj0, probe, pos, np.zeros(1), data,
                        refine, minibatch_size=3, learning_rate=1e-4)
           for mod in (jcfg, pt)]
    (jr, jl), (tr, tl) = out
    assert tr._band
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    start = np.asarray([0.0, 10e-4], np.float32)
    js = np.asarray(jr.params['slice_pos_cm_ls'])
    assert js[0] == 0 and abs(js[1] - start[1]) > 1e-9
    assert _upd_close(tr.params['slice_pos_cm_ls'].numpy(), js, start)
    assert _upd_close(tr.obj, np.asarray(jr.params['obj']), obj0)


@pytest.mark.parametrize('scheme', ['immediate', 'per angle'])
def test_kappa_gd_matches_jax(scheme):
    """``ctf_lg_kappa`` refined on the ptychography model's plain
    multislice (``beta = 10**ctf_lg_kappa * delta``), from the API's
    starting value."""
    args = _setup()
    kw_, obj0, probe, pos, theta, data = args
    refine = dict(optimize_ctf_lg_kappa=True, ctf_lg_kappa_optimizer='gd',
                  ctf_lg_kappa_learning_rate=1e-3)
    out = [_refined_run(mod, kw_, obj0, probe, pos, theta, data, refine,
                        aux_init={'ctf_lg_kappa': -1.5}, minibatch_size=3,
                        learning_rate=1e-5, update_scheme=scheme)
           for mod in (jcfg, pt)]
    (jr, jl), (tr, tl) = out
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jk = np.asarray(jr.params['ctf_lg_kappa'])
    assert abs(jk[0] + 1.5) > 1e-6
    assert _upd_close(tr.params['ctf_lg_kappa'].numpy(), jk, [-1.5])


@pytest.mark.parametrize('scheme', ['immediate', 'per angle'])
def test_line_projection_tomography_matches_jax(scheme):
    """The minus-logged line projections of absorption tomography: the
    projection approximation of a 16^3 object, a 16^2 plane-wave field,
    one position an angle, no propagation, 4 angles."""
    n = 16
    rng = np.random.default_rng(12)
    obj_true = np.stack([np.zeros((n, n, n)), rng.random((n, n, n)) * 1e-2],
                        -1).astype(np.float32)
    obj0 = (obj_true * 0.7).astype(np.float32)
    probe = np.stack([np.ones((n, n)), np.zeros((n, n))],
                     -1)[None].astype(np.float32)
    geo = dict(obj_size=(n, n, n), probe_size=(n, n), energy_ev=5000.0,
               psize_cm=1e-7, free_prop_cm=0, pure_projection=True,
               is_minus_logged=True)
    theta = np.linspace(0, np.pi, 4, endpoint=False).astype(np.float32)
    pos = np.zeros((1, 2))
    data = np.asarray(jsimulate(jcfg.ReconConfig(geometry=jcfg.Geometry(
        **geo)), obj_true, probe, pos, theta))
    out = [_refined_run(mod, geo, obj0, probe, pos, theta, data, {},
                        n_epochs=3, minibatch_size=1, learning_rate=1e-3,
                        update_scheme=scheme)
           for mod in (jcfg, pt)]
    (jr, jl), (tr, tl) = out
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert jl[-1] < jl[0]
    assert _upd_close(tr.obj, np.asarray(jr.params['obj']), obj0)


@pytest.mark.parametrize('kappa', [False, True])
def test_multidist_ctf_per_angle_matches_jax(kappa):
    """The multi-distance model's CTF (two distances, refined) under the
    per-angle scheme, which takes the accumulate loop, with kappa refined
    or at the configured value."""
    n = 16
    rng = np.random.default_rng(13)
    from scipy.ndimage import gaussian_filter
    # A phase of about 0.5 rad: the holograms differ from 1 by more than
    # f32's rounding of values near 1.
    ph = gaussian_filter(rng.random((n, n)), 2).astype(np.float32)
    obj_true = np.stack([ph * 2e-2, ph * 4e-4], -1)[:, :, None]
    obj0 = (obj_true * 0.5).astype(np.float32)
    probe = np.stack([np.ones((n, n)), np.zeros((n, n))],
                     -1)[None].astype(np.float32)
    geo = dict(obj_size=(n, n, 1), probe_size=(n, n), energy_ev=5000.0,
               psize_cm=1e-7, free_prop_cm=(2e-4, 5e-4), n_dists=2,
               two_d_mode=True, safe_zone_width=2)
    sim_cfg = jcfg.ReconConfig(geometry=jcfg.Geometry(**geo),
                               train=jcfg.TrainConfig(forward_algorithm='ctf',
                                                      ctf_kappa=50.0))
    pos = np.zeros((1, 2))
    data = np.asarray(jsimulate(sim_cfg, obj_true, probe, pos, np.zeros(1),
                                model=jmd))
    refine = dict(optimize_free_prop=True, free_prop_optimizer='gd',
                  free_prop_learning_rate=1e-12,
                  optimize_ctf_lg_kappa=kappa, ctf_lg_kappa_optimizer='gd',
                  ctf_lg_kappa_learning_rate=1e-2)
    out = []
    for mod, model in ((jcfg, jmd), (pt, tmd)):
        out.append(_refined_run(
            mod, geo, obj0, probe, pos, np.zeros(1), data, refine,
            n_epochs=3, model=model, aux_init={'ctf_lg_kappa': 1.5}
            if kappa else None, minibatch_size=1, learning_rate=0.3,
            update_scheme='per angle', forward_algorithm='ctf',
            ctf_kappa=40.0))
    (jr, jl), (tr, tl) = out
    assert tr._accum
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in tr.specs:
        start = obj0 if k == 'obj' else {
            'free_prop_cm': [2e-4, 5e-4], 'ctf_lg_kappa': [1.5]}[k]
        assert _upd_close(tr.params[k].numpy(), np.asarray(jr.params[k]),
                          start), k


def test_simulate_new_forward_models():
    """``simulate`` runs the projection approximation, sparse slices and
    the multi-distance CTF as the JAX package's does."""
    n = 16
    rng = np.random.default_rng(14)
    obj = np.stack([rng.random((n, n, 2)) * 1e-3,
                    rng.random((n, n, 2)) * 3e-5], -1).astype(np.float32)
    probe = _probe(n)
    pos = np.zeros((1, 2))
    cases = [
        (dict(obj_size=(n, n, 2), probe_size=(n, n), free_prop_cm='inf',
              slice_pos_cm_ls=(0.0, 5e-5)), {}, None),
        (dict(obj_size=(n, n, 2), probe_size=(n, n), free_prop_cm=0,
              pure_projection=True, is_minus_logged=True), {}, None),
        (dict(obj_size=(n, n, 1), probe_size=(n, n), free_prop_cm=(2e-4,
                                                                    4e-4),
              n_dists=2, two_d_mode=True, safe_zone_width=2),
         dict(forward_algorithm='ctf'), 'md'),
    ]
    for geo, train, model in cases:
        o = obj[:, :, :geo['obj_size'][2]]
        j = np.asarray(jsimulate(
            jcfg.ReconConfig(geometry=jcfg.Geometry(**geo),
                             train=jcfg.TrainConfig(**train)),
            o, probe, pos, np.asarray([0.0, 0.6]),
            model=jmd if model else None))
        t = pt.simulate(pt.ReconConfig(geometry=pt.Geometry(**geo),
                                       train=pt.TrainConfig(**train)),
                        o, probe, pos, np.asarray([0.0, 0.6]),
                        model=tmd if model else None, device='cpu')
        assert t.shape == j.shape
        assert np.max(np.abs(t - j)) <= 1e-5 * np.max(np.abs(j))


# -- the API and convert -------------------------------------------------------

def test_api_initial_tilt_and_slice_positions(tmp_path):
    """``initial_tilt`` (the tilts as given, never updated) and refined
    ``slice_pos_cm_ls`` through ``reconstruct_ptychography``, against the
    JAX package's entry point."""
    setup = _tilt_setup(n=8, pn=8, seed=6, theta=(0.0, 0.7))
    obj_true, probe, pos, geo, theta, _ = setup
    path = str(tmp_path / 'data.h5')
    jsimulate_to_file(path, jcfg.ReconConfig(geometry=jcfg.Geometry(**geo)),
                      obj_true, probe, pos, theta)
    tilt = np.stack([theta, [0.05, 0.0], [0.0, 0.0]]).astype(np.float32)
    probe_c = probe[0, ..., 0] + 1j * probe[0, ..., 1]
    common = dict(fname='data.h5', save_path=str(tmp_path),
                  obj_size=(8, 8, 8), probe_pos=pos,
                  probe_initial=(np.abs(probe_c), np.angle(probe_c)),
                  probe_type='supplied', n_epochs=2, minibatch_size=1,
                  learning_rate=1e-4, optimizer='gd', output_folder=None,
                  store_checkpoint=False, use_checkpoint=False, gamma=0.0)
    for extra in (dict(initial_tilt=tilt),
                  dict(slice_pos_cm_ls=[0.0, 3e-5], obj_size=(8, 8, 2),
                       optimize_slice_pos=True, optimizer_slice_pos='gd',
                       slice_pos_learning_rate=1e-12)):
        kw = {**common, **extra}
        jres = jpkg.reconstruct_ptychography(**kw)
        tres = pt.reconstruct_ptychography(**kw, device='cpu')
        np.testing.assert_allclose(tres['loss_history'],
                                   jres['loss_history'], rtol=1e-5)
        if 'initial_tilt' in extra:
            np.testing.assert_array_equal(tres['tilt_ls'], tilt)
        else:
            assert abs(jres['slice_pos_cm_ls'][1] - 3e-5) > 1e-10
            np.testing.assert_allclose(tres['slice_pos_cm_ls'],
                                       jres['slice_pos_cm_ls'], rtol=1e-5)


def test_convert_carries_slice_positions_tilt_and_kappa():
    """A JAX run with refined slice positions, tilts and kappa (Adam),
    continued in the port after ``params_from_jax`` (the leaves and their
    moments, the step counts), takes the JAX run's next epoch."""
    from adorym_tpu_torch import convert
    n, pn = 12, 12
    rng = np.random.default_rng(15)
    obj = np.stack([rng.random((n, n, 2)) * 1e-3,
                    rng.random((n, n, 2)) * 3e-5], -1).astype(np.float32)
    probe = _probe(pn)
    pos = np.zeros((1, 2))
    geo = dict(obj_size=(n, n, 2), probe_size=(pn, pn), free_prop_cm='inf',
               slice_pos_cm_ls=(0.0, 4e-5))
    theta = np.asarray([0.2, 0.8], np.float32)
    data = np.asarray(jsimulate(jcfg.ReconConfig(
        geometry=jcfg.Geometry(**geo)), obj, probe, pos, theta)) * 1.02
    # Slice steps of 1e-8 cm: the Fresnel phase between the slices reaches
    # 80 rad at the edge of the spectrum, so the reference's default step
    # (1e-4 cm) would move it by 2e5 rad a step.
    refine = dict(optimize_slice_pos=True, slice_pos_learning_rate=1e-8,
                  optimize_tilt=True, optimize_ctf_lg_kappa=True)
    kw = dict(minibatch_size=1, learning_rate=1e-6, optimizer='adam')
    jr, _ = _refined_run(jcfg, geo, obj, probe, pos, theta, data, refine,
                         n_epochs=1, **kw)
    tr, _ = _refined_run(pt, geo, obj, probe, pos, theta, data, refine,
                         n_epochs=0, **kw)
    tr.params, tr.opt_state = convert.params_from_jax(
        {k: np.asarray(v) for k, v in jr.params.items()},
        {k: {m: np.asarray(a) for m, a in st.items()}
         for k, st in jr.opt_state.items()}, device='cpu')
    assert {'slice_pos_cm_ls', 'tilt_ls', 'ctf_lg_kappa'} <= set(
        tr.opt_state)
    tr.i_opt_batch, tr.global_batch = jr.i_opt_batch, jr.global_batch
    np.testing.assert_allclose(tr.run_epoch(1), jr.run_epoch(1), rtol=1e-5)
    # Adam's steps are each leaf's learning rate: held to 1e-3 of one.
    for k, lr in (('slice_pos_cm_ls', 1e-8), ('tilt_ls', 1e-3),
                  ('ctf_lg_kappa', 1e-3)):
        np.testing.assert_allclose(tr.params[k].numpy(),
                                   np.asarray(jr.params[k]), rtol=0,
                                   atol=1e-3 * lr)
