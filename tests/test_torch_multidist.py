"""Multi-distance holography in the port against the JAX package on the
CPU: the model's pieces (safe zone, padding, index expansion, the forward
with and without tiles and in 3-D, the data-side registration), the
simulation, the affine warp, 3-epoch trajectories refining the distances,
the affines and the per-distance shifts, and the two multi-distance demos'
configurations through ``reconstruct_ptychography`` (the in-repo
``demos/cameraman_affine/data_nonoise.h5`` and a small simulated one).

Tolerances: forwards and gradients at 1e-5 of the largest value (1e-4
for gradients that sum over a whole hologram); GD losses at rtol 1e-5 and
each refined leaf's update at 5e-4 of its largest entry plus 4 f32 ulps
of the leaf (the bound of ``tests/test_torch_refinables.py``); the demos'
Adam runs at 1e-3 (Adam turns f32 noise into sign flips)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import adorym_tpu as jpkg
import adorym_tpu_torch as pt
from adorym_tpu.models import multidist as jmd
from adorym_tpu.ops.warp import affine_transform_2d as j_affine
from adorym_tpu.recon import Reconstructor as JaxReconstructor
from adorym_tpu.simulate import simulate as jsimulate
from adorym_tpu.utils.initialize import initialize_probe
from adorym_tpu_torch.models import multidist as tmd
from adorym_tpu_torch.ops.warp import affine_transform_2d as t_affine

from test_torch_refinables import (_check_leaves, _grads_jax, _grads_torch,
                                   _rel)

DISTS = (0.05, 0.12, 0.3, 0.7)        # cm, at 17.5 keV and 100 nm pixels


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _object(n, nz=1, seed=0):
    """A real_imag object near vacuum with a smooth phase."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    ph = gaussian_filter(rng.normal(size=(n, n, nz)), (3, 3, 0))
    ph = ph / np.abs(ph).max() * 0.5 / nz
    mag = 1.0 - 0.1 / nz * gaussian_filter(rng.random((n, n, nz)), (3, 3, 0))
    return np.stack([mag * np.cos(ph), mag * np.sin(ph)], -1).astype(
        np.float32)


def _cfg(mod, n=32, sub=None, szw=0, nz=1, refine=None, mb=1, lr=1e-2,
         dists=DISTS, randomize=False):
    sub = sub or n
    return mod.ReconConfig(
        geometry=mod.Geometry(obj_size=(n, n, nz), probe_size=(sub, sub),
                              energy_ev=17500.0, psize_cm=1e-5,
                              free_prop_cm=dists, n_dists=len(dists),
                              two_d_mode=nz == 1, safe_zone_width=szw),
        train=mod.TrainConfig(minibatch_size=mb, learning_rate=lr,
                              optimizer='gd', unknown_type='real_imag',
                              randomize_probe_pos=randomize, seed=0),
        refine=mod.RefineConfig(**(refine or {})))


# -- the model's pieces ------------------------------------------------------

@pytest.mark.parametrize('szw', [None, 0, 6])
def test_safe_zone_pad_and_indices(szw):
    pos = np.array([[0, 0], [0, 16], [16, 0], [16, 16]], float)
    cfgs = {m: _cfg(m, sub=16, szw=szw) for m in (jpkg, pt)}
    assert tmd._safe_zone_width(cfgs[pt]) == jmd._safe_zone_width(cfgs[jpkg])
    np.testing.assert_array_equal(
        tmd.compute_pad(cfgs[pt], (32, 32), pos),
        jmd.compute_pad(cfgs[jpkg], (32, 32), pos))
    assert tmd.gather_window(cfgs[pt]) == jmd.gather_window(cfgs[jpkg])
    inds = np.array([3, 1])
    np.testing.assert_array_equal(tmd.expand_indices(inds, 16, cfgs[pt]),
                                  jmd.expand_indices(inds, 16, cfgs[jpkg]))


#: (tile size, safe zone, slices, refinements, positions) of the forward
#: cases: one full-field block; four tiles with a safe zone; a 3-D object
#: of 3 slices, rotated; the refinements that act inside the forward.
PREDICT_CASES = {
    'full_field': (32, 0, 1, {}, [[0, 0]]),
    'tiles_safe_zone': (16, 6, 1, {}, [[0, 0], [0, 16], [16, 0], [16, 16]]),
    'three_d': (32, 0, 3, {}, [[0, 0]]),
    'refined_inside': (32, 0, 1, dict(optimize_free_prop=True,
                                      optimize_prj_pos_offset=True,
                                      optimize_probe_defocusing=True),
                       [[0, 0]]),
}


@pytest.mark.parametrize('case', list(PREDICT_CASES))
def test_predict_forward_and_gradients(case):
    sub, szw, nz, refine, pos = PREDICT_CASES[case]
    n = 32
    pos = np.asarray(pos, np.float32)
    cfgs = {m: _cfg(m, sub=sub, szw=szw, nz=nz, refine=refine)
            for m in (jpkg, pt)}
    obj = _object(n, nz)
    probe = initialize_probe((n, n), 'gaussian', energy_ev=17500.0,
                             psize_cm=1e-5, probe_mag_sigma=12,
                             probe_phase_sigma=12, probe_phase_max=0.3)
    aux = {'free_prop_cm': np.asarray(DISTS, np.float32) * 1.05,
           'prj_pos_offset': np.array([[0.6, -0.4]], np.float32),
           'probe_defocus_mm': np.array([2e-3], np.float32)}
    names = ['obj', 'probe'] + list(aux)
    rng = np.random.default_rng(1)
    g = rng.random((len(DISTS) * len(pos), sub, sub)).astype(np.float32)
    pad = jmd.compute_pad(cfgs[jpkg], (n, n), pos)
    theta = 0.4 if nz > 1 else 0.0

    def fn(mod, lib, gg, cfg):
        def f(*leaves):
            batch = {'i_theta': 0, 'theta': theta, 'pos_batch': pos,
                     'ind_batch': np.arange(len(pos))}
            out = mod.predict(dict(zip(names, leaves)), batch, cfg, pad)
            assert out.shape == gg.shape
            return lib.sum(out * gg)
        return f
    args = [obj, probe] + list(aux.values())
    jv, jg = _grads_jax(fn(jmd, jnp, jnp.asarray(g), cfgs[jpkg]), *args)
    tv, tg = _grads_torch(fn(tmd, torch, torch.tensor(g), cfgs[pt]), *args)
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    for name, a, b in zip(names, tg, jg):
        if np.any(b):
            assert _rel(a, b) < 1e-4, (name, _rel(a, b))
        else:
            assert not np.any(a), name


@pytest.mark.parametrize('refine', [
    dict(optimize_prj_affine=True),
    dict(optimize_all_probe_pos=True),
    dict(optimize_probe_pos_offset=True),
    dict(optimize_prj_affine=True, optimize_all_probe_pos=True,
         optimize_probe_pos_offset=True)])
def test_transform_measured(refine):
    """The registration of the measured holograms: each distance's affine,
    the angle's shift, each distance's shift; values and gradients."""
    cfgs = {m: _cfg(m, refine=refine) for m in (jpkg, pt)}
    rng = np.random.default_rng(2)
    meas = (1 + 0.2 * rng.random((8, 32, 32))).astype(np.float32)
    aff = np.tile(np.array([[[1.0, 0, 0], [0, 1.0, 0]]], np.float32),
                  (4, 1, 1)) + rng.normal(0, 0.01, (4, 2, 3)).astype(
                      np.float32)
    aux = {'prj_affine_ls': aff,
           'probe_pos_correction': rng.uniform(-1, 1, (4, 2)).astype(
               np.float32),
           'probe_pos_offset': np.array([[0.3, 0.7]], np.float32)}
    names = list(aux)
    g = rng.random(meas.shape).astype(np.float32)

    def fn(mod, lib, gg, cfg, m):
        def f(*leaves):
            out = mod.transform_measured(dict(zip(names, leaves)),
                                         {'i_theta': 0}, m, cfg)
            return lib.sum(out * gg)
        return f
    jv, jg = _grads_jax(fn(jmd, jnp, jnp.asarray(g), cfgs[jpkg],
                           jnp.asarray(meas)), *aux.values())
    tv, tg = _grads_torch(fn(tmd, torch, torch.tensor(g), cfgs[pt],
                             torch.tensor(meas)), *aux.values())
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    for name, a, b in zip(names, tg, jg):
        if np.any(b):
            assert _rel(a, b) < 1e-4, (name, _rel(a, b))
        else:
            assert not np.any(a), name


@pytest.mark.parametrize('mat', [
    [[1, 0, 0], [0, 1, 0]],
    [[1.01, 0.02, 0.05], [-0.03, 0.98, -0.1]],
    [[1.3, 0.2, 0.6], [-0.3, 0.9, -0.5]]])
def test_affine_transform_2d(mat):
    """The warp and its gradients against the JAX gather, with the
    coordinates clamped at the edges (the identity sits on the clamp's
    ties at the first and last pixel)."""
    rng = np.random.default_rng(3)
    img = rng.random((3, 20, 24)).astype(np.float32)
    g = rng.random((3, 20, 24)).astype(np.float32)
    mat = np.asarray(mat, np.float32)
    jv, jg = _grads_jax(lambda i, m: jnp.sum(j_affine(i, m) * g), img, mat)
    tv, tg = _grads_torch(
        lambda i, m: torch.sum(t_affine(i, m) * torch.tensor(g)), img, mat)
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    assert _rel(tg[0], jg[0]) < 1e-5
    assert _rel(tg[1], jg[1]) < 1e-5
    out = t_affine(torch.tensor(img), torch.tensor(mat)).numpy()
    np.testing.assert_allclose(out, np.asarray(j_affine(img, mat)),
                               atol=1e-5)


@pytest.mark.parametrize('tiles', [False, True])
def test_simulate_holograms(tiles):
    """Holograms of every distance, ``[n_theta, n_dists * n_blocks, sy,
    sx]``: one full-field block, or four tiles with a safe zone in one
    batch."""
    obj = _object(32, seed=4)
    probe = initialize_probe((32, 32), 'plane')
    if tiles:
        pos = np.array([[0, 0], [0, 16], [16, 0], [16, 16]], float)
        cfgs = {m: _cfg(m, sub=16, szw=8, mb=4) for m in (jpkg, pt)}
    else:
        pos = np.array([[0.0, 0.0]])
        cfgs = {m: _cfg(m) for m in (jpkg, pt)}
    jd = jsimulate(cfgs[jpkg], obj, probe, pos, model=jmd)
    td = pt.simulate(cfgs[pt], obj, probe, pos, model=tmd, device='cpu')
    assert td.shape == jd.shape == (1, 4 * len(pos)) + cfgs[pt].geometry.probe_size
    assert _rel(td, jd) < 1e-5
    with pytest.raises(ValueError, match='multidist'):
        pt.simulate(cfgs[pt], obj, probe, pos, device='cpu')


# -- trajectories --------------------------------------------------------

def _holo_data(n=32, nz=1):
    obj = _object(n, nz, seed=5)
    probe = initialize_probe((n, n), 'plane')
    data = jsimulate(_cfg(jpkg, n=n, nz=nz), obj, probe,
                     np.array([[0.0, 0.0]]), model=jmd,
                     theta_ls=np.array([0.0, 0.7]) if nz > 1 else None)
    return obj, probe, data


#: Step sizes that move each leaf by thousands of f32 ulps in 3 epochs.
MULTIDIST_REFINE = {
    'free_prop': dict(optimize_free_prop=True, free_prop_learning_rate=1e-3,
                      free_prop_optimizer='gd'),
    'affine': dict(optimize_prj_affine=True, prj_affine_learning_rate=1e-1,
                   prj_affine_optimizer='gd'),
    'shifts': dict(optimize_all_probe_pos=True,
                   all_probe_pos_learning_rate=1e3,
                   all_probe_pos_optimizer='gd'),
    'all_three_3d': dict(optimize_free_prop=True,
                         free_prop_learning_rate=1e-3,
                         free_prop_optimizer='gd', optimize_prj_affine=True,
                         prj_affine_learning_rate=1e-1,
                         prj_affine_optimizer='gd',
                         optimize_all_probe_pos=True,
                         all_probe_pos_learning_rate=1e3,
                         all_probe_pos_optimizer='gd'),
}


@pytest.mark.parametrize('case', list(MULTIDIST_REFINE))
def test_multidist_trajectory(case):
    """3 GD epochs (one block, the generic step) from distances 6% long,
    refining the distances, the affines or the per-distance shifts (all
    three on a 3-D object of 2 slices at 2 angles): losses and leaves.
    The start is 90% of the true object and 10% vacuum: at a vacuum start
    the predicted holograms are flat, and the distances' and the shifts'
    gradients vanish."""
    nz = 2 if case.endswith('3d') else 1
    obj, probe, data = _holo_data(nz=nz)
    refine = MULTIDIST_REFINE[case]
    vac = np.stack([np.ones(obj.shape[:3]), np.zeros(obj.shape[:3])], -1)
    obj0 = (0.9 * obj + 0.1 * vac).astype(np.float32)
    theta = np.array([0.0, 0.7]) if nz > 1 else None
    aux = {'free_prop_cm': np.asarray(DISTS) * 1.06}
    out = {}
    for m, R, md, kw in ((jpkg, JaxReconstructor, jmd, {}),
                         (pt, pt.Reconstructor, tmd, {'device': 'cpu'})):
        rec = R(_cfg(m, nz=nz, refine=refine), data=data,
                probe_pos=np.array([[0.0, 0.0]]), theta_ls=theta,
                probe_init=probe, obj_init=obj0, model=md, aux_init=aux,
                **kw)
        if m is pt:
            rec.start = {k: v.clone() for k, v in rec.params.items()}
            assert not rec._band and rec.expand_indices is not None
        out[m] = (rec, [rec.run_epoch(e) for e in range(3)])
    (jr, jl), (tr, tl) = out[jpkg], out[pt]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _check_leaves(jr, tr, ['obj'] + [k for k in tr.specs if k != 'obj'])
    if 'prj_affine_ls' in tr.params:
        np.testing.assert_array_equal(tr.params['prj_affine_ls'][0].numpy(),
                                      [[1, 0, 0], [0, 1, 0]])


def test_multidist_per_angle_and_ctf_raise():
    """The per-angle scheme of the multi-distance model takes the
    accumulate-then-update loop and the CTF forward algorithm constructs,
    as in the JAX package; a config that asks for a device mesh without
    one (no process group) raises."""
    obj, probe, data = _holo_data()
    for train in (dict(update_scheme='per angle', rotate_out_of_loop=True),
                  dict(forward_algorithm='ctf')):
        cfg = _cfg(pt)
        cfg = cfg.replace(train=pt.TrainConfig(
            minibatch_size=1, unknown_type='real_imag', **train))
        rec = pt.Reconstructor(cfg, data=data,
                               probe_pos=np.array([[0., 0.]]), model=tmd,
                               device='cpu')
        assert rec._accum == ('update_scheme' in train)
    with pytest.raises(ValueError, match='device meshes'):
        pt.Reconstructor(cfg.replace(parallel=pt.ParallelConfig(data_axis=2)),
                         data=data, probe_pos=np.array([[0., 0.]]),
                         model=tmd, device='cpu')


# -- the demos' configurations through the entry point ---------------------

REPO_DEMOS = __import__('pathlib').Path(__file__).resolve().parents[1] / 'demos'


def _api_both(**params):
    out = {}
    for name, fn, extra in (('jax', jpkg.reconstruct_ptychography, {}),
                            ('port', pt.reconstruct_ptychography,
                             {'device': 'cpu'})):
        out[name] = fn(**params, **extra)
    return out['jax'], out['port']


def test_api_baseline4_cameraman_affine(tmp_path):
    """BASELINE #4 (``demos/2d_multidist_holography_w_affine.py``) on the
    in-repo 128^2 holograms at four distances, 3 epochs of its Adam with
    the distances and the affines refined from distances 6% long: losses
    at 1e-3, the refined distances and the object at 1e-3 of their
    largest entries."""
    dists_wrong = tuple(d * 1.06 for d in DISTS)
    jres, tres = _api_both(
        fname='data_nonoise.h5', save_path=str(REPO_DEMOS / 'cameraman_affine'),
        output_folder=str(tmp_path / 'o'), obj_size=(128, 128, 1),
        two_d_mode=True, free_prop_cm=dists_wrong, safe_zone_width=0,
        n_epochs=3, minibatch_size=1,
        random_guess_means_sigmas=(1., 0., 0., 0.01), probe_type='plane',
        optimize_probe=False, optimizer='adam', learning_rate=1e-2,
        optimize_free_prop=True, free_prop_learning_rate=1e-3,
        optimize_prj_affine=True, prj_affine_learning_rate=1e-3,
        randomize_probe_pos=True, update_scheme='immediate',
        unknown_type='real_imag', raw_data_type='intensity',
        loss_function_type='lsq', use_checkpoint=False,
        save_intermediate=False)
    np.testing.assert_allclose(tres['loss_history'], jres['loss_history'],
                               rtol=1e-3)
    for k in ('free_prop_cm', 'prj_affine_ls', 'obj'):
        assert tres[k].shape == np.asarray(jres[k]).shape
        assert _rel(tres[k], jres[k]) < 1e-3, k
    assert np.all(tres['free_prop_cm'] != np.asarray(dists_wrong,
                                                     np.float32))


def test_api_multidist_position_correction(tmp_path):
    """``demos/2d_multidist_holography_w_position_correction.py`` at 32^2:
    holograms simulated with per-distance shifts, the shifts refined from
    zero (``probe_pos_correction`` ``[n_dists, 2]``), 3 epochs of Adam."""
    from adorym_tpu.io.data import write_data_file
    from adorym_tpu.ops.fourier import fourier_shift
    obj, probe, data = _holo_data()
    shifts = np.array([[0, 0], [0.8, -0.5], [-0.6, 0.4], [0.3, 0.9]])
    data = np.abs(np.asarray(fourier_shift(
        data[0].astype(np.complex64), jnp.asarray(shifts, jnp.float32))))
    write_data_file(str(tmp_path / 'holo.h5'), data[None] ** 2,
                    probe_pos=np.array([[0.0, 0.0]]), energy_ev=17500.0,
                    psize_cm=1e-5, free_prop_cm=DISTS)
    jres, tres = _api_both(
        fname='holo.h5', save_path=str(tmp_path), output_folder=None,
        obj_size=(32, 32, 1), two_d_mode=True, safe_zone_width=0,
        n_epochs=3, minibatch_size=1,
        random_guess_means_sigmas=(1., 0., 0., 0.01), probe_type='plane',
        optimizer='adam', learning_rate=1e-2, optimize_all_probe_pos=True,
        all_probe_pos_learning_rate=1e-1, randomize_probe_pos=True,
        update_scheme='immediate', unknown_type='real_imag',
        raw_data_type='intensity', loss_function_type='lsq',
        use_checkpoint=False, save_intermediate=False)
    np.testing.assert_allclose(tres['loss_history'], jres['loss_history'],
                               rtol=1e-3)
    assert tres['probe_pos_correction'].shape == (4, 2)
    assert np.max(np.abs(tres['probe_pos_correction']
                         - np.asarray(jres['probe_pos_correction']))) < 1e-2
