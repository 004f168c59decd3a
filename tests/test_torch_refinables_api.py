"""The ptychography demos that refine positions, through both packages'
``reconstruct_ptychography`` on the CPU: BASELINE #2 on the in-repo
Siemens-star file (``demos/2d_ptychography_experimental_data.py``),
BASELINE #3 (``demos/2d_ptychography_position_correction.py``) and
``demos/2d_ptychography_w_probe_optimization.py`` at a small size on data
the JAX package simulates; and ``distribution_mode`` on one device.

The demos run Adam: their losses are held at rtol 1e-3, as
``tests/test_torch_api.py`` holds Adam runs (Adam turns f32 noise into
sign flips; BASELINE #3's at 1e-2, its docstring says why); the refined
positions, which move by Adam steps of 0.01 px, at two steps."""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import adorym_tpu as jpkg
import adorym_tpu_torch as pt
from adorym_tpu.simulate import simulate_to_file
from adorym_tpu.utils.initialize import initialize_probe

DEMOS = Path(__file__).resolve().parents[1] / 'demos'


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(**params):
    out = {}
    for name, fn, extra in (('jax', jpkg.reconstruct_ptychography, {}),
                            ('port', pt.reconstruct_ptychography,
                             {'device': 'cpu'})):
        out[name] = fn(**params, **extra)
    return out['jax'], out['port']


def _hold(jres, tres, step, rtol=1e-3):
    np.testing.assert_allclose(tres['loss_history'], jres['loss_history'],
                               rtol=rtol)
    assert set(tres) == set(jres)
    ppc = tres['probe_pos_correction']
    assert ppc.shape == np.asarray(jres['probe_pos_correction']).shape
    assert np.any(ppc != 0)
    assert np.max(np.abs(ppc - np.asarray(jres['probe_pos_correction']))) \
        <= 2 * step


def _write(tmp, name, cfg, obj, probe, pos_true, pos_nominal, square=False):
    """Simulate with the JAX package at ``pos_true``, record
    ``pos_nominal`` (and intensities when ``square``), as the demos do."""
    import h5py
    path = str(tmp / name)
    simulate_to_file(path, cfg, obj, probe, pos_true)
    with h5py.File(path, 'r+') as f:
        if square:
            f['exchange/data'][...] = f['exchange/data'][...] ** 2
        del f['metadata/probe_pos_px']
        f.create_dataset('metadata/probe_pos_px', data=pos_nominal)
    return path


def test_baseline2_siemens_star(tmp_path):
    """BASELINE #2 on ``demos/siemens_star_aps_2idd/data.h5`` (256^2, 256
    spots of 72^2 intensities, 5 probe modes from a defocused aperture,
    rescaled): the demo's params, 2 epochs."""
    jres, tres = _both(
        fname='data.h5', save_path=str(DEMOS / 'siemens_star_aps_2idd'),
        output_folder=str(tmp_path / 'o'), obj_size=(256, 256, 1),
        two_d_mode=True, energy_ev=8801.121930115722,
        psize_cm=1.32789376566526e-06, free_prop_cm='inf', n_epochs=2,
        minibatch_size=35, random_guess_means_sigmas=(1., 0., 0.001, 0.002),
        probe_type='aperture_defocus', n_probe_modes=5, aperture_radius=10,
        beamstop_radius=5, probe_defocus_cm=0.0069,
        rescale_probe_intensity=True, raw_data_type='intensity',
        optimizer='adam', learning_rate=1e-3, optimize_probe=True,
        probe_learning_rate=1e-3, optimize_all_probe_pos=True,
        all_probe_pos_learning_rate=1e-2, update_scheme='immediate',
        unknown_type='real_imag', loss_function_type='lsq',
        use_checkpoint=False, save_intermediate=False)
    _hold(jres, tres, 1e-2)
    assert tres['probe'].shape == (5, 72, 72, 2)
    assert np.max(np.abs(tres['obj'] - np.asarray(jres['obj']))) < 2e-3


@pytest.mark.parametrize('opt', ['adam', 'gd'])
def test_baseline3_position_correction(tmp_path, opt):
    """BASELINE #3 at 48^2 with 24^2 probes at stride 6 and +-2 px
    position errors: the demo's params (Adam lr 2e-4, minibatch 16,
    positions at 1e-2), 3 epochs; and its GD twin.  The Adam run's losses
    part by 1.2e-3 at the second epoch (measured; each Adam step moves
    every object entry by the step size, and entries whose gradient is f32
    noise flip sign), so they are held at 1e-2; the GD twin (positions at
    a step of 30, so that they move) stays within 3e-6 and is held at
    1e-5, its positions at 5e-4 of their largest entry (the bound of
    ``tests/test_torch_refinables.py``)."""
    from scipy.ndimage import gaussian_filter
    n, pn = 48, 24
    rng = np.random.default_rng(0)
    xs = np.arange(0, n - pn + 1, 6)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    nominal = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    true = nominal + rng.uniform(-2, 2, nominal.shape)
    img = gaussian_filter(rng.random((n, n, 1)), (5, 5, 0))
    img = (img - img.min()) / np.ptp(img)
    obj = np.stack([img * 3e-3, img * 8e-5], -1).astype(np.float32)
    kw = dict(energy_ev=5000.0, psize_cm=1e-7, probe_mag_sigma=5,
              probe_phase_sigma=5, probe_phase_max=0.4)
    cfg = jpkg.ReconConfig(
        geometry=jpkg.Geometry(obj_size=(n, n, 1), probe_size=(pn, pn),
                               energy_ev=5000.0, psize_cm=1e-7,
                               free_prop_cm='inf', two_d_mode=True),
        train=jpkg.TrainConfig(minibatch_size=len(true)))
    _write(tmp_path, 'cam.h5', cfg, obj,
           initialize_probe((pn, pn), 'gaussian', **kw), true, nominal)
    jres, tres = _both(
        fname='cam.h5', save_path=str(tmp_path), output_folder=None,
        obj_size=(n, n, 1), two_d_mode=True, n_epochs=3,
        learning_rate=2e-4, minibatch_size=16, free_prop_cm='inf',
        probe_type='gaussian', probe_mag_sigma=5, probe_phase_sigma=5,
        probe_phase_max=0.4, optimize_all_probe_pos=True,
        all_probe_pos_learning_rate=1e-2 if opt == 'adam' else 30.0,
        use_checkpoint=False, optimizer=opt, optimizer_all_probe_pos=opt)
    if opt == 'adam':
        _hold(jres, tres, 1e-2, rtol=1e-2)
    else:
        ppc = np.asarray(jres['probe_pos_correction'])
        _hold(jres, tres, 2.5e-4 * np.max(np.abs(ppc)), rtol=1e-5)


def test_probe_optimization_demo(tmp_path):
    """``demos/2d_ptychography_w_probe_optimization.py`` at 48^2: a
    phase-only real_imag object, the probe from the data's inverse FFT and
    refined, positions refined, 3 epochs of the demo's Adam."""
    from scipy.ndimage import gaussian_filter
    n, pn = 48, 24
    rng = np.random.default_rng(7)
    base = rng.normal(size=(n, n, 1))
    ph = gaussian_filter(base, (3, 3, 0)) - gaussian_filter(base, (9, 9, 0))
    ph = ph / np.abs(ph).max() * 0.5
    obj = np.stack([np.cos(ph), np.sin(ph)], -1).astype(np.float32)
    probe = initialize_probe((pn, pn), 'aperture_defocus', energy_ev=5000.0,
                             psize_cm=1e-7, aperture_radius=5,
                             probe_defocus_cm=0.004, seed=1)
    xs = np.arange(-4, n - pn + 5, 4)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    cfg = jpkg.ReconConfig(
        geometry=jpkg.Geometry(obj_size=(n, n, 1), probe_size=(pn, pn),
                               energy_ev=5000.0, psize_cm=1e-7,
                               free_prop_cm='inf', two_d_mode=True),
        train=jpkg.TrainConfig(minibatch_size=64, unknown_type='real_imag'))
    _write(tmp_path, 'probe.h5', cfg, obj, probe, pos, pos)
    jres, tres = _both(
        fname='probe.h5', save_path=str(tmp_path), output_folder=None,
        obj_size=(n, n, 1), two_d_mode=True, energy_ev=5000.0,
        psize_cm=1e-7, free_prop_cm='inf', n_epochs=3, minibatch_size=16,
        probe_type='ifft', optimize_probe=True, probe_learning_rate=4e-3,
        optimize_all_probe_pos=True, all_probe_pos_learning_rate=1e-2,
        object_type='phase_only', optimizer='adam', learning_rate=4e-3,
        update_scheme='immediate', unknown_type='real_imag',
        loss_function_type='lsq', use_checkpoint=False,
        save_intermediate=False)
    _hold(jres, tres, 1e-2)
    mag = np.hypot(tres['obj'][..., 0], tres['obj'][..., 1])
    np.testing.assert_allclose(mag, 1.0, atol=1e-5)


def _small_file(tmp_path):
    from scipy.ndimage import gaussian_filter
    n, pn = 32, 16
    rng = np.random.default_rng(3)
    sm = gaussian_filter(rng.random((n, n, 1)), (3, 3, 0))
    obj = np.stack([sm * 2e-3, sm * 5e-5], -1).astype(np.float32)
    xs = np.arange(0, n - pn + 1, 4)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    cfg = jpkg.ReconConfig(
        geometry=jpkg.Geometry(obj_size=(n, n, 1), probe_size=(pn, pn),
                               energy_ev=5000.0, psize_cm=1e-7,
                               free_prop_cm='inf', two_d_mode=True),
        train=jpkg.TrainConfig(minibatch_size=5))
    probe = initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                             psize_cm=1e-7, probe_mag_sigma=4,
                             probe_phase_sigma=4, probe_phase_max=0.4)
    _write(tmp_path, 'small.h5', cfg, obj, probe, pos, pos)
    return dict(fname='small.h5', save_path=str(tmp_path),
                output_folder=None, obj_size=(n, n, 1), two_d_mode=True,
                n_epochs=2, minibatch_size=5, optimizer='gd',
                learning_rate=1e-3, probe_type='gaussian',
                probe_mag_sigma=4, probe_phase_sigma=4, probe_phase_max=0.4,
                free_prop_cm='inf', gamma=0, use_checkpoint=False,
                device='cpu')


@pytest.mark.parametrize('mode,match', [
    ('distributed_object', 'running unsharded'),
    ('an_unknown_mode', 'ignored')])
def test_distribution_mode_on_one_device(tmp_path, mode, match):
    """``distribution_mode='distributed_object'`` without object sharding
    warns and runs unsharded, and an unknown mode warns and is ignored, as
    in the JAX package: the same losses as the run without the mode."""
    params = _small_file(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        plain = pt.reconstruct_ptychography(**params)
    with pytest.warns(UserWarning, match=match):
        got = pt.reconstruct_ptychography(distribution_mode=mode, **params)
    np.testing.assert_array_equal(got['loss_history'], plain['loss_history'])
    with pytest.warns(UserWarning, match=match):
        jres = jpkg.reconstruct_ptychography(
            distribution_mode=mode,
            **{k: v for k, v in params.items() if k != 'device'})
    np.testing.assert_allclose(got['loss_history'], jres['loss_history'],
                               rtol=1e-5)


@pytest.mark.parametrize('over', [dict(distribution_mode='shared_file',
                                       parallel_data_axis=2),
                                  dict(parallel_object_axis=2)])
def test_shared_file_and_meshes_raise(tmp_path, over):
    """A mesh outside a process group raises (no silent one-device run),
    with ``distribution_mode='shared_file'`` too (which runs on one device
    since the out-of-core slice); meshes themselves run on gloo ranks in
    ``tests/test_torch_mesh_*.py``."""
    params = _small_file(tmp_path)
    with pytest.raises(RuntimeError, match='process group'):
        pt.reconstruct_ptychography(**params, **over)
