"""The port's I/O, initialization, simulation, metrics and checkpoints
against the JAX package: files written by either package read by the
other (TIFF, the HDF5 measurement layout, the npz checkpoint), the
in-repo demo files, initialization bit for bit, ``simulate`` and the
metrics, a JAX checkpoint continued in the port, and ``run()`` stopped
mid-epoch and resumed, exactly as the uninterrupted run on the CPU.
Every file goes under ``tmp_path``."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import adorym_tpu.config as jcfg
import adorym_tpu.metrics as jmetrics
import adorym_tpu.recon as jrecon
from adorym_tpu.simulate import simulate as j_simulate
from adorym_tpu.simulate import simulate_to_file as j_simulate_to_file
from adorym_tpu.io import checkpoint as jckpt
from adorym_tpu.io import data as jdata
from adorym_tpu.io import output as jout
from adorym_tpu.utils import initialize as jinit
import adorym_tpu_torch as pt
from adorym_tpu_torch import convert
from adorym_tpu_torch import metrics as tmetrics
from adorym_tpu_torch.simulate import simulate as t_simulate
from adorym_tpu_torch.simulate import simulate_to_file as t_simulate_to_file
from adorym_tpu_torch.io import checkpoint as tckpt
from adorym_tpu_torch.io import data as tdata
from adorym_tpu_torch.io import output as tout
from adorym_tpu_torch.utils import initialize as tinit

from test_torch_immediate import _setup as _setup_imm
from test_torch_regularizers import REG_RW, _support

REPO = Path(__file__).resolve().parents[1]


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
ADHESIN = REPO / 'demos' / 'adhesin'
RNG = np.random.default_rng(30)


# -- TIFF ------------------------------------------------------------------

@pytest.mark.parametrize('shape', [(7, 9), (3, 7, 9)])
@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_tiff_round_trip_across_packages(tmp_path, shape, writer):
    arr = RNG.normal(size=shape).astype(np.float32)
    write, read = ((jout.write_tiff, tout.read_tiff) if writer == 'jax'
                   else (tout.write_tiff, jout.read_tiff))
    path = write(arr, tmp_path / 'a')
    assert path.endswith('.tiff')
    np.testing.assert_array_equal(read(path), arr)


def test_tiff_reads_the_in_repo_outputs():
    for name in ('delta_ds_1.tiff', 'probe_mag_ds_1.tiff'):
        path = ADHESIN / 'recon_tomo64' / name
        np.testing.assert_array_equal(tout.read_tiff(path),
                                      jout.read_tiff(path))


@pytest.mark.parametrize('unknown_type', ['delta_beta', 'real_imag'])
def test_output_object_and_probe_match_jax(tmp_path, unknown_type):
    """The same file names and contents; per-angle probes flatten."""
    obj = RNG.normal(size=(5, 6, 4, 2)).astype(np.float32)
    probe = RNG.normal(size=(2, 3, 8, 8, 2)).astype(np.float32)
    for mod, d in ((jout, tmp_path / 'j'), (tout, tmp_path / 't')):
        mod.output_object(obj, str(d), unknown_type, name_suffix='_1')
        mod.output_probe(probe, str(d / 'inter'), ds_level=2)
    names = sorted(p.relative_to(tmp_path / 'j')
                   for p in (tmp_path / 'j').rglob('*.tiff'))
    assert names == sorted(p.relative_to(tmp_path / 't')
                           for p in (tmp_path / 't').rglob('*.tiff'))
    assert len(names) == 4
    for n in names:
        np.testing.assert_array_equal(tout.read_tiff(tmp_path / 't' / n),
                                      jout.read_tiff(tmp_path / 'j' / n))


def test_loss_logger_summary_and_parse_match_jax(tmp_path):
    cfg_j = jcfg.ReconConfig(geometry=jcfg.Geometry(obj_size=(4, 4, 4),
                                                    probe_size=(2, 2)))
    cfg_t = pt.ReconConfig(geometry=pt.Geometry(obj_size=(4, 4, 4),
                                                probe_size=(2, 2)))
    for mod, cfg, d in ((jout, cfg_j, tmp_path / 'j'),
                        (tout, cfg_t, tmp_path / 't')):
        mod.write_summary(cfg, str(d), extra={'note': 1})
        log = mod.LossLogger(str(d))
        for b, loss in enumerate((3.0, 2.0, 1.5)):
            log.log(0, b, loss)
        log.close()
        log = mod.LossLogger(str(d), append=True)
        log.log(1, 0, 1.25)
        log.close()
    assert ((tmp_path / 't' / 'summary.txt').read_text()
            == (tmp_path / 'j' / 'summary.txt').read_text())
    np.testing.assert_array_equal(tout.parse_loss_data(str(tmp_path / 't')),
                                  jout.parse_loss_data(str(tmp_path / 'j')))
    np.testing.assert_array_equal(tout.parse_loss_data(str(tmp_path / 't')),
                                  [3.0, 2.0, 1.5, 1.25])


def test_parse_source_folder_matches_jax(tmp_path):
    for it in range(3):
        for idist in range(2):
            tout.write_tiff(np.full((4, 5), it + idist, np.float32),
                            tmp_path / f'img_{it}_{idist}.tiff')
    got = tdata.parse_source_folder(str(tmp_path), 'img')
    assert got == jdata.parse_source_folder(str(tmp_path), 'img')
    assert got[1:] == (3, 2, (4, 5))


# -- HDF5 measurement files ------------------------------------------------

def _dataset_args():
    data = (RNG.normal(size=(3, 4, 6, 6))
            + 1j * RNG.normal(size=(3, 4, 6, 6))).astype(np.complex64)
    return data, dict(theta=np.linspace(0, 1, 3),
                      probe_pos=RNG.normal(size=(4, 2)), energy_ev=800.0,
                      psize_cm=6.7e-8, free_prop_cm=1e-5,
                      probe_pos_per_angle=[RNG.normal(size=(4 - i, 2))
                                           for i in range(3)])


def _same_dataset(a, b):
    np.testing.assert_array_equal(a.all_magnitudes(), b.all_magnitudes())
    inds = [a.n_pos - 1, 0]
    np.testing.assert_array_equal(a.magnitudes(1, inds, ds_level=2),
                                  b.magnitudes(1, inds, ds_level=2))
    for m in ('theta_ls', 'probe_pos', 'energy_ev', 'psize_cm',
              'free_prop_cm'):
        np.testing.assert_array_equal(getattr(a, m)(), getattr(b, m)())
    for i in range(a.n_theta):
        np.testing.assert_array_equal(a.probe_pos_per_angle(i),
                                      b.probe_pos_per_angle(i))
    assert (a.shape, a.n_theta, a.n_pos, a.det_shape) == (
        b.shape, b.n_theta, b.n_pos, b.det_shape)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_data_file_round_trip_across_packages(tmp_path, writer):
    data, meta = _dataset_args()
    path = str(tmp_path / 'sub' / 'data.h5')
    (jdata if writer == 'jax' else tdata).write_data_file(path, data, **meta)
    a, b = tdata.RawDataset(path), jdata.RawDataset(path)
    lazy = tdata.RawDataset(path, preload=False)
    _same_dataset(a, b)
    _same_dataset(lazy, b)
    # The in-memory stand-in, from the same contents.
    mem = tdata.ArrayDataset(
        data, theta=meta['theta'], probe_pos_px=meta['probe_pos'],
        energy_ev=meta['energy_ev'], psize_cm=meta['psize_cm'],
        free_prop_cm=meta['free_prop_cm'],
        **{f'probe_pos_px_{i}': p
           for i, p in enumerate(meta['probe_pos_per_angle'])})
    _same_dataset(mem, b)
    for d in (a, b, lazy):
        d.close()


def test_in_repo_adhesin_file_reads_as_in_jax():
    path = str(ADHESIN / 'data_adhesin_64_theta_36.h5')
    a, b = tdata.RawDataset(path), jdata.RawDataset(path)
    _same_dataset(a, b)
    assert a.shape == (36, 1, 64, 64)
    assert a.free_prop_cm() is None and a.energy_ev() == 800.0


def test_missing_h5py_raises_naming_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, 'h5py', None)
    with pytest.raises(ImportError, match='h5py'):
        tdata.RawDataset(str(tmp_path / 'x.h5'))
    with pytest.raises(ImportError, match='h5py'):
        tdata.write_data_file(str(tmp_path / 'x.h5'), np.zeros((1, 1, 2, 2)))


def test_import_needs_neither_h5py_nor_pillow():
    code = ('import sys; sys.modules["h5py"] = None; sys.modules["PIL"] = '
            'None; import adorym_tpu_torch, adorym_tpu_torch.io.data, '
            'adorym_tpu_torch.io.output, adorym_tpu_torch.simulate; '
            'print("ok")')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and 'ok' in res.stdout, res.stderr


# -- initialization --------------------------------------------------------

OBJ_INIT_CASES = {
    'random': dict(),
    'real_imag_phase_only': dict(unknown_type='real_imag',
                                 object_type='phase_only'),
    'absorption_only_nonneg': dict(object_type='absorption_only',
                                   non_negativity=True),
    'initial_guess': dict(initial_guess=(np.full((4, 5, 3), 1e-6),
                                         np.full((4, 5, 3), 2e-8))),
    'previous_pass': dict(previous_pass=(np.arange(24.0).reshape(2, 3, 4),
                                         np.ones((2, 3, 4)))),
}


@pytest.mark.parametrize('case', list(OBJ_INIT_CASES))
def test_initialize_object_bit_equal(case):
    kw = OBJ_INIT_CASES[case]
    np.testing.assert_array_equal(
        tinit.initialize_object((4, 5, 3), seed=3, **kw),
        jinit.initialize_object((4, 5, 3), seed=3, **kw))


PROBE_CASES = {
    'gaussian': ('gaussian', dict(probe_mag_sigma=3.0, probe_phase_sigma=2.0,
                                  probe_phase_max=0.5)),
    'plane': ('plane', dict()),
    'aperture_defocus': ('aperture_defocus', dict(
        aperture_radius=4, beamstop_radius=1, probe_defocus_cm=1e-4)),
    'ifft': ('ifft', dict(data_for_ifft=RNG.random((5, 16, 16)))),
    'ifft_intensity': ('ifft', dict(data_for_ifft=RNG.random((5, 16, 16)),
                                    raw_data_type='intensity',
                                    sign_convention=-1)),
    'supplied': ('supplied', dict(probe_initial=(RNG.random((16, 16)),
                                                 RNG.random((16, 16))))),
    'fixed_pupil_defocus': ('fixed', dict(
        probe_initial=(np.ones((16, 16)), np.zeros((16, 16))),
        pupil_function=RNG.random((16, 16)), extra_defocus_cm=2e-4)),
    'plane_rescaled': ('plane', dict(
        data_for_rescale=RNG.random((1, 4, 16, 16)), rescale_intensity=True)),
    'plane_rescaled_normalized': ('plane', dict(
        data_for_rescale=RNG.random((1, 4, 16, 16)), rescale_intensity=True,
        normalize_fft=True, raw_data_type='intensity')),
}


@pytest.mark.parametrize('modes', [1, 3])
@pytest.mark.parametrize('case', list(PROBE_CASES))
def test_initialize_probe_bit_equal(case, modes):
    ptype, kw = PROBE_CASES[case]
    kw = dict(kw, energy_ev=5000.0, psize_cm=1e-7, n_probe_modes=modes,
              seed=1)
    np.testing.assert_array_equal(
        tinit.initialize_probe((16, 16), ptype, **kw),
        jinit.initialize_probe((16, 16), ptype, **kw))


def test_initialize_probe_rejects_unknown_type():
    with pytest.raises(ValueError, match='probe_type'):
        tinit.initialize_probe((4, 4), 'nonsense')


# -- simulate and metrics --------------------------------------------------

@pytest.mark.parametrize('return_wave', [False, True])
@pytest.mark.parametrize('two_d', [False, True])
def test_simulate_matches_jax(return_wave, two_d):
    """Magnitudes (or mode 0's exit waves) at rtol 1e-5 of the largest
    value, two angles, batches of 3 spots; the object as in the
    trajectory tests."""
    kw, obj0, probe, pos, theta, _ = _setup_imm()
    if two_d:
        kw = dict(kw, obj_size=(24, 24, 1), two_d_mode=True)
        obj0 = obj0[:, :, :1] * 20
    for mod in (jcfg, pt):
        cfg = mod.ReconConfig(geometry=mod.Geometry(**kw))
        if mod is jcfg:
            want = np.asarray(j_simulate(cfg, obj0, probe, pos, theta[:2],
                                            return_wave=return_wave,
                                            minibatch_size=3))
        else:
            got = t_simulate(cfg, obj0, probe, pos, theta[:2],
                                return_wave=return_wave, minibatch_size=3,
                                device='cpu')
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_simulate_to_file_matches_jax(tmp_path):
    """Both writers' files hold the same data (to 1e-5) and metadata; the
    port's angle-by-angle form with its resume file too."""
    kw, obj0, probe, pos, theta, _ = _setup_imm()
    cfgs = {m: m.ReconConfig(geometry=m.Geometry(**kw)) for m in (jcfg, pt)}
    j_simulate_to_file(str(tmp_path / 'j.h5'), cfgs[jcfg], obj0, probe,
                          pos, theta)
    t_simulate_to_file(str(tmp_path / 't.h5'), cfgs[pt], obj0, probe,
                          pos, theta, device='cpu')
    t_simulate_to_file(str(tmp_path / 'c.h5'), cfgs[pt], obj0, probe,
                          pos, theta, use_checkpoint=True, device='cpu')
    assert not (tmp_path / 'c.h5.sim_checkpoint_i_theta.txt').exists()
    want = jdata.RawDataset(str(tmp_path / 'j.h5'))
    for name in ('t.h5', 'c.h5'):
        got = tdata.RawDataset(str(tmp_path / name))
        a, b = got.all_magnitudes(), want.all_magnitudes()
        assert np.max(np.abs(a - b)) <= 1e-5 * np.max(b)
        np.testing.assert_array_equal(got.theta_ls(), want.theta_ls())
        np.testing.assert_array_equal(got.probe_pos(), want.probe_pos())
        assert got.energy_ev() == want.energy_ev()
        assert got.free_prop_cm() is None


def test_simulate_reproduces_the_adhesin_file():
    """The in-repo adhesin data was simulated by the JAX package from the
    demo's phantom; the port's simulate gives it again (to 1e-5), so the
    card can rebuild it without h5py."""
    sys.path.insert(0, str(REPO / 'demos'))
    try:
        from multislice_tomography_64 import make_phantom
    finally:
        sys.path.pop(0)
    ds = tdata.RawDataset(str(ADHESIN / 'data_adhesin_64_theta_36.h5'))
    theta = ds.theta_ls()[:6]
    cfg = pt.ReconConfig(geometry=pt.Geometry(
        obj_size=(64, 64, 64), probe_size=(64, 64), energy_ev=800.0,
        psize_cm=0.67e-7, free_prop_cm=None))
    got = t_simulate(cfg, make_phantom(),
                        tinit.initialize_probe((64, 64), 'plane'),
                        np.array([[0.0, 0.0]]), theta, device='cpu')
    want = ds.all_magnitudes()[:6]
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(want)


def test_metrics_match_jax():
    from scipy.ndimage import gaussian_filter
    vol = gaussian_filter(RNG.normal(size=(20, 20, 20)), 2)
    noisy = vol + RNG.normal(size=vol.shape) * vol.std()
    for a, b in ((vol, vol), (vol, noisy), (vol[0], noisy[0])):
        got = tmetrics.fourier_shell_correlation(a, b, step_size=2)
        want = jmetrics.fourier_shell_correlation(a, b, step_size=2)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12)
        assert (tmetrics.fsc_crossing(*got, 0.5)
                == jmetrics.fsc_crossing(*want, 0.5))
    img = gaussian_filter(RNG.normal(size=(32, 32)), 2)
    shifted = np.roll(img, (3, -2), axis=(0, 1))
    for up in (1, 20):
        np.testing.assert_allclose(
            tmetrics.register_translation(shifted, img, up),
            jmetrics.register_translation(shifted, img, up), rtol=1e-12)


# -- checkpoints -------------------------------------------------------------

def _tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_checkpoint_round_trip_across_packages(tmp_path, writer):
    params = {'obj': RNG.normal(size=(3, 4, 2, 2)).astype(np.float32),
              'probe': RNG.normal(size=(1, 4, 4, 2)).astype(np.float32)}
    state = {'obj': {'m': RNG.normal(size=(3, 4, 2, 2)),
                     'v': RNG.random((3, 4, 2, 2))}}
    extra = {'i_opt_batch': np.asarray(17), 'global_batch': np.asarray(40)}
    save = jckpt.save_checkpoint if writer == 'jax' else tckpt.save_checkpoint
    path = save(str(tmp_path / 'checkpoint'), params, state, 2, 5,
                extra=extra)
    assert path.endswith(os.path.join('checkpoint', 'checkpoint.npz'))
    got = tckpt.restore_checkpoint(str(tmp_path / 'checkpoint'))
    want = jckpt.restore_checkpoint(str(tmp_path / 'checkpoint'))
    assert got[2:4] == want[2:4] == (2, 5)
    for g, w in zip(got[:2] + got[4:], want[:2] + want[4:]):
        _tree_equal(g, w)
    ck = convert.load_checkpoint(str(tmp_path / 'checkpoint'), device='cpu')
    assert (ck['i_epoch'], ck['i_batch'], ck['i_opt_batch'],
            ck['global_batch'], ck['extra']) == (2, 5, 17, 40, {})
    np.testing.assert_array_equal(ck['opt_state']['obj']['m'].numpy(),
                                  state['obj']['m'].astype(np.float32))


@pytest.mark.parametrize('io', [dict(use_orbax=True)], ids=['orbax'])
def test_checkpoint_orbax_writes_sharded_form(tmp_path, io):
    """A Reconstructor under ``use_orbax=True`` builds, runs and writes the
    sharded form (``checkpoint/dcp/``), which it resumes from."""
    cfg = pt.ReconConfig(geometry=pt.Geometry(obj_size=(4, 4, 4),
                                              probe_size=(2, 2)),
                         io=pt.IOConfig(**io))
    kw = dict(data=np.ones((1, 1, 2, 2)), probe_pos=np.zeros((1, 2)),
              device='cpu', output_folder=str(tmp_path))
    rec = pt.Reconstructor(cfg, **kw)
    assert np.isfinite(rec.run_epoch(0))
    rec.save_checkpoint(1, 0)
    assert (tmp_path / 'checkpoint' / 'dcp' / '.metadata').is_file()
    assert pt.Reconstructor(cfg, **kw)._start_epoch == 1


def test_checkpoint_orbax_raises(tmp_path):
    """A JAX orbax folder (tensorstore's format) raises, naming the
    converter."""
    (tmp_path / 'orbax').mkdir()
    with pytest.raises(NotImplementedError, match='orbax_to_npz'):
        tckpt.restore_checkpoint(str(tmp_path))
    assert tckpt.restore_checkpoint(str(tmp_path / 'none')) is None


def test_in_repo_checkpoint_restores_through_convert():
    folder = str(ADHESIN / 'recon_tomo64' / 'checkpoint')
    want = jckpt.restore_checkpoint(folder)
    ck = convert.load_checkpoint(folder, device='cpu')
    assert (ck['i_epoch'], ck['i_batch']) == want[2:4]
    for k, v in want[0].items():
        np.testing.assert_array_equal(ck['params'][k].numpy(), v)
    for k, st in want[1].items():
        for n, a in st.items():
            np.testing.assert_array_equal(ck['opt_state'][k][n].numpy(), a)
    assert ck['i_opt_batch'] == int(want[4]['i_opt_batch'])


def _imm_cfg(mod, optimizer='gd', learning_rate=1e-5, shrink_cycle=4,
             **io):
    """The regularized band-step drive of the trajectory tests: 5 angles of
    3 grid rows, 15 batches an epoch."""
    args = _setup_imm()
    return mod.ReconConfig(
        geometry=mod.Geometry(**args[0]),
        loss=mod.LossConfig(**REG_RW),
        train=mod.TrainConfig(n_epochs=3, minibatch_size=3, seed=7,
                              learning_rate=learning_rate,
                              optimizer=optimizer, shrink_cycle=shrink_cycle,
                              shrink_threshold=2e-4),
        io=mod.IOConfig(**io)), args


def _five_angles(args):
    kw, obj0, probe, pos, theta, data = args
    return dict(data=np.concatenate([data, data[:2, ::-1]]), probe_pos=pos,
                theta_ls=np.linspace(0, np.pi, 5, endpoint=False),
                obj_init=obj0.copy(), probe_init=probe,
                finite_support_mask=_support(kw['obj_size']))


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    """One mid-run state for both packages: the JAX package's run writes
    its checkpoint mid-epoch 1 (batch 10), the port restores it through
    ``convert`` and both continue to the end of epoch 2 (losses of the
    continued batches at rtol 1e-5).  Adam at a step of 1e-6: a GD run
    has no optimizer state, and the JAX package's restore then lacks the
    object's entry (a KeyError in its update).  The support does not
    shrink here: a JAX checkpoint does not hold the shrunk support, so
    both packages would resume on the initial one, freeing voxels at zero
    where the reweighted L1's weights are largest (both resumed losses
    jump 2-4x, chaotically, until the next shrink)."""
    io = dict(store_checkpoint=True, use_checkpoint=False,
              n_batch_per_checkpoint=10, optimizer='adam',
              learning_rate=1e-6, shrink_cycle=None)
    cfg, args = _imm_cfg(jcfg, **io)
    kw = _five_angles(args)
    out = str(tmp_path / 'run')
    jr = jrecon.Reconstructor(cfg, output_folder=out, **kw)
    # The JAX package checkpoints mid-epoch on its batch loop (its fused
    # epoch checkpoints once an epoch).
    jr._imm_fused_ok = lambda batches: False
    jr.run_epoch(0)
    jr.run_epoch(1)
    ck = jckpt.restore_checkpoint(os.path.join(out, 'checkpoint'))
    assert ck[2:4] == (1, 10)
    losses = {}
    for mod in (jcfg, pt):
        cfg, _ = _imm_cfg(mod, **dict(io, use_checkpoint=True,
                                      store_checkpoint=False))
        if mod is pt:
            rec = pt.Reconstructor(cfg, output_folder=out, device='cpu',
                                   **kw)
        else:
            rec = jrecon.Reconstructor(cfg, output_folder=out, **kw)
            rec._imm_fused_ok = lambda batches: False
        assert (rec._start_epoch, rec._start_batch) == (1, 10)
        ls = []
        for e in (1, 2):
            rec.run_epoch(e, callback=lambda ep, b, l: ls.append(l))
        losses[mod] = np.asarray(ls)
    assert len(losses[pt]) == 5 + 15
    np.testing.assert_allclose(losses[pt], losses[jcfg], rtol=1e-5)


@pytest.mark.parametrize('scheme', ['band', 'per_angle'])
def test_run_resumed_mid_epoch_equals_uninterrupted(tmp_path, scheme):
    """``run()`` over 3 epochs, and a run killed right after a mid-epoch
    checkpoint of epoch 1 (batch 10; per angle, after its second angle)
    then resumed by a new Reconstructor from the folder: the same final
    object, support and per-batch losses, bit for bit.  Regularizers,
    support and shrink-wrap are on; the checkpoint carries the shrunk
    support."""
    io = dict(store_checkpoint=True, use_checkpoint=True,
              n_batch_per_checkpoint=10)
    if scheme == 'band':
        cfg, args = _imm_cfg(pt, **io)
        kill_at = (1, 10)
    else:
        cfg, args = _imm_cfg(pt, **dict(io, n_batch_per_checkpoint=3))
        cfg = cfg.replace(
            loss=pt.LossConfig(gamma=1.0, alpha_d=1.0, alpha_b=0.1),
            train=dataclasses.replace(cfg.train, update_scheme='per angle',
                                      rotate_out_of_loop=True))
        kill_at = (1, 6)
    kw = _five_angles(args)

    class Killed(Exception):
        pass

    def run(folder, kill=False):
        rec = pt.Reconstructor(cfg, output_folder=str(folder), device='cpu',
                               **kw)
        if kill:
            save = rec.save_checkpoint

            def save_then_die(i_epoch, i_batch):
                save(i_epoch, i_batch)
                if (i_epoch, i_batch) == kill_at:
                    raise Killed
            rec.save_checkpoint = save_then_die
        rec.run()
        return rec

    ref = run(tmp_path / 'a')
    assert len(ref.loss_history) == 3
    with pytest.raises(Killed):
        run(tmp_path / 'b', kill=True)
    resumed = run(tmp_path / 'b')
    np.testing.assert_array_equal(resumed.obj, ref.obj)
    np.testing.assert_array_equal(resumed.finite_support_mask.numpy(),
                                  ref.finite_support_mask.numpy())
    assert resumed.finite_support_mask.sum() < kw[
        'finite_support_mask'].sum()
    assert (resumed.i_opt_batch, resumed.global_batch) == (
        ref.i_opt_batch, ref.global_batch)
    rows_a = np.genfromtxt(tmp_path / 'a' / 'convergence' / 'loss_rank_0.txt',
                           delimiter=',', names=True)
    rows_b = np.genfromtxt(tmp_path / 'b' / 'convergence' / 'loss_rank_0.txt',
                           delimiter=',', names=True)
    # The killed run logged nothing of epoch 1 (losses reach the log at
    # the epoch's end); the resumed one appends epoch 1's remaining
    # batches and epoch 2.
    n_done = kill_at[1]
    tail_a = rows_a[15 + n_done:]
    tail_b = rows_b[15:]
    np.testing.assert_array_equal(tail_b['i_epoch'], tail_a['i_epoch'])
    np.testing.assert_array_equal(tail_b['i_batch'], tail_a['i_batch'])
    np.testing.assert_array_equal(tail_b['loss'], tail_a['loss'])
    for name in ('delta_ds_1.tiff', 'beta_ds_1.tiff', 'probe_mag_ds_1.tiff',
                 'probe_phase_ds_1.tiff', 'summary.txt',
                 'checkpoint/checkpoint.npz'):
        assert (tmp_path / 'b' / name).exists()
    final = tckpt.restore_checkpoint(str(tmp_path / 'b' / 'checkpoint'))
    assert final[2:4] == (3, 0)
