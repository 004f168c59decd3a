"""The port's ``reconstruct_ptychography`` against the JAX package's, on
the small 2D file of ``tests/test_api.py`` and on the in-repo adhesin data
(the reference CI configuration, cut to a few angles): the same loss
histories and the same output trees.  The port runs with
``device='cpu'``; every file goes under a temporary directory."""

import warnings
from pathlib import Path

import numpy as np
import pytest

import adorym_tpu as jax_pkg
from adorym_tpu.simulate import simulate_to_file
from adorym_tpu.utils.initialize import initialize_probe
import adorym_tpu_torch as pt
from adorym_tpu_torch.io import data as tdata
from adorym_tpu_torch.io import output as tout

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


@pytest.fixture(scope='module')
def data_file(tmp_path_factory):
    """The small 2D ptychography dataset of ``tests/test_api.py``, in the
    reference HDF5 layout."""
    from scipy.ndimage import gaussian_filter
    root = tmp_path_factory.mktemp('apidata')
    n, pn = 48, 24
    cfg = jax_pkg.ReconConfig(
        geometry=jax_pkg.Geometry(obj_size=(n, n, 1), probe_size=(pn, pn),
                                  energy_ev=5000.0, psize_cm=1e-7,
                                  free_prop_cm='inf', two_d_mode=True),
        train=jax_pkg.TrainConfig(minibatch_size=8))
    rng = np.random.default_rng(0)
    sm = gaussian_filter(rng.random((n, n, 1)), (4, 4, 0))
    sm = (sm - sm.min()) / np.ptp(sm)
    obj_true = np.stack([sm * 2e-3, sm * 5e-5], -1).astype(np.float32)
    probe = initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                             psize_cm=1e-7, probe_mag_sigma=5,
                             probe_phase_sigma=5, probe_phase_max=0.4)
    xs = np.arange(0, n - pn + 1, 6)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    simulate_to_file(str(root / 'data.h5'), cfg, obj_true, probe, pos)
    tout.write_tiff((sm[..., 0] > 0.3).astype(np.float32),
                    root / 'mask.tiff')
    return root


def reference_style_params(root, **over):
    """``tests/test_api.py``'s params dict in the reference's style."""
    params = {
        'fname': 'data.h5', 'save_path': str(root),
        'output_folder': 'recon_test', 'obj_size': (48, 48, 1),
        'two_d_mode': True, 'n_epochs': 10, 'learning_rate': 1e-4,
        'minibatch_size': 8, 'optimizer': 'adam', 'probe_type': 'gaussian',
        'probe_mag_sigma': 5, 'probe_phase_sigma': 5, 'probe_phase_max': 0.4,
        'free_prop_cm': 'inf', 'alpha_d': None, 'alpha_b': None, 'gamma': 0,
        'use_checkpoint': False, 'save_intermediate': False,
        'backend': 'pytorch',   # reference kwarg: ignored
        'cpu_only': True,       # reference kwarg: ignored
    }
    params.update(over)
    return params


def _both(root, **over):
    """Run both packages, each into its own output folder; returns the
    two results and the two output folders."""
    out = {}
    for name, fn, extra in (('jax', jax_pkg.reconstruct_ptychography, {}),
                            ('port', pt.reconstruct_ptychography,
                             {'device': 'cpu'})):
        params = reference_style_params(root, **over)
        if params.get('output_folder'):
            params['output_folder'] = f"{params['output_folder']}_{name}"
        out[name] = (fn(**params, **extra),
                     None if not params.get('output_folder')
                     else root / params['output_folder'])
    return out['jax'], out['port']


def _tree(folder):
    return sorted(str(p.relative_to(folder)) for p in folder.rglob('*')
                  if p.is_file() and not p.name.startswith('stdout_'))


@pytest.mark.parametrize('optimizer,lr,rtol,batch_rtol', [
    ('gd', 1e-3, 1e-5, 1e-5), ('adam', 1e-4, 1e-3, 1e-2)])
def test_reference_params_match_jax(data_file, optimizer, lr, rtol,
                                    batch_rtol):
    """The reference-style params through both packages: loss histories
    (GD at rtol 1e-5; Adam, which normalises f32 noise in near-zero
    gradients into whole steps, at 1e-3 over 6 epochs and each batch's at
    1e-2), and the same output tree: summary, loss log, object and probe
    TIFFs, checkpoint."""
    (jres, jdir), (tres, tdir) = _both(data_file, optimizer=optimizer,
                                       learning_rate=lr, n_epochs=6)
    np.testing.assert_allclose(tres['loss_history'], jres['loss_history'],
                               rtol=rtol)
    assert tres['loss_history'][-1] < 0.5 * tres['loss_history'][0]
    assert tres['obj'].shape == (48, 48, 1, 2)
    assert set(tres) == set(jres)
    assert _tree(tdir) == _tree(jdir) == sorted([
        'summary.txt', 'convergence/loss_rank_0.txt', 'delta_ds_1.tiff',
        'beta_ds_1.tiff', 'probe_mag_ds_1.tiff', 'probe_phase_ds_1.tiff',
        'checkpoint/checkpoint.npz'])
    np.testing.assert_allclose(tout.parse_loss_data(str(tdir)),
                               tout.parse_loss_data(str(jdir)),
                               rtol=batch_rtol)


def test_support_intermediates_and_history_match_jax(data_file):
    """A support mask read from a TIFF, TV and L1, intermediate dumps at
    each batch with history: the same losses (GD) and the same files."""
    over = dict(optimizer='gd', learning_rate=1e-3, n_epochs=3,
                finite_support_mask_path=str(data_file / 'mask.tiff'),
                gamma=1e-3, alpha_d=1e-3, alpha_b=1e-4,
                save_intermediate=True, save_intermediate_level='batch',
                save_history=True, output_folder='recon_mask')
    (jres, jdir), (tres, tdir) = _both(data_file, **over)
    np.testing.assert_allclose(tres['loss_history'], jres['loss_history'],
                               rtol=1e-5)
    tree = _tree(tdir)
    assert tree == _tree(jdir)
    assert 'intermediate/delta_ds_1_2_3.tiff' in tree
    mask = tout.read_tiff(data_file / 'mask.tiff')
    assert np.all(tres['obj'][mask == 0] == 0)


def test_2d_support_shrinks_in_place(data_file):
    """In 2D a one-page mask TIFF is ``[y, x]``; the port spans it over
    the object's one slice, so shrink-wrap keeps the object's shape.  (The
    JAX package multiplies the ``[y, x]`` mask by the ``[y, x, 1]`` test
    and broadcasts it to ``[y, x, y]``, and its object with it.)"""
    res = pt.reconstruct_ptychography(**reference_style_params(
        data_file, optimizer='gd', learning_rate=1e-3, n_epochs=2,
        finite_support_mask_path=str(data_file / 'mask.tiff'),
        shrink_cycle=2, shrink_threshold=1e-4, output_folder=None,
        device='cpu'))
    assert res['obj'].shape == (48, 48, 1, 2)
    inside = tout.read_tiff(data_file / 'mask.tiff') > 0
    kept = res['obj'][..., 0, 0] != 0
    assert kept.sum() < inside.sum() and not np.any(kept & ~inside)


def test_per_angle_scheme_and_epoch_dumps_match_jax(data_file):
    """2D per-angle updates (one angle: one update an epoch) with the
    epoch-level dumps: the same losses and files."""
    over = dict(optimizer='gd', learning_rate=1e-3, n_epochs=3,
                update_scheme='per angle', minibatch_size=5,
                save_intermediate=True, save_intermediate_level='epoch',
                save_history=True, output_folder='recon_pa')
    (jres, jdir), (tres, tdir) = _both(data_file, **over)
    np.testing.assert_allclose(tres['loss_history'], jres['loss_history'],
                               rtol=1e-5)
    assert _tree(tdir) == _tree(jdir)
    assert 'intermediate/delta_ds_1_2.tiff' in _tree(tdir)


def test_auto_epochs_stop_at_the_same_epoch(data_file):
    """``n_epochs='auto'``: both stop when the loss falls by less than
    ``crit_conv_rate``."""
    (jres, _), (tres, _) = _both(data_file, optimizer='gd',
                                 learning_rate=1e-3, n_epochs='auto',
                                 crit_conv_rate=0.05, max_nepochs=30,
                                 output_folder=None)
    assert 2 < len(tres['loss_history']) == len(jres['loss_history']) < 30
    np.testing.assert_allclose(tres['loss_history'], jres['loss_history'],
                               rtol=1e-5)


def test_multiscale_and_jax_regularizer_objects(data_file):
    """Two multiscale levels, and regularizers given as the JAX package's
    objects (matched by class name): the same losses."""
    from adorym_tpu.models import regularizers as jregs
    over = dict(optimizer='gd', learning_rate=1e-3, n_epochs=2,
                multiscale_level=2, output_folder=None,
                regularizers=[jregs.TVRegularizer('delta_beta', 1e-3),
                              jregs.L1Regularizer('delta_beta', 1e-3, 0.0)])
    (jres, _), (tres, _) = _both(data_file, **over)
    np.testing.assert_allclose(tres['loss_history'], jres['loss_history'],
                               rtol=1e-5)


def test_resume_through_the_api(data_file):
    """A second call continues from the first one's checkpoint (the
    reference's ``use_checkpoint``), appending to the loss log."""
    params = reference_style_params(
        data_file, output_folder='recon_ckpt_port', n_epochs=3,
        store_checkpoint=True, use_checkpoint=False,
        n_batch_per_checkpoint=5, device='cpu')
    r1 = pt.reconstruct_ptychography(**params)
    r2 = pt.reconstruct_ptychography(**dict(params, n_epochs=5,
                                            use_checkpoint=True))
    assert len(r1['loss_history']) == 3 and len(r2['loss_history']) == 2
    curve = tout.parse_loss_data(str(data_file / 'recon_ckpt_port'))
    assert len(curve) == 5 * 4          # 5 epochs of 4 batches


def test_t_max_stops_with_a_checkpoint(data_file, tmp_path):
    """``t_max_min``: past the wall time the run checkpoints the next
    batch and stops."""
    params = reference_style_params(
        data_file, output_folder='recon_tmax', n_epochs=5, t_max_min=0.0,
        n_batch_per_checkpoint=100, device='cpu')
    res = pt.reconstruct_ptychography(**params)
    assert len(res['loss_history']) == 1
    from adorym_tpu_torch.io.checkpoint import restore_checkpoint
    ck = restore_checkpoint(str(data_file / 'recon_tmax' / 'checkpoint'))
    assert ck[2:4] == (0, 1)


def test_dataset_keyword_and_save_stdout(data_file, capsys):
    """An in-memory dataset in place of the file, and the progress lines
    teed to ``stdout_<time>.txt``."""
    ds = tdata.RawDataset(str(data_file / 'data.h5'))
    mem = tdata.ArrayDataset(ds.all_magnitudes(), probe_pos_px=ds.probe_pos(),
                             energy_ev=ds.energy_ev(), psize_cm=ds.psize_cm())
    kw = dict(optimizer='gd', learning_rate=1e-3, n_epochs=2,
              output_folder='recon_mem', device='cpu')
    a = pt.reconstruct_ptychography(**reference_style_params(
        data_file, save_stdout=True, **kw), dataset=mem)
    b = pt.reconstruct_ptychography(**reference_style_params(
        data_file, **dict(kw, output_folder=None)))
    np.testing.assert_array_equal(a['loss_history'], b['loss_history'])
    assert '[epoch 1] loss=' in capsys.readouterr().out
    logs = list((data_file / 'recon_mem').glob('stdout_*.txt'))
    assert len(logs) == 1 and 'patterns/s' in logs[0].read_text()


def test_adhesin_configuration_matches_jax(tmp_path):
    """The reference CI configuration (``demos/multislice_tomography_64.py``:
    64^3, plane probe at one position, ``free_prop_cm=0``, reweighted L1,
    TV, Adam 5e-6, minibatch 1) on the in-repo adhesin file, cut to 3
    angles and 2 epochs: both take the generic step and write the same
    files.  The losses agree at 1e-2: the loss is the square of a
    difference of magnitudes near 1 (f32 resolves it to about 5e-5; a GD
    epoch without the weighted L1 gives 4.5e-5 between the packages), and
    Adam with reweighted L1 steps entries near zero on the sign of f32
    noise: perturbing the JAX package's own start by 1e-7 moves its
    losses by 6.6e-5 and 1.4e-3."""
    n = 64
    out = {}
    for name, fn, extra in (('jax', jax_pkg.reconstruct_ptychography, {}),
                            ('port', pt.reconstruct_ptychography,
                             {'device': 'cpu'})):
        out[name] = fn(
            fname='data_adhesin_64_theta_36.h5', save_path=str(ADHESIN),
            output_folder=str(tmp_path / name), obj_size=(n, n, n),
            n_epochs=2, n_theta=3, learning_rate=5e-6,
            alpha_d=1e-9 * n ** 3, alpha_b=1e-10 * n ** 3,
            reweighted_l1=True, energy_ev=800, psize_cm=0.67e-7,
            minibatch_size=1, free_prop_cm=0, probe_type='plane',
            probe_pos=[(0, 0)], optimizer='adam', use_checkpoint=False,
            **extra)
    np.testing.assert_allclose(out['port']['loss_history'],
                               out['jax']['loss_history'], rtol=1e-2)
    assert _tree(tmp_path / 'port') == _tree(tmp_path / 'jax')


@pytest.mark.parametrize('over,exc,match', [
    (dict(optimize_probe=True, optimizer_probe='curveball'), ValueError,
     'first-order'),
    (dict(update_using_external_algorithm='foo'), ValueError,
     'external_algorithm'),
    (dict(forward_model='multidist'), NotImplementedError, 'A.5'),
    (dict(parallel_data_axis=2), RuntimeError, 'process group'),
    (dict(distribution_mode='shared_file', parallel_data_axis=2),
     RuntimeError, 'process group'),
    (dict(parallel_object_axis=2), RuntimeError, 'process group'),
    (dict(optimizer='curveball', parallel_data_axis=2), RuntimeError,
     'process group')])
def test_unported_branches_raise(data_file, over, exc, match):
    """What the port leaves out (A.5's models by name) raises
    NotImplementedError naming it, the second-order optimizers included;
    a mesh (``parallel_*_axis``, with ``distribution_mode='shared_file'``
    too) outside a process group raises RuntimeError (no silent
    one-device run); an auxiliary leaf given a second-order kind and an
    unknown external algorithm raise ValueError, as in the JAX
    package."""
    params = reference_style_params(data_file, output_folder=None,
                                    n_epochs=1, device='cpu', **over)
    with pytest.raises(exc, match=match):
        pt.reconstruct_ptychography(**params)


@pytest.mark.parametrize('over', [
    dict(use_orbax=True),
    dict(optimizer='cg', distribution_mode='shared_file', use_orbax=True)],
    ids=['orbax', 'orbax_cg_shared_file'])
def test_orbax_runs_and_writes_sharded_checkpoint(data_file, tmp_path, over):
    """``use_orbax=True`` runs through ``reconstruct_ptychography``, with a
    second-order optimizer and offloaded state too, and writes the sharded
    checkpoint form (``checkpoint/dcp/``) instead of the npz form."""
    params = reference_style_params(data_file,
                                    output_folder=str(tmp_path / 'out'),
                                    n_epochs=1, device='cpu', **over)
    res = pt.reconstruct_ptychography(**params)
    assert np.all(np.isfinite(res['loss_history']))
    ck = tmp_path / 'out' / 'checkpoint'
    assert (ck / 'dcp' / '.metadata').is_file()
    assert not (ck / 'checkpoint.npz').exists()


def test_unknown_kwarg_warns_and_default_device_is_cuda(data_file,
                                                        monkeypatch):
    import torch
    params = reference_style_params(data_file, output_folder=None,
                                    n_epochs=1, device='cpu')
    params['definitely_not_a_kwarg'] = 42
    with pytest.warns(UserWarning, match='definitely_not_a_kwarg'):
        pt.reconstruct_ptychography(**params)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        pt.reconstruct_ptychography(**reference_style_params(
            data_file, output_folder=None, n_epochs=1, device='cpu'))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        pt.reconstruct_ptychography(**reference_style_params(
            data_file, output_folder=None, n_epochs=1))


def test_per_angle_probe_and_forced_checkpoint(data_file):
    """``shared_probe_among_angles=False`` refines one probe an angle (a
    5D probe) as in the JAX package; ``force_to_use_checkpoint`` without a
    checkpoint raises."""
    over = dict(optimizer='gd', learning_rate=1e-3, n_epochs=2,
                shared_probe_among_angles=False, optimize_probe=True,
                optimizer_probe='gd', probe_learning_rate=1e-3,
                output_folder=None)
    (jres, _), (tres, _) = _both(data_file, **over)
    assert tres['probe'].shape == jres['probe'].shape == (1, 1, 24, 24, 2)
    np.testing.assert_allclose(tres['loss_history'], jres['loss_history'],
                               rtol=1e-5)
    with pytest.raises(FileNotFoundError, match='force_to_use_checkpoint'):
        pt.reconstruct_ptychography(**reference_style_params(
            data_file, output_folder='recon_forced', n_epochs=1,
            use_checkpoint=True, force_to_use_checkpoint=True,
            device='cpu'))
