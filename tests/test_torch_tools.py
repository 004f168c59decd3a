"""The port's user tools (``adorym_tpu_torch/tools/``) and
``utils.profiling.profiler_trace`` on the CPU: every test of
``tests/test_tools.py`` that imports the JAX package, on the port's tool;
where a tool computes, the port's tool against the JAX package's on the
same inputs; and no module of the port's demos or tools reaching JAX.

Tolerances: ``retrieve_probe``'s probe and MSE within 1e-5 (of the
largest magnitude, relative) of the JAX tool's at the same seed (at 10
epochs: see :func:`test_initialize_probe_er`); the
affine warp and the registered images within 1e-6 of the largest value,
the registration shifts equal; the CTF phase within 1e-5 of its largest
magnitude; file-only tools equal."""

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors: under a parallel
    test run, several workers' thread pools oversubscribe the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        'jax_tool_' + name, REPO / 'tools' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool(name):
    return importlib.import_module(f'adorym_tpu_torch.tools.{name}')


def _run_jax_main(monkeypatch, name, argv):
    """A JAX tool whose ``main()`` reads ``sys.argv``."""
    monkeypatch.setattr(sys, 'argv', [name] + list(argv))
    return _jax_tool(name).main()


# -- the mirrors of tests/test_tools.py ------------------------------------
def test_convert_aps_2idd_reads_in_port(tmp_path):
    """The shared (numpy and h5py) converter's file, read by the port."""
    import h5py
    m = _jax_tool('convert_aps_2idd_to_adorym')
    rng = np.random.default_rng(1)
    src = tmp_path / 'beamline.h5'
    with h5py.File(src, 'w') as f:
        f.create_dataset('dp', data=rng.random((5, 8, 8)).astype(np.float32))
        f.create_dataset('lambda', data=np.array([1.4089e-10]))  # ~8.8 keV
        f.create_dataset('dx', data=np.array([1.3279e-8]))       # m
        f.create_dataset('ppX', data=rng.random(5) * 1e-6)
        f.create_dataset('ppY', data=rng.random(5) * 1e-6)
    out = tmp_path / 'data.h5'
    info = m.convert(str(src), str(out))
    assert abs(info['energy_ev'] - 8801.2) < 1.0
    from adorym_tpu_torch.io.data import RawDataset
    ds = RawDataset(str(out))
    assert ds.all_magnitudes().shape == (1, 5, 8, 8)
    pos = ds.probe_pos()
    assert pos.shape == (5, 2) and pos.min() >= 0
    assert ds.energy_ev() == pytest.approx(info['energy_ev'])


def _multidist_folder(src, seed=2):
    from adorym_tpu_torch.io.output import write_tiff
    rng = np.random.default_rng(seed)
    os.makedirs(src)
    imgs = {}
    for t in range(2):
        for d in range(3):
            img = rng.random((16, 16)).astype(np.float32)
            imgs[(t, d)] = img
            write_tiff(img, str(src / f'data_{t:04d}_{d:02d}.tiff'))
    return imgs


def test_convert_multidistance_with_blocks(tmp_path):
    import h5py
    imgs = _multidist_folder(tmp_path / 'raw')
    kw = dict(n_blocks_y=2, n_blocks_x=2, energy_ev=17500., psize_cm=1e-5)
    out = tmp_path / 'md.h5'
    info = _tool('convert_multidistance_to_adorym').convert(
        str(tmp_path / 'raw'), [0.1, 0.2, 0.3], 'data', str(out), **kw)
    assert info['n_blocks'] == 4 and info['block_shape'] == (8, 8)
    ref = tmp_path / 'md_jax.h5'
    want = _jax_tool('convert_multidistance_to_adorym').convert(
        str(tmp_path / 'raw'), [0.1, 0.2, 0.3], 'data', str(ref), **kw)
    assert info == want
    with h5py.File(out, 'r') as f, h5py.File(ref, 'r') as g:
        data = f['exchange/data'][...]
        assert data.shape == (2, 12, 8, 8)
        # Row layout i_dist * n_blocks + block; block 1 is top-right tile.
        np.testing.assert_allclose(data[1, 1 * 4 + 1], imgs[(1, 1)][:8, 8:])
        np.testing.assert_allclose(f['metadata/free_prop_cm'][...],
                                   [0.1, 0.2, 0.3])
        for k in ('exchange/data', 'metadata/probe_pos_px',
                  'metadata/free_prop_cm', 'metadata/energy_ev'):
            np.testing.assert_array_equal(f[k][...], g[k][...])


def _shifted_folder(src):
    from adorym_tpu_torch.io.output import write_tiff
    from scipy.ndimage import gaussian_filter, shift as nd_shift
    rng = np.random.default_rng(3)
    base = gaussian_filter(rng.random((32, 32)), 2).astype(np.float32)
    os.makedirs(src)
    true_shifts = [np.zeros(2), np.array([2.0, -3.0])]
    for t in range(2):
        for d in range(2):
            img = nd_shift(base + 0.1 * t, -true_shifts[d], order=1,
                           mode='wrap')
            write_tiff(img, str(src / f'data_{t:04d}_{d:02d}.tiff'))
    return true_shifts


def test_register_multidistance(tmp_path):
    from adorym_tpu_torch.io.output import read_tiff
    true_shifts = _shifted_folder(tmp_path / 'raw')
    out_dir, shifts = _tool('register_multidistance_data').register_folder(
        str(tmp_path / 'raw'), 'data', device='cpu')
    # img was shifted by -s, so the measured correction is +s.
    np.testing.assert_allclose(shifts[1], true_shifts[1], atol=0.2)
    reg = read_tiff(os.path.join(out_dir, 'data_0000_01.tiff'))
    ref = read_tiff(os.path.join(out_dir, 'data_0000_00.tiff'))
    assert np.abs(reg - ref).mean() < 0.02
    # The JAX tool on a copy of the same folder.
    shutil.copytree(tmp_path / 'raw', tmp_path / 'jraw')
    j_dir, j_shifts = _jax_tool('register_multidistance_data').register_folder(
        str(tmp_path / 'jraw'), 'data')
    np.testing.assert_array_equal(np.asarray(shifts), np.asarray(j_shifts))
    for name in sorted(os.listdir(out_dir)):
        a = read_tiff(os.path.join(out_dir, name))
        b = read_tiff(os.path.join(j_dir, name))
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), name


def test_rescale_cone_to_parallel():
    m = _tool('rescale_multidistance_data')
    from scipy.ndimage import zoom, gaussian_filter
    rng = np.random.default_rng(4)
    img = gaussian_filter(rng.random((40, 40)), 3).astype(np.float32)
    # Distance 1 (reference frame) is magnified 1.5625x; distance 0 only
    # 1.25x: its image shows the scene smaller by a factor 0.8.
    z_sd, z_od = 100.0, np.array([20.0, 36.0])
    mag = z_sd / (z_sd - z_od)
    small = zoom(img, mag[0] / mag[1], order=1)   # 32x32
    frame0 = np.pad(small, 4, mode='edge')        # back to 40x40
    out, z_eff, mags = m.convert_cone_to_parallel([frame0, img], z_sd, z_od)
    assert out[0].shape == img.shape
    sl = slice(10, 30)
    corr = np.corrcoef(np.asarray(out[0])[sl, sl].ravel(),
                       img[sl, sl].ravel())[0, 1]
    assert corr > 0.95, corr
    np.testing.assert_allclose(z_eff, (z_sd - z_od) * z_od / z_sd)


def _disk_pattern(n=32):
    yy, xx = np.mgrid[:n, :n] - (n - 1) / 2
    true_probe = (np.hypot(yy, xx) <= 6).astype(np.complex64)
    return np.abs(np.fft.fftshift(np.fft.fft2(true_probe)))


def test_initialize_probe_er():
    """``tests/test_tools.py::test_initialize_probe_er``'s two assertions
    on the port's ER loop (300 epochs), then the loop against the JAX
    tool's at the same seed.  ER on a hard-edged disk stagnates and its
    iterate is chaotic: the two packages' f32 FFTs start 2e-7 apart and the
    gap grows about twofold an epoch past 20 epochs (0.02 at 50, 0.69 of
    the largest magnitude at 300, both trajectories equally valid), so the
    packages are compared at 10 epochs (2.2e-6)."""
    n = 32
    dp = _disk_pattern(n)
    probe, mse = _tool('initialize_probe_er').retrieve_probe(
        dp, mask_radius=8, n_epochs=300, device='cpu')
    assert mse < 0.3 * np.mean(dp ** 2), (mse, np.mean(dp ** 2))
    yy, xx = np.mgrid[:n, :n] - (n - 1) / 2
    inside = np.hypot(yy, xx) <= 8
    e_in = np.sum(np.abs(probe[inside]) ** 2)
    e_out = np.sum(np.abs(probe[~inside]) ** 2)
    assert e_in > 5 * e_out, (e_in, e_out)
    probe, mse = _tool('initialize_probe_er').retrieve_probe(
        dp, mask_radius=8, n_epochs=10, device='cpu')
    want, want_mse = _jax_tool('initialize_probe_er').retrieve_probe(
        dp, mask_radius=8, n_epochs=10)
    err = np.abs(probe - want).max() / np.abs(want).max()
    print(f'retrieve_probe: probe {err:.2e} of its largest magnitude, '
          f'mse {mse!r} against {want_mse!r}')
    assert err <= 1e-5, err
    np.testing.assert_allclose(mse, want_mse, rtol=1e-5)


def test_stitch_distributed_objects(tmp_path):
    from adorym_tpu_torch.io.output import read_tiff, write_tiff
    m = _tool('stitch_distributed_objects')
    rng = np.random.default_rng(5)
    slabs = [rng.random((4, 8, 8)).astype(np.float32) for _ in range(3)]
    for r, s in enumerate(slabs):
        write_tiff(s, str(tmp_path / f'delta_rank_{r}.tiff'))
        write_tiff(s + 1, str(tmp_path / f'beta_rank_{r}.tiff'))
    out = m.stitch(str(tmp_path))
    assert len(out) == 2
    stack = read_tiff(os.path.join(str(tmp_path), 'delta_stack.tiff'))
    np.testing.assert_allclose(stack, np.concatenate(slabs, 0))


def test_stitch_reads_mesh_outputs(tmp_path):
    """A mesh run's output folder, the port's (two gloo ranks, the object
    split in y) and the JAX package's (its virtual mesh): rank 0 writes
    one whole object in both, with the same files, so the tool finds no
    slab files in either and leaves them as they are."""
    import test_torch_mesh_ranks as C
    from test_torch_mesh_setup import problem, with_mesh
    from adorym_tpu.parallel.mesh import make_mesh
    from adorym_tpu.recon import Reconstructor
    from adorym_tpu_torch.io.output import read_tiff
    from adorym_tpu_torch.parallel.launch import RankPool
    m = _tool('stitch_distributed_objects')
    jc, tc, kw = problem(seed=2, n=24, nz=8, pn=8, stride=8, n_theta=2)
    port_dir, jax_dir = tmp_path / 'port', tmp_path / 'jax'
    with RankPool(2, 'cpu', timeout_s=240) as pool:
        got = pool.run(C.run_with_checkpoint, with_mesh(tc, 1, 2), kw,
                       str(port_dir), 1)[0]
    jm = with_mesh(jc, 1, 2)
    Reconstructor(jm, mesh=make_mesh(jm.parallel), output_folder=str(jax_dir),
                  **kw).run(n_epochs=1)
    tiffs = {d: sorted(p.name for p in d.glob('*.tif*'))
             for d in (port_dir, jax_dir)}
    assert tiffs[port_dir] == tiffs[jax_dir] and tiffs[port_dir]
    for d in (port_dir, jax_dir):
        assert m.stitch(str(d)) == []
        assert sorted(p.name for p in d.glob('*.tif*')) == tiffs[d]
    delta = read_tiff(str(port_dir / tiffs[port_dir][0]))
    assert sorted(delta.shape) == sorted(got['obj'].shape[:3])


def test_convert_csv_to_tiff(tmp_path):
    from adorym_tpu_torch.io.output import read_tiff
    arr = np.array([[1.5e-1 + 2.0e-2j, -3.0e-3 - 4.0e-1j],
                    [5.0e+0 + 0.0e+0j, -1.0e-2 + 7.5e-1j]])
    path = tmp_path / 'dump.csv'
    with open(path, 'w') as f:
        for row in arr:
            f.write(', '.join(f'({v.real:.4e}+{v.imag:.4e}j)'.replace('+-', '-')
                              for v in row) + '\n')
    mag_p, ph_p = _tool('convert_csv_to_tiff').convert(str(path))
    np.testing.assert_allclose(read_tiff(mag_p), np.abs(arr), rtol=1e-3)
    np.testing.assert_allclose(read_tiff(ph_p), np.angle(arr), atol=1e-3)


def test_affine_transform_images(tmp_path):
    from adorym_tpu_torch.io.output import read_tiff, write_tiff
    rng = np.random.default_rng(6)
    src = tmp_path / 'imgs'
    os.makedirs(src)
    for t in range(2):
        for d in range(2):
            write_tiff(rng.random((16, 16)).astype(np.float32),
                       str(src / f'img_{t:04d}_{d:02d}.tiff'))
    eye = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    mats = np.concatenate([eye, eye * np.array([[0.9], [0.9]])])
    np.savetxt(tmp_path / 'mats.txt', mats)
    out = _tool('affine_transform_images').apply_affines(
        str(src), str(tmp_path / 'mats.txt'), str(tmp_path / 'out'), 'img',
        device='cpu')
    # Identity affine: distance-0 images unchanged.
    a = read_tiff(os.path.join(out, 'img_0000_00.tiff'))
    b = read_tiff(str(src / 'img_0000_00.tiff'))
    np.testing.assert_allclose(a, b, atol=1e-5)
    ref = _jax_tool('affine_transform_images').apply_affines(
        str(src), str(tmp_path / 'mats.txt'), str(tmp_path / 'jout'), 'img')
    for name in sorted(os.listdir(out)):
        x = read_tiff(os.path.join(out, name))
        y = read_tiff(os.path.join(ref, name))
        assert np.abs(x - y).max() <= 1e-6 * np.abs(y).max(), name


def _small_sim_cfg(pkg, n=16, pn=8, nz=4):
    return pkg.ReconConfig(
        geometry=pkg.Geometry(obj_size=(n, n, nz), probe_size=(pn, pn),
                              energy_ev=5000.0, psize_cm=1e-7,
                              free_prop_cm='inf'),
        train=pkg.TrainConfig(minibatch_size=4))


def test_simulation_resume(tmp_path):
    """Killing and restarting a multi-angle simulation continues from the
    checkpointed angle, on the port's ``simulate_to_file``."""
    import h5py
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.simulate import simulate_to_file
    from adorym_tpu_torch.utils.initialize import initialize_probe
    cfg = _small_sim_cfg(pt)
    rng = np.random.default_rng(0)
    obj = np.stack([rng.random((16, 16, 4)) * 1e-3,
                    rng.random((16, 16, 4)) * 3e-5], -1).astype(np.float32)
    probe = initialize_probe((8, 8), 'plane')
    pos = np.array([[0.0, 0.0], [4.0, 4.0], [8.0, 8.0]])
    theta = np.linspace(0, np.pi, 5, endpoint=False)
    straight = simulate_to_file(str(tmp_path / 'a.h5'), cfg, obj, probe,
                                pos, theta, device='cpu')
    path = str(tmp_path / 'b.h5')
    full = simulate_to_file(path, cfg, obj, probe, pos, theta,
                            use_checkpoint=True, device='cpu')
    np.testing.assert_allclose(full, straight, atol=1e-6)
    assert not os.path.exists(path + '.sim_checkpoint_i_theta.txt')
    with h5py.File(path, 'r+') as f:
        f['exchange/data'][2:] = -1.0
    np.savetxt(path + '.sim_checkpoint_i_theta.txt', [2], fmt='%d')
    resumed = simulate_to_file(path, cfg, obj, probe, pos, theta,
                               use_checkpoint=True, device='cpu')
    np.testing.assert_allclose(resumed, straight, atol=1e-6)


def test_monitor_reconstruction(tmp_path):
    """The port's monitor reports the loss tail and the latest
    intermediate dumps of the port's live output folder, and renders the
    status figure."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.utils.initialize import initialize_probe
    n, pn = 16, 8
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(n, n, 1), probe_size=(pn, pn),
                             energy_ev=5000.0, psize_cm=1e-7,
                             free_prop_cm='inf', two_d_mode=True),
        train=pt.TrainConfig(minibatch_size=4, learning_rate=1e-4),
        io=pt.IOConfig(save_intermediate=True,
                       save_intermediate_level='epoch',
                       store_checkpoint=False, use_checkpoint=False))
    rng = np.random.default_rng(0)
    obj = np.stack([rng.random((n, n, 1)) * 1e-3,
                    rng.random((n, n, 1)) * 3e-5], -1).astype(np.float32)
    probe = initialize_probe((pn, pn), 'plane')
    pos = np.array([[0.0, 0.0], [4.0, 4.0], [8.0, 8.0], [8.0, 0.0]])
    data = pt.simulate(cfg, obj, probe, pos, device='cpu')
    out = str(tmp_path / 'run')
    rec = pt.Reconstructor(cfg, data=data, probe_pos=pos, probe_init=probe,
                           obj_init=np.zeros_like(obj), output_folder=out,
                           device='cpu')
    rec.run(n_epochs=2)
    mon = _tool('monitor_reconstruction')
    text, curve, obj_path, probe_path = mon.report(out)
    assert 'last loss' in text and len(curve) == 2
    assert obj_path is not None and os.path.exists(obj_path)
    assert probe_path is not None and os.path.exists(probe_path)
    png = str(tmp_path / 'status.png')
    mon.save_figure(png, curve, obj_path, probe_path)
    assert os.path.getsize(png) > 0


# -- the computing tools against the JAX tools ------------------------------
def test_phase_retrieval_ctf_matches_jax(tmp_path, monkeypatch):
    """The CTF retrieval tool on holograms the port simulates, against the
    JAX tool on the same file."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.io.data import write_data_file
    from adorym_tpu_torch.io.output import read_tiff
    from adorym_tpu_torch.models import multidist
    from adorym_tpu_torch.utils.initialize import initialize_probe
    from scipy.ndimage import gaussian_filter
    n, dists = 64, (0.05, 0.12, 0.3)
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(n, n, 1), probe_size=(n, n),
                             energy_ev=17500.0, psize_cm=1e-5,
                             free_prop_cm=dists, n_dists=len(dists),
                             two_d_mode=True, safe_zone_width=0),
        train=pt.TrainConfig(minibatch_size=1, unknown_type='real_imag'))
    rng = np.random.default_rng(3)
    base = rng.normal(size=(n, n, 1))
    ph = gaussian_filter(base, (2, 2, 0)) - gaussian_filter(base, (6, 6, 0))
    ph = ph / np.abs(ph).max() * 0.3
    obj = np.stack([np.cos(ph), np.sin(ph)], -1).astype(np.float32)
    data = pt.simulate(cfg, obj, initialize_probe((n, n), 'plane'),
                       np.array([[0.0, 0.0]]), model=multidist, device='cpu')
    path = str(tmp_path / 'holo.h5')
    write_data_file(path, data, probe_pos=np.array([[0.0, 0.0]]),
                    energy_ev=17500.0, psize_cm=1e-5, free_prop_cm=dists)
    argv = [path, '--free-prop-cm'] + [str(d) for d in dists]
    got = _tool('phase_retrieval_multidist_ctf').main(
        argv + ['--out', str(tmp_path / 'port'), '--device', 'cpu'])
    _run_jax_main(monkeypatch, 'phase_retrieval_multidist_ctf',
                  argv + ['--out', str(tmp_path / 'jax')])
    a = read_tiff(got)
    b = read_tiff(str(tmp_path / 'jax.tiff'))
    err = np.abs(a - b).max() / np.abs(b).max()
    print(f'CTF phase: {err:.2e} of its largest magnitude; correlation '
          f'with the phantom {np.corrcoef(a.ravel(), ph.ravel())[0, 1]:.3f}')
    assert err <= 1e-5, err


def test_create_ptycho_data_matches_jax(tmp_path, monkeypatch):
    import h5py
    argv = ['--obj-size', '16', '16', '4', '--probe-size', '8',
            '--stride', '4', '--n-theta', '2']
    got = _tool('create_ptycho_data').main(
        argv + ['--out', str(tmp_path / 'p.h5'), '--device', 'cpu'])
    _run_jax_main(monkeypatch, 'create_ptycho_data',
                  argv + ['--out', str(tmp_path / 'j.h5')])
    with h5py.File(tmp_path / 'p.h5', 'r') as f, \
            h5py.File(tmp_path / 'j.h5', 'r') as g:
        a, b = f['exchange/data'][...], g['exchange/data'][...]
        assert a.shape == b.shape == (2, 9, 8, 8)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
        for k in ('metadata/probe_pos_px', 'metadata/theta'):
            np.testing.assert_array_equal(f[k][...], g[k][...])
    np.testing.assert_array_equal(got, a)


def test_support_mask_and_loss_curve_match_jax(tmp_path, monkeypatch,
                                               capsys):
    from adorym_tpu_torch.io.output import LossLogger, read_tiff
    argv = ['--obj-size', '16', '16', '8', '--radius', '5']
    for shape in ('sphere', 'cylinder'):
        got = _tool('create_support_mask').main(
            argv + ['--shape', shape, '--out', str(tmp_path / f'p_{shape}')])
        _run_jax_main(monkeypatch, 'create_support_mask',
                      argv + ['--shape', shape,
                              '--out', str(tmp_path / f'j_{shape}')])
        np.testing.assert_array_equal(
            read_tiff(got), read_tiff(str(tmp_path / f'j_{shape}.tiff')))
    log = LossLogger(str(tmp_path / 'run'))
    for b, loss in enumerate((3.0, 2.5, 2.25)):
        log.log(0, b, loss)
    log.close()
    capsys.readouterr()
    curve = _tool('plot_loss_curve').main([str(tmp_path / 'run')])
    port_out = capsys.readouterr().out
    _run_jax_main(monkeypatch, 'plot_loss_curve', [str(tmp_path / 'run')])
    assert port_out == capsys.readouterr().out
    np.testing.assert_array_equal(curve, [3.0, 2.5, 2.25])


def test_profiler_trace_writes_a_trace(tmp_path):
    import torch
    from adorym_tpu_torch.utils.profiling import profiler_trace
    with profiler_trace(None):
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    with profiler_trace(str(tmp_path / 'trace')):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    traces = list((tmp_path / 'trace').glob('trace_*.json'))
    assert len(traces) == 1
    assert 'aten::mm' in traces[0].read_text()


# -- the checkpoint converters ------------------------------------------------
def _gd_problem():
    """``tests/test_offload.py``'s problem at 16^3 under GD, the port's
    config, and the JAX package's config of the same sections, both
    checkpointing with ``use_orbax``."""
    import dataclasses
    import adorym_tpu.config as jcfg
    import adorym_tpu_torch as pt
    from test_torch_offload import _kw, _problem
    cfg, obj_true, probe, pos, theta_ls, data = _problem(pt, 'gd', n=16)
    io = dict(store_checkpoint=True, use_checkpoint=True, use_orbax=True,
              n_batch_per_checkpoint=10_000)
    tc = dataclasses.replace(cfg, io=pt.IOConfig(**io))
    jc = jcfg.ReconConfig(
        geometry=jcfg.Geometry(**dataclasses.asdict(cfg.geometry)),
        train=jcfg.TrainConfig(**dataclasses.asdict(cfg.train)),
        io=jcfg.IOConfig(**io))
    kw = dict(data=data, **_kw(pos, probe, theta_ls, obj_true * 0.5))
    return tc, jc, kw


def _two_epochs_then_save(rec):
    for ep in range(2):
        rec.run_epoch(ep)
    rec.save_checkpoint(2, 0)


def _jax_resume(jc, kw, folder):
    """The JAX package's resume from ``folder`` and its epochs 2 and 3 (a
    GD run gets its empty object state back first: the JAX package's
    restored state lacks it, ROADMAP C)."""
    from adorym_tpu.recon import Reconstructor
    rec = Reconstructor(jc, output_folder=folder, **kw)
    assert rec._start_epoch == 2
    for k in rec.specs:
        rec.opt_state.setdefault(k, {})
    for ep in (2, 3):
        rec.run_epoch(ep)
    return np.asarray(rec.params['obj'])


def _port_resume(tc, kw, folder):
    import adorym_tpu_torch as pt
    rec = pt.Reconstructor(tc, device='cpu', output_folder=folder, **kw)
    assert rec._start_epoch == 2
    for ep in (2, 3):
        rec.run_epoch(ep)
    return rec.obj


def _close_obj(a, b, rtol=1e-5):
    assert np.abs(a - b).max() <= rtol * np.abs(b).max()


def test_convert_checkpoint_port_to_jax(tmp_path):
    """A port sharded checkpoint, converted to the npz form, resumes in the
    JAX package; under GD its trajectory equals the port's own resume
    (1e-5 of the object's largest value)."""
    import dataclasses
    import adorym_tpu.config as jcfg
    import adorym_tpu_torch as pt
    tc, jc, kw = _gd_problem()
    folder = str(tmp_path / 'port')
    _two_epochs_then_save(pt.Reconstructor(tc, device='cpu',
                                           output_folder=folder, **kw))
    ck = tmp_path / 'port' / 'checkpoint'
    assert (ck / 'dcp').is_dir() and not (ck / 'checkpoint.npz').exists()
    _tool('convert_checkpoint').main([str(ck)])
    with np.load(ck / 'checkpoint.npz') as z:
        assert 'params/obj' in z.files and 'extra/obj_slab_rows' not in z.files
    jc = dataclasses.replace(jc, io=dataclasses.replace(jc.io,
                                                        use_orbax=False))
    got = _jax_resume(jc, kw, folder)
    _close_obj(_port_resume(tc, kw, folder), got)


def test_orbax_to_npz_jax_to_port(tmp_path, monkeypatch):
    """A JAX orbax checkpoint, converted by ``tools/orbax_to_npz.py``,
    resumes in the port (which refuses the orbax folder itself); under GD
    its trajectory equals the JAX package's own orbax resume (1e-5)."""
    from adorym_tpu.recon import Reconstructor
    from adorym_tpu_torch.io import checkpoint as tckpt
    tc, jc, kw = _gd_problem()
    folder = str(tmp_path / 'jax')
    _two_epochs_then_save(Reconstructor(jc, output_folder=folder, **kw))
    ck = tmp_path / 'jax' / 'checkpoint'
    with pytest.raises(NotImplementedError, match='orbax_to_npz'):
        tckpt.restore_checkpoint(str(ck))
    want = _jax_resume(jc, kw, folder)
    _run_jax_main(monkeypatch, 'orbax_to_npz', [str(ck)])
    assert (ck / 'checkpoint.npz').is_file() and (ck / 'orbax').is_dir()
    _close_obj(_port_resume(tc, kw, folder), want)


# -- no port module reaches the JAX package ---------------------------------
def test_demos_and_tools_import_without_jax():
    """Every module under ``adorym_tpu_torch/demos/`` and
    ``adorym_tpu_torch/tools/`` imports in a fresh interpreter in which
    ``jax`` and ``adorym_tpu`` cannot be imported."""
    names = [f'adorym_tpu_torch.{sub}.{p.stem}'
             for sub in ('demos', 'tools')
             for p in sorted((REPO / 'adorym_tpu_torch' / sub).glob('*.py'))
             if p.stem != '__init__']
    assert len(names) >= 7 + 12, names
    code = (
        'import importlib, sys\n'
        "for m in ('jax', 'jaxlib', 'adorym_tpu'):\n"
        '    sys.modules[m] = None\n'
        f'for name in {names!r}:\n'
        '    importlib.import_module(name)\n'
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'adorym_tpu') and sys.modules[m] is not None]\n"
        'assert not bad, bad\n'
        "print('ok', len(" + repr(names) + '))\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith('ok')
