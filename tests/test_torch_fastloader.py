"""The port's binding of the native batch loader
(``adorym_tpu_torch/io/fastloader.py``) against the JAX package's binding
of the same source and against numpy: the synchronous gather, the
double-buffered prefetch, the HDF5 conversion, a missing file, and a
per-angle epoch whose data come through a loader, against the port's
in-memory run and the JAX package's loader run.  The port builds the
library under ``build/`` (never into ``native/``) and raises where it
cannot; the tests need ``g++``, which the JAX binding needs too."""

import numpy as np
import pytest
import torch

import adorym_tpu.config as jcfg
import adorym_tpu.recon as jrecon
from adorym_tpu.io import fastloader as jfl
from adorym_tpu.simulate import simulate
from adorym_tpu.utils.initialize import initialize_probe
import adorym_tpu_torch as pt
from adorym_tpu_torch.io import fastloader


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors (several test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def raw_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp('fastloader')
    rng = np.random.default_rng(0)
    data = rng.random((3, 20, 8, 8)).astype(np.float32)
    raw = str(root / 'data.raw')
    data.tofile(raw)
    return raw, data


def test_library_builds_outside_native():
    assert fastloader.available()
    path = fastloader._lib_path()
    assert path.exists() and path.parent == fastloader.BUILD_DIR
    assert 'native' not in path.parts


def test_sync_gather_matches_numpy(raw_dataset):
    raw, data = raw_dataset
    ld = fastloader.FastLoader(raw, data.shape)
    idx = [3, 17, 0, 9]
    out = ld.gather(1, idx)
    np.testing.assert_array_equal(out, data[1][idx])
    # Into a caller's buffer (the stager's staging buffer), as the JAX
    # package's binding reads the same rows.
    buf = np.zeros((6, 8, 8), np.float32)
    ld.gather(2, idx, out=buf)
    np.testing.assert_array_equal(buf[:4], data[2][idx])
    jl = jfl.FastLoader(raw, data.shape)
    np.testing.assert_array_equal(jl.gather(1, idx), out)
    jl.close()
    ld.close()


def test_async_prefetch(raw_dataset):
    raw, data = raw_dataset
    ld = fastloader.FastLoader(raw, data.shape, n_slots=2)
    idx_a = [0, 5, 10]
    idx_b = [1, 2, 3, 4]
    ld.prefetch(0, 0, idx_a)
    ld.prefetch(1, 2, idx_b)
    np.testing.assert_array_equal(ld.get(0, len(idx_a)), data[0][idx_a])
    np.testing.assert_array_equal(ld.get(1, len(idx_b)), data[2][idx_b])
    # Reuse slots
    ld.prefetch(0, 1, idx_b)
    np.testing.assert_array_equal(ld.get(0, len(idx_b)), data[1][idx_b])
    ld.close()


def test_h5_conversion(raw_dataset, tmp_path):
    raw, data = raw_dataset
    from adorym_tpu_torch.io.data import write_data_file
    h5 = str(tmp_path / 'd.h5')
    write_data_file(h5, data)
    raw2 = str(tmp_path / 'd.raw')
    shape = fastloader.convert_h5_to_raw(h5, raw2)
    assert tuple(shape) == data.shape
    ld = fastloader.FastLoader(raw2, shape)
    np.testing.assert_allclose(ld.gather(0, [0]), np.abs(data[0][[0]]))
    ld.close()


def test_open_missing_file_fails():
    with pytest.raises(RuntimeError):
        fastloader.FastLoader('/nonexistent/file.raw', (1, 1, 4, 4))


def test_out_of_range_rows_and_oversized_batches_raise(raw_dataset):
    raw, data = raw_dataset
    ld = fastloader.FastLoader(raw, data.shape, max_batch=4)
    with pytest.raises(IndexError):
        ld.gather(0, [20])
    with pytest.raises(ValueError, match='slots'):
        ld.prefetch(0, 0, list(range(5)))
    ld.close()
    with pytest.raises(RuntimeError, match='closed'):
        ld.gather(0, [0])


def _angle_problem():
    n, pn = 24, 12
    rng = np.random.default_rng(0)
    obj_true = np.stack([rng.random((n, n, n)) * 1e-3,
                         rng.random((n, n, n)) * 3e-5], -1).astype(np.float32)
    probe = initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                             psize_cm=1e-7, probe_mag_sigma=3,
                             probe_phase_sigma=3, probe_phase_max=0.3)
    xs = np.arange(0, n - pn + 1, 6)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    theta_ls = np.linspace(0, np.pi, 3, endpoint=False)

    def cfg(mod, **train):
        return mod.ReconConfig(
            geometry=mod.Geometry(obj_size=(n, n, n), probe_size=(pn, pn),
                                  energy_ev=5000.0, psize_cm=1e-7,
                                  free_prop_cm='inf', binning=4),
            train=mod.TrainConfig(minibatch_size=3, learning_rate=1e-5,
                                  seed=7, **train))
    data = simulate(cfg(jcfg, update_scheme='per angle',
                        rotate_out_of_loop=True),
                    obj_true, probe, pos, theta_ls)
    return cfg, obj_true, probe, pos, theta_ls, np.asarray(data)


@pytest.mark.parametrize('scheme', ['per angle', 'immediate'])
def test_angle_fused_epoch_with_loader(tmp_path, scheme):
    """Data read through a FastLoader (per angle: each angle's rows
    gathered at once; immediate: each batch through the double-buffered
    prefetch) give the in-memory run's trajectory exactly, and the JAX
    package's loader run's within 1e-5 (GD)."""
    cfg, obj_true, probe, pos, theta_ls, data = _angle_problem()
    raw = str(tmp_path / 'data.raw')
    np.ascontiguousarray(data, np.float32).tofile(raw)
    train = dict(update_scheme=scheme, optimizer='gd',
                 rotate_out_of_loop=scheme != 'immediate')
    # A start away from zero (at a zero object the probe's far-field
    # tails underflow and both packages' gradients are f32 noise there).
    kw = dict(probe_pos=pos, probe_init=probe, theta_ls=theta_ls,
              obj_init=obj_true * 0.5)

    def run(src, mod=pt, R=pt.Reconstructor, **dev):
        rec = R(cfg(mod, **train), data=src, **kw, **dev)
        return rec, [rec.run_epoch(ep) for ep in range(2)]

    ld = fastloader.FastLoader(raw, data.shape, max_batch=16)
    rec_mem, losses_mem = run(data, device='cpu')
    rec_ld, losses_ld = run(ld, device='cpu')
    assert rec_mem.stager().resident and not rec_ld.stager().resident
    assert rec_ld.data is None and rec_ld.stager().staged_rows > 0
    assert losses_ld == losses_mem
    np.testing.assert_array_equal(rec_ld.obj, rec_mem.obj)
    jl = jfl.FastLoader(raw, data.shape)
    rec_j, losses_j = run(jl, jcfg, jrecon.Reconstructor)
    np.testing.assert_allclose(losses_ld, losses_j, rtol=1e-5)
    ref = np.asarray(rec_j.params['obj'])
    np.testing.assert_allclose(rec_ld.obj, ref,
                               atol=1e-5 * np.abs(ref).max())
    ld.close()
    jl.close()


def test_loader_rows_equal_the_array_rows(raw_dataset):
    """The stager's two ways to the rows agree with numpy: through the
    loader's gather, through its prefetch feed, and from the array."""
    from adorym_tpu_torch.offload import DataStager, HostArena
    raw, data = raw_dataset
    dev = torch.device('cpu')
    ld = fastloader.FastLoader(raw, data.shape, max_batch=5)
    rows = [(1, np.array([3, 4, 19])), (0, np.array([0, 1, 2, 3, 4])),
            (2, np.array([7])), (2, np.array([8, 6]))]
    for src, loader in ((None, ld), (data, None)):
        st = DataStager(src, loader, dev, False, HostArena(dev))
        inds = np.array([[2, 5], [9, 11]])
        np.testing.assert_array_equal(st.rows(1, inds).numpy(),
                                      data[1][inds])
        feed = st.feed(rows)
        for i in range(1, len(rows)):
            got = feed.take(i)
            feed.ahead(i + 1)
            np.testing.assert_array_equal(got.numpy(),
                                          data[rows[i][0]][rows[i][1]])
    ld.close()


def test_resident_stager_needs_an_array():
    from adorym_tpu_torch.offload import DataStager, HostArena
    dev = torch.device('cpu')
    with pytest.raises(ValueError, match='loader'):
        DataStager(None, object(), dev, True, HostArena(dev))
    st = DataStager(np.zeros((1, 2, 3, 3), np.float32), None, dev, False,
                    HostArena(dev))
    with pytest.raises(RuntimeError, match='host'):
        st.dataset()

