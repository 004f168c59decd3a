"""The object kept on the host (``offload_object``): y slabs in host
memory, each going up to be rotated and binned into the binned object and
again for its update with its moments' slabs, so the whole object is never
on the device; against the JAX package (``tests/test_offload_object.py``)
and against the port's resident run on the same numpy inputs.

The offloaded run equals the resident run bit for bit (rotation acts in
each y plane, Adam elementwise).  Against the JAX package trajectories are
held under momentum at rtol 1e-5.  The mesh cases of
``tests/test_offload_object.py`` run on gloo ranks in
``tests/test_torch_mesh_offload.py``.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import adorym_tpu.config as jcfg
import adorym_tpu.recon as jrecon
import adorym_tpu.utils.profiling as jprof
from adorym_tpu.simulate import simulate
from adorym_tpu.utils.initialize import initialize_probe
import adorym_tpu_torch as pt
import adorym_tpu_torch.utils.profiling as tprof


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors (several test
    workers share the cores; with more threads the CPU's reductions are
    not reproducible bit for bit)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed=0, n=32, nz=16, binning=4, mod=pt, **train):
    """``tests/test_offload_object.py``'s problem: a 32 x 32 x 16 object,
    an 8^2 probe on a 4x4 grid at stride 8, 3 angles, binning 4, Adam at
    1e-4 with non-negativity (``train`` overrides)."""
    pn = 8
    rng = np.random.default_rng(seed)
    obj_true = np.stack([rng.random((n, n, nz)) * 1e-3,
                         rng.random((n, n, nz)) * 3e-5], -1).astype(np.float32)
    probe = initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                             psize_cm=1e-7, probe_mag_sigma=2,
                             probe_phase_sigma=2, probe_phase_max=0.3)
    xs = np.arange(0, n - pn + 1, 8)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    theta_ls = np.linspace(0, np.pi, 3, endpoint=False)

    def cfg_of(m):
        kw = dict(minibatch_size=4, learning_rate=1e-4,
                  update_scheme='per angle', rotate_out_of_loop=True,
                  non_negativity=True, seed=seed)
        kw.update(train)
        return m.ReconConfig(
            geometry=m.Geometry(obj_size=(n, n, nz), probe_size=(pn, pn),
                                energy_ev=5000.0, psize_cm=1e-7,
                                free_prop_cm='inf', binning=binning),
            train=m.TrainConfig(**kw))
    # The data of the geometry alone (the JAX package's model leaves the
    # view rotation to its Reconstructor under rotate_out_of_loop).
    data = np.asarray(simulate(jcfg.ReconConfig(geometry=cfg_of(
        jcfg).geometry), obj_true, probe, pos, theta_ls))
    return cfg_of(mod), obj_true, probe, pos, theta_ls, data


def _kw(data, probe, pos, theta_ls, obj_true):
    return dict(data=data, probe_pos=pos, probe_init=probe,
                theta_ls=theta_ls, obj_init=(obj_true * 0.5).copy())


def _mk(cfg, kw, offload_object, slabs=4, R=None, **par):
    mod = pt if R is None else jcfg
    pcfg = mod.ParallelConfig(offload_optimizer_state=True,
                              offload_slabs=slabs,
                              offload_object=offload_object, **par)
    if R is None:
        return pt.Reconstructor(dc.replace(cfg, parallel=pcfg),
                                device='cpu', **kw)
    return R(dc.replace(cfg, parallel=pcfg), **kw)


def _obj(rec):
    return (rec.obj if isinstance(rec, pt.Reconstructor)
            else np.asarray(rec.obj))


def test_offloaded_object_trajectory_identical():
    """Host slabs equal the device-resident object bit for bit (the slabs'
    rotation and binning and their updates are the same math on the same
    rows), and they are views of one host block."""
    cfg, obj_true, probe, pos, theta_ls, data = _problem()
    kw = _kw(data, probe, pos, theta_ls, obj_true)
    rec_dev = _mk(cfg, kw, offload_object=False)
    rec_off = _mk(cfg, kw, offload_object=True)
    assert rec_off._obj_offloaded and not rec_dev._obj_offloaded
    assert isinstance(rec_off.params['obj'], dict)
    for ep in range(2):
        assert rec_dev.run_epoch(ep) == rec_off.run_epoch(ep)
    np.testing.assert_array_equal(rec_off.obj, rec_dev.obj)
    slabs = rec_off.params['obj']
    assert list(slabs) == ['s00', 's01', 's02', 's03']
    assert {v.device.type for v in slabs.values()} == {'cpu'}
    base = slabs['s00'].untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == base
               for v in slabs.values())
    assert rec_off.results()['obj'].shape == (32, 32, 16, 2)


def test_offloaded_object_trajectory_matches_jax():
    """Both packages with the object on the host (momentum): losses at
    rtol 1e-5 over 3 epochs, the object at 1e-5 of its largest value."""
    out = {}
    for mod, R in ((jcfg, jrecon.Reconstructor), (pt, None)):
        cfg, obj_true, probe, pos, theta_ls, data = _problem(
            mod=mod, optimizer='momentum', learning_rate=1e-6)
        rec = _mk(cfg, _kw(data, probe, pos, theta_ls, obj_true), True,
                  R=R)
        assert rec._obj_offloaded
        out[mod] = ([rec.run_epoch(ep) for ep in range(3)], _obj(rec))
    np.testing.assert_allclose(out[pt][0], out[jcfg][0], rtol=1e-5)
    ref = out[jcfg][1]
    np.testing.assert_allclose(out[pt][1], ref, atol=1e-5 * np.abs(ref).max())


def test_offloaded_object_checkpoint_roundtrip(tmp_path):
    """Checkpoints written with a slabbed object (``params/obj/s00``, ...)
    restore into offloaded and resident runs."""
    cfg, obj_true, probe, pos, theta_ls, data = _problem(seed=1)
    kw = _kw(data, probe, pos, theta_ls, obj_true)
    io_cfg = pt.IOConfig(store_checkpoint=True, use_checkpoint=True,
                         n_batch_per_checkpoint=1)
    pcfg = pt.ParallelConfig(offload_optimizer_state=True, offload_slabs=4,
                             offload_object=True)
    cfg_o = dc.replace(cfg, parallel=pcfg, io=io_cfg)
    folder = str(tmp_path / 'run')
    rec = pt.Reconstructor(cfg_o, output_folder=folder, device='cpu', **kw)
    assert rec._obj_offloaded
    rec.run_epoch(0)
    rec.save_checkpoint(1, 0)
    obj_after = rec.obj.copy()
    with np.load(tmp_path / 'run' / 'checkpoint' / 'checkpoint.npz') as z:
        assert {'params/obj/s00', 'params/obj/s03',
                'state/obj/m/s03'} <= set(z.files)
    # Resume offloaded.
    rec2 = pt.Reconstructor(cfg_o, output_folder=folder, device='cpu', **kw)
    assert rec2._obj_offloaded
    np.testing.assert_array_equal(rec2.obj, obj_after)
    # Resume WITHOUT object offload: the whole object on the device.
    pcfg3 = pt.ParallelConfig(offload_optimizer_state=True, offload_slabs=4)
    rec3 = pt.Reconstructor(dc.replace(cfg, parallel=pcfg3, io=io_cfg),
                            output_folder=folder, device='cpu', **kw)
    assert torch.is_tensor(rec3.params['obj'])
    np.testing.assert_array_equal(rec3.obj, obj_after)
    # Both continue alike.
    assert rec2.run_epoch(1) == rec3.run_epoch(1)
    np.testing.assert_array_equal(rec2.obj, rec3.obj)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_offloaded_object_checkpoint_crosses_packages(tmp_path, writer):
    """A checkpoint of an offloaded object written by one package resumes
    in the other (4 slabs written, 3 read) and continues as the writer
    does (momentum, 1e-5 of the largest value)."""
    runs = {}
    for mod, R in ((jcfg, jrecon.Reconstructor), (pt, None)):
        cfg, obj_true, probe, pos, theta_ls, data = _problem(
            seed=1, mod=mod, optimizer='momentum', learning_rate=1e-6)
        cfg = dc.replace(cfg, io=mod.IOConfig(
            store_checkpoint=True, use_checkpoint=True,
            n_batch_per_checkpoint=10_000))
        slabs = 4 if (mod is jcfg) == (writer == 'jax') else 3
        runs[mod] = (cfg, R, slabs, _kw(data, probe, pos, theta_ls,
                                        obj_true))
    w, r = (jcfg, pt) if writer == 'jax' else (pt, jcfg)
    folder = str(tmp_path / 'run')
    cfg, R, slabs, kw = runs[w]
    first = _mk(cfg, {**kw, 'output_folder': folder}, True, slabs, R=R)
    first.run_epoch(0)
    first.save_checkpoint(1, 0)
    first.run_epoch(1)
    with np.load(tmp_path / 'run' / 'checkpoint' / 'checkpoint.npz') as z:
        assert 'params/obj/s03' in z.files
    cfg, R, slabs, kw = runs[r]
    resumed = _mk(cfg, {**kw, 'output_folder': folder}, True, slabs, R=R)
    assert resumed._obj_offloaded and resumed._start_epoch == 1
    resumed.run_epoch(1)
    ref = _obj(first)
    np.testing.assert_allclose(_obj(resumed), ref,
                               atol=1e-5 * np.abs(ref).max())


def test_offload_object_requires_eligible_config():
    """``offload_object=True`` on an ineligible run raises with the
    reasons; 'auto' declines quietly."""
    cfg, obj_true, probe, pos, theta_ls, data = _problem(seed=2)
    kw = _kw(data, probe, pos, theta_ls, obj_true)
    bad = dc.replace(cfg, train=dc.replace(cfg.train,
                                           update_scheme='immediate',
                                           rotate_out_of_loop=False))
    with pytest.raises(ValueError, match='offload_object requires'):
        _mk(bad, kw, offload_object=True)
    rec = _mk(bad, kw, offload_object='auto')
    assert not rec._obj_offloaded


@pytest.mark.parametrize('change', [
    dict(train=dict(update_scheme='immediate', rotate_out_of_loop=False)),
    dict(parallel=dict(offload_optimizer_state=False)),
    dict(parallel=dict(offload_slabs=1)),
    dict(train=dict(exact_grad_rotation=True)),
    dict(loss=dict(gamma=1e-9)),
    dict(support=True),
    dict(train=dict(optimizer='cg')),
    dict(train=dict(n_batch_per_update=2)),
    dict(geometry=dict(binning=1)),
    dict(train=dict(optimizer='gd'))])
def test_ineligible_configs_raise_jax_message(change):
    """Each ineligible configuration raises the JAX package's
    ``ValueError``, word for word."""
    msgs = {}
    for mod, R in ((jcfg, jrecon.Reconstructor), (pt, None)):
        cfg, obj_true, probe, pos, theta_ls, data = _problem(
            seed=2, mod=mod, **change.get('train', {}))
        cfg = dc.replace(
            cfg, loss=dc.replace(cfg.loss, **change.get('loss', {})),
            geometry=dc.replace(cfg.geometry, **change.get('geometry', {})))
        kw = _kw(data, probe, pos, theta_ls, obj_true)
        if change.get('support'):
            kw['finite_support_mask'] = np.ones((32, 32, 16), np.float32)
        par = dict(offload_optimizer_state=True, offload_slabs=4)
        par.update(change.get('parallel', {}))
        pcfg = mod.ParallelConfig(offload_object=True, **par)
        with pytest.raises(ValueError) as e:
            if R is None:
                pt.Reconstructor(dc.replace(cfg, parallel=pcfg),
                                 device='cpu', **kw)
            else:
                R(dc.replace(cfg, parallel=pcfg), **kw)
        msgs[mod] = str(e.value)
    assert msgs[pt] == msgs[jcfg]
    assert msgs[pt].startswith('offload_object requires: ')


def test_auto_threshold_covers_oom_boundary(monkeypatch):
    """'auto' engages where the device-resident path stops fitting (the
    JAX package's measured boundary ratios: 736^3 fits on 15.75 GB, 768^3
    does not), and a comfortably fitting object stays on the device; the
    port's boundary is the JAX package's formula."""
    cfg, obj_true, probe, pos, theta_ls, data = _problem(seed=4)
    kw = _kw(data, probe, pos, theta_ls, obj_true)
    obj_bytes = obj_true.nbytes
    fit_ratio = 736 ** 3 * 8 / 15.75e9
    oom_ratio = 768 ** 3 * 8 / 15.75e9
    monkeypatch.setattr(tprof, 'hbm_limit_bytes',
                        lambda device=None: obj_bytes / oom_ratio)
    assert _mk(cfg, kw, offload_object='auto')._obj_offloaded
    assert (tprof.obj_offload_auto_bytes(15.75e9) / 15.75e9
            <= fit_ratio + 0.02)
    for hbm in (15.75e9, 85.0e9, 4e6):
        assert tprof.obj_offload_auto_bytes(hbm) == pytest.approx(
            jprof.obj_offload_auto_bytes(hbm), rel=1e-12)
    monkeypatch.setattr(tprof, 'hbm_limit_bytes',
                        lambda device=None: obj_bytes / (0.5 * fit_ratio))
    assert not _mk(cfg, kw, offload_object='auto')._obj_offloaded


def test_auto_forced_on_both_sides(monkeypatch):
    """Both packages' capacity patched so that the object passes the
    'auto' boundary: both keep it on the host, with the same gradient
    chunks; the port's 'auto' run equals its ``True`` run bit for bit and
    the JAX package's at rtol 1e-5 (momentum)."""
    cap = 2e5
    monkeypatch.setattr(jprof, 'hbm_limit_bytes', lambda: cap)
    monkeypatch.setattr(tprof, 'hbm_limit_bytes', lambda device=None: cap)
    out = {}
    for mod, R in ((jcfg, jrecon.Reconstructor), (pt, None)):
        cfg, obj_true, probe, pos, theta_ls, data = _problem(
            mod=mod, optimizer='momentum', learning_rate=1e-6)
        kw = _kw(data, probe, pos, theta_ls, obj_true)
        rec = _mk(cfg, kw, 'auto', R=R)
        assert rec._obj_offloaded
        out[mod] = ([rec.run_epoch(ep) for ep in range(2)], _obj(rec),
                    rec._fuse_g)
    forced = _mk(cfg, kw, True)
    assert [forced.run_epoch(ep) for ep in range(2)] == out[pt][0]
    np.testing.assert_array_equal(forced.obj, out[pt][1])
    assert out[pt][2] == out[jcfg][2]
    np.testing.assert_allclose(out[pt][0], out[jcfg][0], rtol=1e-5)
    ref = out[jcfg][1]
    np.testing.assert_allclose(out[pt][1], ref, atol=1e-5 * np.abs(ref).max())


def test_object_offload_budgets_the_binned_object():
    """Under object offload the gradient-chunk budget counts the binned
    object only (the JAX package's ``_obj_off_likely``), so the chunk can
    grow; both packages give the same chunk."""
    out = {}
    for mod, R in ((jcfg, jrecon.Reconstructor), (pt, None)):
        cfg, obj_true, probe, pos, theta_ls, data = _problem(mod=mod)
        kw = _kw(data, probe, pos, theta_ls, obj_true)
        out[mod] = (_mk(cfg, kw, True, R=R), _mk(cfg, kw, False, R=R))
    for mod in out:
        assert out[mod][0]._fuse_g >= out[mod][1]._fuse_g
    assert out[pt][0]._obj_off_likely and not out[pt][1]._obj_off_likely
    assert out[pt][0]._fuse_g == out[jcfg][0]._fuse_g


@pytest.mark.parametrize('stream', ['on', 'off'])
def test_streamed_rotate_back_by_slab(stream):
    """Offloaded moments under the streaming rotation make each slab's
    full-depth gradient from the binned gradient's rows just before its
    update: the trajectory equals the resident moments' run bit for bit,
    and (momentum) the JAX package's at rtol 1e-5."""
    out = {}
    for mod, R in ((jcfg, jrecon.Reconstructor), (pt, None)):
        cfg, obj_true, probe, pos, theta_ls, data = _problem(
            mod=mod, optimizer='momentum', learning_rate=1e-6,
            stream_rotation=stream)
        kw = _kw(data, probe, pos, theta_ls, obj_true)
        rec = _mk(cfg, kw, False, R=R)
        assert rec._off_slabbed
        out[mod] = ([rec.run_epoch(ep) for ep in range(2)], _obj(rec))
    cfg, obj_true, probe, pos, theta_ls, data = _problem(
        optimizer='momentum', learning_rate=1e-6, stream_rotation=stream)
    res = pt.Reconstructor(cfg, device='cpu',
                           **_kw(data, probe, pos, theta_ls, obj_true))
    assert res._stream_rot == (stream == 'on') and not res._off_state
    assert [res.run_epoch(ep) for ep in range(2)] == out[pt][0]
    np.testing.assert_array_equal(res.obj, out[pt][1])
    np.testing.assert_allclose(out[pt][0], out[jcfg][0], rtol=1e-5)
    ref = out[jcfg][1]
    np.testing.assert_allclose(out[pt][1], ref, atol=1e-5 * np.abs(ref).max())
