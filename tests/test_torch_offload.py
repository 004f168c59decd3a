"""Out-of-core on one device: the object's optimizer state kept on the host
(``offload_optimizer_state``, in y slabs under a first-order optimizer),
host-staged data, slabbed checkpoints, ``distribution_mode='shared_file'``
and the pipelined ``run_epochs``, against the JAX package
(``tests/test_offload.py``) on the same numpy inputs and against the
port's own resident run.

The port's offloaded runs equal its resident runs bit for bit (Adam is
elementwise, a slab's rows are the whole's rows).  Against the JAX package
trajectories are held under momentum (GD with a velocity, the first-order
optimizer with state that is linear in the gradient; plain GD has no state
to offload) at rtol 1e-5, from a start away from zero.  The mesh case of
``tests/test_offload.py`` runs on gloo ranks in
``tests/test_torch_mesh_offload.py``; its orbax round trips are npz round
trips here.
"""

import dataclasses

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
from adorym_tpu_torch import convert
from adorym_tpu_torch.io import checkpoint as ckpt_lib


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors (several test
    workers share the cores; with more threads the CPU's reductions are
    not reproducible bit for bit)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(mod=pt, optimizer='adam', offload=False, n=24, nz=None,
             update_scheme='immediate', rol=False, lr=1e-5, slabs=8,
             binning=1):
    """``tests/test_offload.py``'s problem in either package: an n^3
    object (n^2 x 1 in 2D), a 12^2 Gaussian probe on a grid at stride 6,
    two angles, minibatch 4."""
    nz = nz if nz is not None else n
    pn = 12
    two_d = nz == 1
    cfg = mod.ReconConfig(
        geometry=mod.Geometry(obj_size=(n, n, nz), probe_size=(pn, pn),
                              energy_ev=5000.0, psize_cm=1e-7,
                              free_prop_cm='inf', two_d_mode=two_d,
                              binning=binning),
        train=mod.TrainConfig(minibatch_size=4, learning_rate=lr,
                              optimizer=optimizer, seed=1,
                              update_scheme=update_scheme,
                              rotate_out_of_loop=rol),
        parallel=mod.ParallelConfig(offload_optimizer_state=offload,
                                    offload_slabs=slabs))
    rng = np.random.default_rng(5)
    obj_true = np.stack([rng.random((n, n, nz)) * 1e-3,
                         rng.random((n, n, nz)) * 3e-5], -1).astype(np.float32)
    probe = initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                             psize_cm=1e-7, probe_mag_sigma=3,
                             probe_phase_sigma=3, probe_phase_max=0.3)
    xs = np.arange(0, n - pn + 1, 6)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    theta_ls = np.zeros(1) if two_d else np.linspace(0, np.pi, 2,
                                                     endpoint=False)
    # The data of the geometry alone (under rotate_out_of_loop the JAX
    # package's model leaves the view rotation to its Reconstructor).
    data = np.asarray(simulate(_problem_cfg_jax(cfg), obj_true, probe, pos,
                               theta_ls))
    return cfg, obj_true, probe, pos, theta_ls, data


def _problem_cfg_jax(cfg):
    g = cfg.geometry
    return jcfg.ReconConfig(geometry=jcfg.Geometry(
        obj_size=g.obj_size, probe_size=g.probe_size, energy_ev=g.energy_ev,
        psize_cm=g.psize_cm, free_prop_cm='inf', two_d_mode=g.two_d_mode))


def _kw(pos, probe, theta_ls, obj0):
    return dict(probe_pos=pos, probe_init=probe, theta_ls=theta_ls,
                obj_init=obj0.copy())


@pytest.mark.parametrize('optimizer,scheme,rol', [
    ('adam', 'immediate', False),
    ('adam', 'per angle', True),     # the per-angle path
    ('momentum', 'immediate', False),
    ('curveball', 'immediate', False),   # second-order object state
])
def test_offloaded_state_matches_device_state(optimizer, scheme, rol):
    """Keeping the moments on the host does not change the math at all:
    objects and losses equal to the resident run's bit for bit, with the
    data host-staged in both runs (as the JAX test pins its epoch
    loop).  The offloaded state is host slabs (first order) or whole
    host arrays (Curveball)."""
    cfg, obj_true, probe, pos, theta_ls, data = _problem(
        pt, optimizer, update_scheme=scheme, rol=rol)
    runs = {}
    for off in (False, True):
        cfg_o = dataclasses.replace(
            cfg, parallel=pt.ParallelConfig(offload_optimizer_state=off))
        rec = pt.Reconstructor(cfg_o, data=data, device='cpu',
                               **_kw(pos, probe, theta_ls,
                                     np.zeros_like(obj_true)))
        rec._data_dev_ok = False
        losses = [rec.run_epoch(ep) for ep in range(3)]
        runs[off] = (rec.obj, losses, rec)
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]
    rec_off, rec_on = runs[True][2], runs[False][2]
    assert rec_off._off_state and not rec_on._off_state
    st = rec_off.opt_state['obj']
    if optimizer == 'curveball':
        assert not rec_off._off_slabbed and set(st) == {'z', 'lmbda'}
        assert all(torch.is_tensor(v) for v in st.values())
    else:
        assert rec_off._off_slabbed
        assert all(list(v) == [f's{i:02d}' for i in range(8)]
                   for v in st.values())
        # The slabs are views of one host block a leaf.
        for v in st.values():
            base = v['s00'].untyped_storage().data_ptr()
            assert all(s.untyped_storage().data_ptr() == base
                       for s in v.values())
    assert not any(isinstance(v, dict) for v in rec_on.opt_state['obj']
                   .values())


@pytest.mark.parametrize('scheme,rol', [('immediate', False),
                                        ('per angle', True)])
def test_offloaded_momentum_trajectory_matches_jax(scheme, rol):
    """Offloaded moments under momentum in both packages: losses at rtol
    1e-5, the object at 1e-5 of its largest value, after 3 epochs."""
    out = {}
    for mod, R, dev in ((jcfg, jrecon.Reconstructor, {}),
                        (pt, pt.Reconstructor, {'device': 'cpu'})):
        cfg, obj_true, probe, pos, theta_ls, data = _problem(
            mod, 'momentum', offload=True, update_scheme=scheme, rol=rol,
            lr=1e-6)
        rec = R(cfg, data=data, **_kw(pos, probe, theta_ls, obj_true * 0.5),
                **dev)
        assert rec._off_slabbed
        losses = [rec.run_epoch(ep) for ep in range(3)]
        obj = rec.obj if R is pt.Reconstructor else np.asarray(
            rec.params['obj'])
        out[mod] = (losses, obj)
    np.testing.assert_allclose(out[pt][0], out[jcfg][0], rtol=1e-5)
    ref = out[jcfg][1]
    np.testing.assert_allclose(out[pt][1], ref, atol=1e-5 * np.abs(ref).max())


def test_offload_with_mesh_raises():
    """Offload under a device mesh needs the mesh: the JAX test's
    configuration without a process group (no ``mesh=``) raises rather
    than run on one device.  The sharded moments themselves are held in
    ``tests/test_torch_mesh_offload.py::test_offload_with_sharded_object``
    on gloo ranks."""
    cfg, obj_true, probe, pos, theta_ls, data = _problem(
        update_scheme='per angle', rol=True)
    cfg = dataclasses.replace(cfg, parallel=pt.ParallelConfig(
        data_axis=4, object_axis=2, offload_optimizer_state=True))
    with pytest.raises(ValueError, match='device meshes'):
        pt.Reconstructor(cfg, data=data, device='cpu',
                         **_kw(pos, probe, theta_ls, np.zeros_like(obj_true)))


def test_npz_checkpoint_roundtrip(tmp_path):
    """The npz form keeps nested slab dicts under the JAX package's keys
    and gives them back; :func:`ckpt_lib.deslab_obj_state` joins them."""
    params = {'obj': {'s00': np.arange(6.0).reshape(2, 3),
                      's01': np.arange(6.0, 12.0).reshape(2, 3)},
              'probe': np.ones((2, 2))}
    state = {'obj': {'m': {'s00': np.zeros((2, 3)), 's01': np.ones((2, 3))},
                     'v': {'s00': np.full((2, 3), 2.0),
                           's01': np.full((2, 3), 3.0)}}}
    folder = str(tmp_path / 'ck')
    ckpt_lib.save_checkpoint(folder, params, state, 4, 7,
                             extra={'i_opt_batch': np.asarray(9)})
    with np.load(tmp_path / 'ck' / 'checkpoint.npz') as z:
        assert {'params/obj/s00', 'state/obj/m/s01'} <= set(z.files)
    r_params, r_state, i_epoch, i_batch, extra = \
        ckpt_lib.restore_checkpoint(folder)
    assert (i_epoch, i_batch) == (4, 7)
    assert int(extra['i_opt_batch']) == 9
    np.testing.assert_array_equal(ckpt_lib.deslab(r_params['obj']),
                                  np.arange(12.0).reshape(4, 3))
    whole = ckpt_lib.deslab_obj_state(r_state)['obj']
    np.testing.assert_array_equal(whole['v'], np.concatenate(
        [np.full((2, 3), 2.0), np.full((2, 3), 3.0)]))
    # Overwrite with newer state: restore sees the latest.
    ckpt_lib.save_checkpoint(folder, params, state, 5, 0)
    assert ckpt_lib.restore_checkpoint(folder)[2] == 5
    # Slab keys in numeric order past 100 slabs.
    assert ckpt_lib.slab_order(['s100', 's2', 's10']) == ['s2', 's10',
                                                          's100']


def test_npz_resume_matches_uninterrupted(tmp_path):
    """Kill-and-resume through the npz checkpoint of an offloaded run
    reproduces the uninterrupted trajectory."""
    cfg, obj_true, probe, pos, theta_ls, data = _problem(n=16, offload=True)
    cfg = dataclasses.replace(cfg, io=pt.IOConfig(
        store_checkpoint=True, use_checkpoint=True,
        n_batch_per_checkpoint=10_000))
    kw = dict(data=data, device='cpu',
              **_kw(pos, probe, theta_ls, np.zeros_like(obj_true)))
    straight = pt.Reconstructor(cfg, **kw)
    for ep in range(4):
        straight.run_epoch(ep)
    folder = str(tmp_path / 'run')
    first = pt.Reconstructor(cfg, output_folder=folder, **kw)
    for ep in range(2):
        first.run_epoch(ep)
    first.save_checkpoint(2, 0)
    resumed = pt.Reconstructor(cfg, output_folder=folder, **kw)
    assert resumed._start_epoch == 2 and resumed._off_slabbed
    for ep in range(2, 4):
        resumed.run_epoch(ep)
    np.testing.assert_array_equal(resumed.obj, straight.obj)


def test_slabbed_checkpoint_restores_into_any_config(tmp_path):
    """A checkpoint written under slab offload restores into a run without
    offload (and on, into another slab count): slab dicts are made whole
    on restore and split again for the run's configuration."""
    cfg, obj_true, probe, pos, theta_ls, data = _problem(n=16, offload=True)
    io_cfg = pt.IOConfig(store_checkpoint=True, use_checkpoint=True,
                         n_batch_per_checkpoint=10_000)
    kw = dict(data=data, device='cpu',
              **_kw(pos, probe, theta_ls, np.zeros_like(obj_true)))
    folder = str(tmp_path / 'run')
    cfg_off = dataclasses.replace(cfg, io=io_cfg)
    first = pt.Reconstructor(cfg_off, output_folder=folder, **kw)
    assert first._off_slabbed
    for ep in range(2):
        first.run_epoch(ep)
    first.save_checkpoint(2, 0)
    with np.load(tmp_path / 'run' / 'checkpoint' / 'checkpoint.npz') as z:
        assert 'state/obj/m/s07' in z.files and 'state/obj/m' not in z.files
    # Resume WITHOUT offload: the state arrives as whole arrays.
    cfg_on = dataclasses.replace(
        cfg, io=io_cfg,
        parallel=pt.ParallelConfig(offload_optimizer_state=False))
    resumed = pt.Reconstructor(cfg_on, output_folder=folder, **kw)
    assert resumed._start_epoch == 2
    m = resumed.opt_state['obj']['m']
    assert torch.is_tensor(m) and m.shape == resumed.params['obj'].shape
    # Into three slabs.
    cfg_3 = dataclasses.replace(cfg_off, parallel=pt.ParallelConfig(
        offload_optimizer_state=True, offload_slabs=3))
    resumed3 = pt.Reconstructor(cfg_3, output_folder=folder, **kw)
    assert list(resumed3.opt_state['obj']['v']) == ['s00', 's01', 's02']
    straight = pt.Reconstructor(cfg_off, **kw)
    for ep in range(4):
        straight.run_epoch(ep)
    for rec in (resumed, resumed3):
        for ep in range(2, 4):
            rec.run_epoch(ep)
        np.testing.assert_array_equal(rec.obj, straight.obj)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_slabbed_checkpoints_cross_packages(tmp_path, writer):
    """A slabbed checkpoint of one package resumes in the other (8 slabs
    written, 3 read, or the other way): the resumed run continues the
    writer's own continuation (momentum) at 1e-5 of the object's largest
    value."""
    runs = {}
    for mod, R, dev in ((jcfg, jrecon.Reconstructor, {}),
                        (pt, pt.Reconstructor, {'device': 'cpu'})):
        cfg, obj_true, probe, pos, theta_ls, data = _problem(
            mod, 'momentum', offload=True, n=16, lr=1e-6,
            slabs=8 if (mod is jcfg) == (writer == 'jax') else 3)
        cfg = dataclasses.replace(cfg, io=mod.IOConfig(
            store_checkpoint=True, use_checkpoint=True,
            n_batch_per_checkpoint=10_000))
        runs[mod] = (R, cfg, dict(data=data, **dev, **_kw(
            pos, probe, theta_ls, obj_true * 0.5)))
    w_mod, r_mod = (jcfg, pt) if writer == 'jax' else (pt, jcfg)
    folder = str(tmp_path / 'run')
    R, cfg, kw = runs[w_mod]
    first = R(cfg, output_folder=folder, **kw)
    first.run_epoch(0)
    first.save_checkpoint(1, 0)
    first.run_epoch(1)
    with np.load(tmp_path / 'run' / 'checkpoint' / 'checkpoint.npz') as z:
        assert 'state/obj/v/s07' in z.files
    R, cfg, kw = runs[r_mod]
    resumed = R(cfg, output_folder=folder, **kw)
    assert resumed._start_epoch == 1 and resumed._off_slabbed
    resumed.run_epoch(1)

    def obj(rec):
        return (rec.obj if isinstance(rec, pt.Reconstructor)
                else np.asarray(rec.params['obj']))
    ref = obj(first)
    np.testing.assert_allclose(obj(resumed), ref,
                               atol=1e-5 * np.abs(ref).max())


def test_params_from_jax_accepts_slabbed_state():
    """``convert.params_from_jax`` takes a JAX Reconstructor's offloaded
    (slabbed) parameters and state as whole tensors; ``params_to_numpy``
    keeps the port's slabs as slab dicts."""
    cfg, obj_true, probe, pos, theta_ls, data = _problem(
        jcfg, offload=True, n=16)
    jr = jrecon.Reconstructor(cfg, data=data, **_kw(
        pos, probe, theta_ls, obj_true * 0.5))
    jr.run_epoch(0)
    assert isinstance(jr.opt_state['obj']['m'], dict)
    params, state = convert.params_from_jax(jr.params, jr.opt_state,
                                            device='cpu')
    np.testing.assert_array_equal(params['obj'].numpy(),
                                  np.asarray(jr.params['obj']))
    m = np.concatenate([np.asarray(jr.opt_state['obj']['m'][k]) for k in
                        sorted(jr.opt_state['obj']['m'])])
    np.testing.assert_array_equal(state['obj']['m'].numpy(), m)
    host, _ = convert.params_from_jax(jr.params, None, device='cpu',
                                      host_obj=True)
    assert host['obj'].device.type == 'cpu'
    back, st = convert.params_to_numpy(
        {'obj': {'s00': params['obj'][:8], 's01': params['obj'][8:]}},
        {'obj': {'m': {'s00': state['obj']['m'][:8]}}})
    assert list(back['obj']) == ['s00', 's01']
    assert st['obj']['m']['s00'].shape == (8, 16, 16, 2)


def _capacity(monkeypatch, nbytes):
    """Both packages sized for a device of ``nbytes``."""
    monkeypatch.setattr(jprof, 'hbm_limit_bytes', lambda: nbytes)
    monkeypatch.setattr(tprof, 'hbm_limit_bytes',
                        lambda device=None: nbytes)


@pytest.mark.parametrize('scheme,rol', [('immediate', False),
                                        ('per angle', True)])
def test_host_staged_array_matches_resident(monkeypatch, scheme, rol):
    """A device too small for the dataset beside the working set (both
    packages' capacity patched to 1.2e6 bytes) stages the array's rows
    from the host in both: the port's trajectory equals its resident run
    (the same capacity, the dataset put on the device regardless) bit for
    bit, and the JAX package's at rtol 1e-5 (GD)."""
    cfg, obj_true, probe, pos, theta_ls, data = _problem(
        pt, 'gd', update_scheme=scheme, rol=rol)
    jc, *_ = _problem(jcfg, 'gd', update_scheme=scheme, rol=rol)
    kw = _kw(pos, probe, theta_ls, obj_true * 0.5)
    assert pt.Reconstructor(cfg, data=data, device='cpu', **kw)._data_dev_ok
    _capacity(monkeypatch, 1.2e6)
    resident = pt.Reconstructor(cfg, data=data, device='cpu', **kw)
    staged = pt.Reconstructor(cfg, data=data, device='cpu', **kw)
    jr = jrecon.Reconstructor(jc, data=data, **kw)
    assert not staged._data_dev_ok and not jr._data_dev_ok
    resident._data_dev_ok = True
    ref = [resident.run_epoch(ep) for ep in range(2)]
    losses = [staged.run_epoch(ep) for ep in range(2)]
    jl = [jr.run_epoch(ep) for ep in range(2)]
    assert resident.stager().resident and not staged.stager().resident
    assert staged.stager().staged_rows
    assert losses == ref
    np.testing.assert_array_equal(staged.obj, resident.obj)
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    j_obj = np.asarray(jr.params['obj'])
    np.testing.assert_allclose(staged.obj, j_obj,
                               atol=1e-5 * np.abs(j_obj).max())


def _epochs_problem(scheme):
    cfg, obj_true, probe, pos, theta_ls, data = _problem(
        pt, 'adam', n=16, update_scheme=scheme, rol=scheme == 'per angle')
    return cfg, dict(data=data, device='cpu', **_kw(
        pos, probe, theta_ls, np.zeros_like(obj_true)))


@pytest.mark.parametrize('scheme', ['immediate', 'per angle'])
def test_run_epochs_equals_run_epoch(scheme, monkeypatch):
    """``run_epochs(n)`` is n ``run_epoch`` calls (the same losses and
    object), with epoch r + 1 queued before epoch r's losses are
    fetched."""
    cfg, kw = _epochs_problem(scheme)
    seq = pt.Reconstructor(cfg, **kw)
    want = [seq.run_epoch(ep) for ep in range(3)]
    rec = pt.Reconstructor(cfg, **kw)
    order = []
    dispatch, finish = rec._epoch_dispatch, rec._epoch_finish
    monkeypatch.setattr(rec, '_epoch_dispatch',
                        lambda i, rng=None: (order.append(('d', i)),
                                             dispatch(i, rng))[1])
    monkeypatch.setattr(rec, '_epoch_finish',
                        lambda p, cb=None: (order.append(('f', p[0])),
                                            finish(p, cb))[1])
    assert rec.run_epochs(3) == want
    assert order == [('d', 0), ('d', 1), ('f', 0), ('d', 2), ('f', 1),
                     ('f', 2)]
    np.testing.assert_array_equal(rec.obj, seq.obj)
    assert rec.loss_history == seq.loss_history


def test_run_epochs_drains_for_checkpoints_and_callbacks(tmp_path):
    """With checkpoints (or a callback) every epoch is fetched before the
    next is queued, as in the JAX package; the trajectory is the same, the
    checkpoint after epoch r holds epoch r's state, and the default start
    is the resume's epoch."""
    cfg, kw = _epochs_problem('immediate')
    seq = pt.Reconstructor(cfg, **kw)
    want = [seq.run_epoch(ep) for ep in range(3)]
    ck = dataclasses.replace(cfg, io=pt.IOConfig(
        store_checkpoint=True, use_checkpoint=True,
        n_batch_per_checkpoint=10_000))
    folder = str(tmp_path / 'run')
    rec = pt.Reconstructor(ck, output_folder=folder, **kw)
    seen = []
    got = rec.run_epochs(2, callback=lambda e, b, loss: seen.append(e))
    assert got == want[:2] and sorted(set(seen)) == [0, 1]
    rec.save_checkpoint(2, 0)
    resumed = pt.Reconstructor(ck, output_folder=folder, **kw)
    assert resumed.run_epochs(1) == want[2:]
    np.testing.assert_array_equal(resumed.obj, seq.obj)


def test_shared_file_maps_to_offload(tmp_path, monkeypatch):
    """``distribution_mode='shared_file'`` runs in both packages as
    offloaded moments with ``offload_object='auto'``: at this size the
    object stays on the device, and on a device patched to 4e5 bytes
    'auto' keeps it on the host in both; the loss histories agree at
    rtol 1e-5 (momentum) and the port's equals its own run without the
    mode bit for bit where the object stays resident."""
    import adorym_tpu as jax_pkg
    from adorym_tpu.simulate import simulate_to_file
    cfg, obj_true, probe, pos, theta_ls, data = _problem(
        jcfg, binning=4)
    simulate_to_file(str(tmp_path / 'data.h5'), cfg, obj_true, probe, pos,
                     theta_ls)
    made = []
    orig = pt.Reconstructor.__init__

    def spy(self, *a, **k):
        orig(self, *a, **k)
        made.append(self)
    monkeypatch.setattr(pt.Reconstructor, '__init__', spy)
    params = dict(fname='data.h5', save_path=str(tmp_path),
                  output_folder=None, obj_size=(24, 24, 24), n_epochs=2,
                  learning_rate=1e-6, minibatch_size=3, optimizer='momentum',
                  probe_type='gaussian', probe_mag_sigma=3,
                  probe_phase_sigma=3, probe_phase_max=0.3, binning=4,
                  free_prop_cm='inf', theta_st=0, theta_end=np.pi,
                  alpha_d=None, alpha_b=None, gamma=0,
                  initial_guess=[obj_true[..., 0] * 0.5,
                                 obj_true[..., 1] * 0.5],
                  update_scheme='per angle', rotate_out_of_loop=True,
                  use_checkpoint=False, store_checkpoint=False)
    out = {}
    for cap in (None, 4e5):
        if cap is not None:
            _capacity(monkeypatch, cap)
        for mode in ('shared_file', None):
            out[cap, mode] = pt.reconstruct_ptychography(
                **params, distribution_mode=mode, device='cpu')
            rec = made[-1]
            assert rec._off_slabbed == (mode == 'shared_file')
            assert rec._obj_offloaded == (mode == 'shared_file'
                                          and cap is not None)
        jres = jax_pkg.reconstruct_ptychography(
            **params, distribution_mode='shared_file')
        np.testing.assert_allclose(out[cap, 'shared_file']['loss_history'],
                                   jres['loss_history'], rtol=1e-5)
        assert out[cap, 'shared_file']['obj'].shape == (24, 24, 24, 2)
    np.testing.assert_array_equal(out[None, 'shared_file']['obj'],
                                  out[None, None]['obj'])
