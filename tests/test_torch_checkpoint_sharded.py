"""The sharded checkpoint form (``use_orbax=True``, ``checkpoint/dcp/``
through ``torch.distributed.checkpoint``) on one device: the counterparts
of ``tests/test_offload.py``'s orbax tests, resumes on every path that
writes a checkpoint, the commit's atomicity, which form a folder restores,
object and moment offload, and reads by object rows.  The mesh cases are
``tests/test_torch_mesh_checkpoint.py``.

Tolerances: a resume through the sharded form equals the uninterrupted run
at atol 1e-7 (as ``tests/test_offload.py`` holds the JAX package's orbax
resume); offloaded runs equal the npz form's bit for bit; under GD the
port's resumed object is held against the JAX package's own orbax resume
at 1e-5 of its largest value.  The JAX package cannot resume a GD run
(its restored optimizer state lacks the object's empty GD state, ROADMAP
C): the JAX run gets that empty state back before its resumed epochs."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import adorym_tpu.config as jcfg
import adorym_tpu.recon as jrecon
import adorym_tpu_torch as pt
from adorym_tpu_torch import convert
from adorym_tpu_torch.io import checkpoint as ckpt_lib
from test_torch_offload import _kw
from test_torch_offload import _problem as _offload_problem
from test_torch_offload_object import _problem as _object_problem


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors (several test
    workers share the cores; with more threads the CPU's reductions are
    not reproducible bit for bit)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


IO = dict(store_checkpoint=True, use_checkpoint=True,
          n_batch_per_checkpoint=10_000)


def _with_io(cfg, mod=pt, **io):
    return dataclasses.replace(cfg, io=mod.IOConfig(**{**IO, **io}))


def _jax_cfg(cfg, **io):
    """The JAX package's config of a port config's sections."""
    def sec(name):
        return getattr(jcfg, type(getattr(cfg, name)).__name__)(
            **dataclasses.asdict(getattr(cfg, name)))
    return jcfg.ReconConfig(geometry=sec('geometry'), train=sec('train'),
                            parallel=sec('parallel'),
                            io=jcfg.IOConfig(**{**IO, **io}))


def _resume(cfg, kw, folder, n_first=2, n_total=4):
    """A run of ``n_first`` epochs that checkpoints at its end, then a run
    that resumes from it to ``n_total``; returns the resumed run."""
    first = pt.Reconstructor(cfg, output_folder=folder, device='cpu', **kw)
    for ep in range(n_first):
        first.run_epoch(ep)
    first.save_checkpoint(n_first, 0)
    resumed = pt.Reconstructor(cfg, output_folder=folder, device='cpu', **kw)
    assert resumed._start_epoch == n_first
    for ep in range(n_first, n_total):
        resumed.run_epoch(ep)
    return resumed


def _straight(cfg, kw, n_total=4):
    rec = pt.Reconstructor(cfg, device='cpu', **kw)
    for ep in range(n_total):
        rec.run_epoch(ep)
    return rec


# -- the form -------------------------------------------------------------

def _tree():
    rng = np.random.default_rng(3)
    obj = rng.normal(size=(12, 4, 3, 2)).astype(np.float32)
    m = rng.normal(size=(12, 4, 3, 2)).astype(np.float32)
    return obj, m


def _items(obj, m, table):
    items = {'params/probe': np.ones((1, 2, 2, 2), np.float32),
             'state/obj/first': np.asarray(True)}
    for i, (lo, hi) in enumerate(table):
        items[f'params/obj/s{i:02d}'] = torch.as_tensor(obj[lo:hi])
        items[f'state/obj/m/s{i:02d}'] = torch.as_tensor(m[lo:hi])
    return items


def test_sharded_round_trip(tmp_path):
    """The counterpart of ``test_orbax_checkpoint_roundtrip``: the tree,
    the counters and ``extra`` read back equal, the slabs joined by
    ``convert.load_checkpoint``; a second save at (5, 0) is the one
    restored, and the first's folder is gone."""
    obj, m = _tree()
    table = np.asarray([(0, 5), (5, 12)])
    folder = str(tmp_path / 'ck')
    path = ckpt_lib.save_sharded(folder, _items(obj, m, table), 4, 7,
                                 extra={'i_opt_batch': np.asarray(9),
                                        'obj_slab_rows': table})
    assert path == os.path.join(folder, 'dcp')
    params, state, i_epoch, i_batch, extra = ckpt_lib.restore_checkpoint(
        folder)
    assert (i_epoch, i_batch) == (4, 7) and int(extra['i_opt_batch']) == 9
    assert sorted(params['obj']) == ['s00', 's01']
    np.testing.assert_array_equal(ckpt_lib.deslab(params['obj']), obj)
    np.testing.assert_array_equal(ckpt_lib.deslab(state['obj']['m']), m)
    assert state['obj']['first'].dtype == np.bool_ and state['obj']['first']
    ck = convert.load_checkpoint(folder, device='cpu')
    np.testing.assert_array_equal(ck['params']['obj'].numpy(), obj)
    assert ck['i_opt_batch'] == 9 and ck['extra'] == {}
    ckpt_lib.save_sharded(folder, _items(obj * 2, m, table), 5, 0,
                          extra={'obj_slab_rows': table})
    assert ckpt_lib.restore_checkpoint(folder)[2] == 5
    assert sorted(os.listdir(folder)) == ['dcp']


@pytest.mark.parametrize('rows', [(5, 12), (3, 8), (0, 2)])
def test_rows_read_only_their_slabs(tmp_path, rows):
    """``rows=(y0, y1)`` reads the slabs that overlap the rows and cuts
    them; the npz form's rows are the same arrays."""
    obj, m = _tree()
    table = np.asarray([(0, 5), (5, 12)])
    ckpt_lib.save_sharded(str(tmp_path / 'a'), _items(obj, m, table), 1, 0,
                          extra={'obj_slab_rows': table})
    ckpt_lib.save_checkpoint(str(tmp_path / 'b'), {'obj': obj},
                             {'obj': {'m': m}}, 1, 0)
    got = ckpt_lib.restore_sharded(str(tmp_path / 'a'), rows=rows)
    want = [k for k, (lo, hi) in zip(('s00', 's01'), table)
            if lo < rows[1] and rows[0] < hi]
    assert sorted(got[0]['obj']) == want
    assert sorted(got[1]['obj']['m']) == want
    for folder in ('a', 'b'):
        ck = convert.load_checkpoint(str(tmp_path / folder), device='cpu',
                                     rows=rows)
        np.testing.assert_array_equal(ck['params']['obj'].numpy(),
                                      obj[rows[0]:rows[1]])
        np.testing.assert_array_equal(ck['opt_state']['obj']['m'].numpy(),
                                      m[rows[0]:rows[1]])


def test_forms_detected(tmp_path):
    """A folder with both forms restores the sharded one (as the JAX
    package reads orbax first); a JAX orbax folder alone raises, naming
    the converter; an empty folder holds no checkpoint."""
    obj, m = _tree()
    table = np.asarray([(0, 12)])
    folder = str(tmp_path / 'ck')
    ckpt_lib.save_checkpoint(folder, {'obj': obj}, {}, 1, 0)
    ckpt_lib.save_sharded(folder, _items(obj, m, table), 3, 0,
                          extra={'obj_slab_rows': table})
    assert ckpt_lib.restore_checkpoint(folder)[2] == 3
    (tmp_path / 'jax' / 'orbax').mkdir(parents=True)
    with pytest.raises(NotImplementedError, match='tools/orbax_to_npz.py'):
        ckpt_lib.restore_checkpoint(str(tmp_path / 'jax'))
    assert ckpt_lib.restore_checkpoint(str(tmp_path / 'none')) is None


def test_npz_checkpoint_removes_an_older_sharded_one(tmp_path):
    """A run that checkpoints with ``use_orbax=True`` and is resumed with
    ``use_orbax=False``: its npz checkpoint removes the older sharded form,
    which a restore would read first, so the next resume starts from the
    npz checkpoint."""
    rec, folder = _small_run(tmp_path)
    rec.run_epoch(0)
    rec.save_checkpoint(1, 0)
    ck = os.path.join(folder, 'checkpoint')
    assert os.path.isdir(os.path.join(ck, 'dcp'))
    cfg, kw = _small_problem(use_orbax=False)
    npz = pt.Reconstructor(cfg, output_folder=folder, device='cpu', **kw)
    assert npz._start_epoch == 1
    npz.run_epoch(1)
    npz.save_checkpoint(2, 0)
    assert sorted(os.listdir(ck)) == ['checkpoint.npz']
    again = pt.Reconstructor(cfg, output_folder=folder, device='cpu', **kw)
    assert again._start_epoch == 2


# -- resumes ---------------------------------------------------------------

RESUMES = {
    'immediate': dict(optimizer='adam'),
    'per_angle': dict(optimizer='adam', update_scheme='per angle',
                      rol=True),
    'accumulate': dict(optimizer='adam', update_scheme='per angle'),
    'immediate_cg': dict(optimizer='cg'),
    'per_angle_curveball': dict(optimizer='curveball',
                                update_scheme='per angle', rol=True),
}


@pytest.mark.parametrize('path', list(RESUMES))
def test_resume_matches_uninterrupted(tmp_path, path):
    """The counterpart of ``test_orbax_resume_matches_uninterrupted``, on
    the immediate, per-angle and accumulate paths and under the
    second-order optimizers (their state's scalars and flags included):
    two epochs, a sharded checkpoint, two resumed epochs equal four
    uninterrupted ones."""
    cfg, obj_true, probe, pos, theta_ls, data = _offload_problem(
        pt, n=16, **RESUMES[path])
    cfg = _with_io(cfg, use_orbax=True)
    kw = dict(data=data, **_kw(pos, probe, theta_ls, obj_true * 0.5))
    straight = _straight(cfg, kw)
    resumed = _resume(cfg, kw, str(tmp_path / 'run'))
    assert (tmp_path / 'run' / 'checkpoint' / 'dcp' / '.metadata').is_file()
    assert not (tmp_path / 'run' / 'checkpoint' / 'checkpoint.npz').exists()
    np.testing.assert_allclose(resumed.obj, straight.obj, atol=1e-7)
    assert resumed.i_opt_batch == straight.i_opt_batch


@pytest.mark.parametrize('scheme', ['immediate', 'per angle'])
def test_gd_resume_matches_jax_orbax_resume(tmp_path, scheme):
    """Under GD, on the same numpy inputs, the port's resume through its
    sharded form and the JAX package's resume through orbax: the objects
    within 1e-5 of the largest value."""
    rol = scheme == 'per angle'
    cfg, obj_true, probe, pos, theta_ls, data = _offload_problem(
        pt, 'gd', n=16, update_scheme=scheme, rol=rol)
    kw = dict(data=data, **_kw(pos, probe, theta_ls, obj_true * 0.5))
    port = _resume(_with_io(cfg, use_orbax=True), kw, str(tmp_path / 'pt'))
    jc = _jax_cfg(cfg, use_orbax=True)
    folder = str(tmp_path / 'jax')
    first = jrecon.Reconstructor(jc, output_folder=folder, **kw)
    for ep in range(2):
        first.run_epoch(ep)
    first.save_checkpoint(2, 0)
    assert (tmp_path / 'jax' / 'checkpoint' / 'orbax').is_dir()
    resumed = jrecon.Reconstructor(jc, output_folder=folder, **kw)
    assert resumed._start_epoch == 2
    for k in resumed.specs:
        resumed.opt_state.setdefault(k, {})
    for ep in range(2, 4):
        resumed.run_epoch(ep)
    want = np.asarray(resumed.params['obj'])
    assert np.abs(port.obj - want).max() <= 1e-5 * np.abs(want).max()


# -- atomicity and failures -------------------------------------------------

def _small_problem(use_orbax=True):
    cfg, obj_true, probe, pos, theta_ls, data = _offload_problem(
        pt, 'adam', n=16)
    return (_with_io(cfg, use_orbax=use_orbax),
            dict(data=data, **_kw(pos, probe, theta_ls, obj_true * 0.5)))


def _small_run(tmp_path):
    cfg, kw = _small_problem()
    folder = str(tmp_path / 'run')
    return pt.Reconstructor(cfg, output_folder=folder, device='cpu',
                            **kw), folder


def test_uncommitted_write_is_ignored(tmp_path, monkeypatch):
    """A crash after the ranks' writes and before the commit's renames
    leaves ``dcp.tmp/``, which never restores: the previous checkpoint
    does, also where a commit stopped between its two renames
    (``dcp.old/`` alone); the next save clears both."""
    rec, folder = _small_run(tmp_path)
    rec.run_epoch(0)
    rec.save_checkpoint(1, 0)
    ck = os.path.join(folder, 'checkpoint')

    def crash(_):
        raise KeyboardInterrupt('killed before the commit')
    monkeypatch.setattr(ckpt_lib, '_commit', crash)
    rec.run_epoch(1)
    with pytest.raises(KeyboardInterrupt):
        rec.save_checkpoint(2, 0)
    monkeypatch.undo()
    assert os.path.isfile(os.path.join(ck, 'dcp.tmp', '.metadata'))
    assert ckpt_lib.restore_checkpoint(ck)[2] == 1
    os.replace(os.path.join(ck, 'dcp'), os.path.join(ck, 'dcp.old'))
    assert ckpt_lib.restore_checkpoint(ck)[2] == 1
    assert convert.load_checkpoint(ck, device='cpu')['i_epoch'] == 1
    rec.save_checkpoint(2, 0)
    assert sorted(os.listdir(ck)) == ['dcp']
    assert ckpt_lib.restore_checkpoint(ck)[2] == 2


def test_failed_write_raises_without_fallback(tmp_path, monkeypatch):
    """A write that fails raises: no npz form is written instead, and the
    previous sharded checkpoint stays the one that restores."""
    import torch.distributed.checkpoint as dcp
    rec, folder = _small_run(tmp_path)
    rec.run_epoch(0)
    rec.save_checkpoint(1, 0)

    def fail(*a, **k):
        raise OSError('disk full')
    monkeypatch.setattr(dcp, 'save', fail)
    with pytest.raises(OSError, match='disk full'):
        rec.save_checkpoint(2, 0)
    monkeypatch.undo()
    ck = os.path.join(folder, 'checkpoint')
    assert not os.path.exists(os.path.join(ck, 'checkpoint.npz'))
    assert ckpt_lib.restore_checkpoint(ck)[2] == 1


# -- offload -----------------------------------------------------------------

def _offload_cfg(cfg, offload_object, use_orbax):
    return _with_io(dataclasses.replace(cfg, parallel=pt.ParallelConfig(
        offload_optimizer_state=True, offload_slabs=4,
        offload_object=offload_object)), use_orbax=use_orbax)


def test_offloaded_write_takes_the_host_slabs(tmp_path, monkeypatch):
    """Under object and moment offload the write is handed each host
    slab as it lies (the slab views of the host blocks), one key a slab,
    with the slab table; ``torch.distributed.checkpoint`` gets tensors
    over the same memory, each no larger than its slab (so it copies
    nothing)."""
    import torch.distributed.checkpoint as dcp
    cfg, obj_true, probe, pos, theta_ls, data = _object_problem()
    kw = dict(data=data, **_kw(pos, probe, theta_ls, obj_true * 0.5))
    rec = pt.Reconstructor(_offload_cfg(cfg, True, True), device='cpu',
                           output_folder=str(tmp_path / 'run'), **kw)
    assert rec._obj_offloaded and rec._off_slabbed
    rec.run_epoch(0)
    seen = {}
    save = ckpt_lib.save_sharded

    def spy(folder, items, *a, **k):
        seen.update(items=items, extra=k['extra'])
        return save(folder, items, *a, **k)
    monkeypatch.setattr(ckpt_lib, 'save_sharded', spy)
    dcp_save = dcp.save

    def dcp_spy(state, **k):
        seen['state'] = dict(state)
        return dcp_save(state, **k)
    monkeypatch.setattr(dcp, 'save', dcp_spy)
    rec.save_checkpoint(1, 0)
    items = seen['items']
    host = {'params/obj': rec.params['obj'],
            **{f'state/obj/{n}': a for n, a in rec.opt_state['obj'].items()}}
    for name, slabs in host.items():
        assert list(slabs) == ['s00', 's01', 's02', 's03']
        for key, view in slabs.items():
            assert items[f'{name}/{key}'] is view
            t = seen['state'][f'{name}/{key}']
            assert t.data_ptr() == view.data_ptr()
            assert t.untyped_storage().nbytes() == view.nbytes
    np.testing.assert_array_equal(seen['extra']['obj_slab_rows'],
                                  [[0, 8], [8, 16], [16, 24], [24, 32]])


@pytest.mark.parametrize('into', ['resident', 'offloaded'])
def test_offloaded_checkpoint_restores_anywhere(tmp_path, into):
    """An offloaded run's sharded checkpoint resumes into a resident run
    and into an offloaded one, each bit-equal to the same resume through
    the npz form, and equal to the uninterrupted run."""
    cfg, obj_true, probe, pos, theta_ls, data = _object_problem()
    kw = dict(data=data, **_kw(pos, probe, theta_ls, obj_true * 0.5))
    out = {}
    for orbax in (True, False):
        folder = str(tmp_path / f'orbax{orbax}')
        first = pt.Reconstructor(_offload_cfg(cfg, True, orbax),
                                 device='cpu', output_folder=folder, **kw)
        for ep in range(2):
            first.run_epoch(ep)
        first.save_checkpoint(2, 0)
        if into == 'resident':
            cfg2 = _with_io(cfg, use_orbax=orbax)
        else:
            cfg2 = _offload_cfg(cfg, True, orbax)
        rec = pt.Reconstructor(cfg2, device='cpu', output_folder=folder,
                               **kw)
        assert rec._start_epoch == 2
        assert rec._obj_offloaded == (into == 'offloaded')
        losses = [rec.run_epoch(ep) for ep in (2, 3)]
        out[orbax] = (losses, rec.obj)
    assert out[True][0] == out[False][0]
    np.testing.assert_array_equal(out[True][1], out[False][1])
    straight = _straight(_offload_cfg(cfg, True, False), kw)
    np.testing.assert_allclose(out[True][1], straight.obj, atol=1e-7)
