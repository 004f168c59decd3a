"""The sharded checkpoint form (``use_orbax=True``) on gloo ranks on the
CPU: at (dp, op) = (2, 2) each rank of dp = 0 writes its own rows into its
own ``.distcp`` files and nothing is all-gathered; the checkpoint restores
at (2, 2), (1, 2), (2, 1) and on one device, each rank reading only its
rows, and every resumed run equals the uninterrupted run at its own shape;
the mesh's immediate step and a mesh with its object on the host resume
the same way; checkpoints written on one device, in either form, restore
on a mesh; and the port's (2, 2) resume is held against the JAX package's
8-device mesh resume through orbax under GD.

Tolerances: resumed losses within 1e-6 relative of the uninterrupted
run's; the JAX comparison at 1e-5 of the object's largest value (the JAX
package's resumed GD run gets its empty object state back first, as in
``tests/test_torch_checkpoint_sharded.py``)."""

import dataclasses
import os

import numpy as np
import pytest

import test_torch_mesh_ranks as C
from test_torch_mesh_setup import _one_torch_thread  # noqa: F401
from test_torch_mesh_setup import (close, close_obj, pool_fixture, problem,
                                   with_mesh)

pool = pool_fixture(4)
pool2 = pool_fixture(2)

PER_ANGLE = dict(update_scheme='per angle', rotate_out_of_loop=True)


def _orbax(cfg, use_orbax=True):
    import adorym_tpu_torch as pt
    return dataclasses.replace(cfg, io=pt.IOConfig(
        use_orbax=use_orbax, n_batch_per_checkpoint=10_000))


@pytest.fixture(scope='module')
def written(pool, tmp_path_factory):
    """A (2, 2) per-angle Adam run's sharded checkpoint after 2 epochs."""
    jc, tc, kw = problem(seed=4, optimizer='adam', **PER_ANGLE)
    tc = _orbax(tc)
    folder = str(tmp_path_factory.mktemp('mesh22'))
    out = pool.run(C.sharded_write_case, with_mesh(tc, 2, 2), kw, folder, 2)
    return tc, kw, folder, out


def _files(folder):
    """``{rank: [keys]}`` of a sharded checkpoint, from the files each
    rank wrote (``__<rank>_<i>.distcp``)."""
    import torch.distributed.checkpoint as dcp
    md = dcp.FileSystemReader(os.path.join(folder, 'checkpoint', 'dcp')
                              ).read_metadata()
    ranks = {}
    for idx, info in md.storage_data.items():
        rank = int(info.relative_path.split('_')[2])
        ranks.setdefault(rank, []).append(idx.fqn)
    return {r: sorted(k) for r, k in ranks.items()}


def _slabs(names, slabs):
    return {f'{n}/s{i:02d}' for n in names for i in slabs}


OBJ_LEAVES = ('params/obj', 'state/obj/m', 'state/obj/v')


def test_each_rank_writes_its_own_slab(written):
    """Rank (0, op) writes its 16 rows of the object and of both moments,
    as slabs ``8 op`` to ``8 op + 7`` (``offload_slabs`` a rank), into
    files of its own; rank 0 also the small leaves and the slab table; the
    ranks of dp = 1 write nothing.  The write issues no all-gather: each
    rank's collectives are the commit's three barriers (a 4-byte flag
    each) and one ``dcp.save``, whose own plan exchange is counted by call,
    its bytes not measured."""
    tc, kw, folder, out = written
    assert out[0]['mc']
    files = _files(folder)
    assert set(files) == {0, 1}
    assert set(files[1]) == _slabs(OBJ_LEAVES, range(8, 16))
    assert set(files[0]) == _slabs(OBJ_LEAVES, range(8)) | {
        '__i_batch', '__i_epoch', 'extra/global_batch', 'extra/i_opt_batch',
        'extra/obj_slab_rows', 'params/probe'}
    dcp_dir = os.path.join(folder, 'checkpoint', 'dcp')
    for f in os.listdir(dcp_dir):
        if f.startswith(('__2_', '__3_')):
            assert os.path.getsize(os.path.join(dcp_dir, f)) == 0
    for o in out:
        summary = o['comm']['summary']
        assert summary == {
            'barrier@dp+op': {'count': 3, 'bytes': 12, 'seconds':
                              summary['barrier@dp+op']['seconds']},
            'dcp_save@dp+op': {'count': 1, 'bytes': 0, 'seconds':
                               summary['dcp_save@dp+op']['seconds']}}
        assert not any(r['kind'] == 'all_gather'
                       for r in o['comm']['records'])


@pytest.mark.parametrize('step', ['_prepare', '_commit'])
def test_rank0_failure_raises_on_every_rank(pool, tmp_path, step):
    """Where a step of the commit that rank 0 alone runs fails (emptying
    ``dcp.tmp/``, or the renames), every rank raises at that step's
    barrier, none waits for the others, nothing is committed, and the
    ranks' next save commits."""
    jc, tc, kw = problem(seed=2, optimizer='adam', **PER_ANGLE)
    cfg = with_mesh(_orbax(tc), 2, 2)
    out = pool.run(C.failed_step_case, cfg, kw, str(tmp_path / step), step)
    assert out[0]['error'] == f'OSError: {step} failed'
    for o in out[1:]:
        assert o['error'].startswith('RuntimeError: sharded checkpoint: ')
        assert o['error'].endswith('failed on another rank')
    assert not any(o['committed'] for o in out)
    assert [o['then'] for o in out] == [2] * 4


@pytest.mark.parametrize('shape', [(2, 2), (1, 2), (2, 1)])
def test_restores_at_any_mesh_shape(written, pool, pool2, shape):
    """The (2, 2) checkpoint resumes at (2, 2), (1, 2) and (2, 1); each
    rank reads only its rows (what ``load_checkpoint`` returns, and the
    slabs ``restore_sharded`` reads), and the resumed losses equal the
    uninterrupted run's at that shape."""
    tc, kw, folder, _ = written
    p = pool if shape[0] * shape[1] == 4 else pool2
    cfg = with_mesh(tc, *shape)
    got = p.run(C.resume_case, cfg, kw, folder, 2)
    want = p.run(C.recon_run, cfg, kw, 4)[0]['losses'][2:]
    n_op = shape[1]
    for o in got:
        assert o['start'] == 2
        y0, y1 = o['rows']
        assert y1 - y0 == 32 // n_op
        assert o['loaded_obj'] == (32 // n_op, 32, 8, 2)
        assert set(o['loaded_state'].values()) == {(32 // n_op, 32, 8, 2)}
        op = o['coord'][1]
        mine = range(8 * op, 8 * op + 8) if n_op == 2 else range(16)
        assert o['read_slabs'] == [f's{i:02d}' for i in mine]
    close(got[0]['losses'], want, 1e-6)


def test_restores_on_one_device(written):
    """The (2, 2) checkpoint resumes on one device, without a process
    group, and equals the one-device uninterrupted run."""
    import adorym_tpu_torch as pt
    tc, kw, folder, _ = written
    rec = pt.Reconstructor(tc, device='cpu', output_folder=folder, **kw)
    assert rec._start_epoch == 2
    got = [rec.run_epoch(ep) for ep in (2, 3)]
    one = pt.Reconstructor(tc, device='cpu', **kw)
    want = [one.run_epoch(ep) for ep in range(4)][2:]
    close(got, want, 1e-6)


@pytest.mark.parametrize('form', ['sharded', 'npz'])
def test_one_device_checkpoint_restores_on_a_mesh(pool2, tmp_path, form):
    """A one-device checkpoint, in either form, resumes at (1, 2): each
    rank keeps its rows; the losses equal the uninterrupted (1, 2) run's."""
    import adorym_tpu_torch as pt
    jc, tc, kw = problem(seed=5, optimizer='adam', **PER_ANGLE)
    tc = _orbax(tc, form == 'sharded')
    folder = str(tmp_path / 'one')
    rec = pt.Reconstructor(tc, device='cpu', output_folder=folder, **kw)
    for ep in range(2):
        rec.run_epoch(ep)
    rec.save_checkpoint(2, 0)
    name = 'dcp' if form == 'sharded' else 'checkpoint.npz'
    assert os.path.exists(os.path.join(folder, 'checkpoint', name))
    cfg = with_mesh(tc, 1, 2)
    got = pool2.run(C.resume_case, cfg, kw, folder, 2)
    want = pool2.run(C.recon_run, cfg, kw, 4)[0]['losses'][2:]
    assert [o['loaded_obj'][0] for o in got] == [16, 16]
    close(got[0]['losses'], want, 1e-6)


def test_immediate_mesh_step_resumes(pool, tmp_path):
    """The mesh's immediate step (``recon_mesh``'s band layout) writes
    the sharded form and resumes to the uninterrupted run."""
    jc, tc, kw = problem(seed=1, optimizer='adam', update_scheme='immediate')
    tc = _orbax(tc)
    cfg = with_mesh(tc, 2, 2)
    folder = str(tmp_path / 'imm')
    w = pool.run(C.sharded_write_case, cfg, kw, folder, 1)
    got = pool.run(C.resume_case, cfg, kw, folder, 1)
    want = pool.run(C.recon_run, cfg, kw, 2)
    assert want[0]['mci'] and got[0]['start'] == 1
    close(w[0]['losses'], want[0]['losses'][:1], 1e-6)
    close(got[0]['losses'], want[0]['losses'][1:], 1e-6)


def test_mesh_offload_resumes(pool, tmp_path):
    """Each rank's object slab and moments on the host (the per-angle
    mesh path): the write takes them from the host blocks, and the resume
    equals the uninterrupted offloaded run."""
    jc, tc, kw = problem(seed=1, n=32, nz=16, binning=4,
                         non_negativity=True, **PER_ANGLE)
    cfg = with_mesh(_orbax(tc), 2, 2, offload_optimizer_state=True,
                    offload_object=True)
    folder = str(tmp_path / 'off')
    pool.run(C.sharded_write_case, cfg, kw, folder, 2)
    got = pool.run(C.resume_case, cfg, kw, folder, 2)
    want = pool.run(C.recon_run, cfg, kw, 4)
    assert want[0]['obj_off_mesh']
    close(got[0]['losses'], want[0]['losses'][2:], 1e-6)
    close_obj(got[0]['obj'], want[0]['obj'], 1e-6)


def test_mesh_resume_matches_jax_mesh_orbax(pool, tmp_path):
    """Under GD, on the same inputs: the port's (2, 2) resume through its
    sharded form against the JAX package's (2, 2) resume through orbax
    on its 8 virtual CPU devices, the objects within 1e-5."""
    import adorym_tpu.config as jcfg
    from adorym_tpu.parallel.mesh import make_mesh
    from adorym_tpu.recon import Reconstructor
    jc, tc, kw = problem(seed=3, optimizer='gd', **PER_ANGLE)
    cfg = with_mesh(_orbax(tc), 2, 2)
    folder = str(tmp_path / 'port')
    pool.run(C.sharded_write_case, cfg, kw, folder, 2)
    port = pool.run(C.resume_case, cfg, kw, folder, 2)[0]
    jc = with_mesh(dataclasses.replace(jc, io=jcfg.IOConfig(
        use_orbax=True, n_batch_per_checkpoint=10_000)), 2, 2)
    jfolder = str(tmp_path / 'jax')
    first = Reconstructor(jc, mesh=make_mesh(jc.parallel),
                          output_folder=jfolder, **kw)
    for ep in range(2):
        first.run_epoch(ep)
    first.save_checkpoint(2, 0)
    resumed = Reconstructor(jc, mesh=make_mesh(jc.parallel),
                            output_folder=jfolder, **kw)
    assert resumed._start_epoch == 2
    for k in resumed.specs:
        resumed.opt_state.setdefault(k, {})
    jl = [resumed.run_epoch(ep) for ep in (2, 3)]
    close(port['losses'], jl, 1e-5)
    close_obj(port['obj'], np.asarray(resumed.params['obj']), 1e-5)
