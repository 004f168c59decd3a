"""Out-of-core under a mesh, checkpoints and outputs across mesh shapes,
the entry point on a mesh, and the mesh cases of the JAX package's epoch
and configuration-matrix tests, on gloo ranks on the CPU: the
counterparts of ``tests/test_offload.py::test_offload_with_sharded_object``,
``tests/test_offload_object.py::TestMeshOffloadObject``, the mesh case of
``tests/test_fused_angles_epoch.py`` and ``tests/test_config_matrix.py::
test_feature_combination_mesh``.  Offloaded mesh runs are held bit-equal
to the resident mesh runs."""

import dataclasses
import os

import numpy as np
import pytest

import test_torch_mesh_ranks as C
from test_torch_mesh_setup import _one_torch_thread  # noqa: F401
from test_torch_mesh_setup import (close, close_obj, configs, jax_run, pool_fixture,
                              problem, with_mesh)

pool = pool_fixture(4)

PER_ANGLE = dict(update_scheme='per angle', rotate_out_of_loop=True)


def _offload_problem(seed=1):
    """``tests/test_offload.py``'s problem: a 24^3 object, a 12^2 probe
    at stride 6, two angles, minibatch 4."""
    return problem(seed=seed, n=24, nz=24, pn=12, stride=6, binning=2,
                   n_theta=2, optimizer='adam', learning_rate=1e-5,
                   **PER_ANGLE)


def test_offload_with_sharded_object(pool):
    """Adam's moments on the host under a (2, 2) mesh: each rank's
    moments are its slab's, on the host; the epoch's loss is the JAX
    package's mesh run's."""
    jc, tc, kw = _offload_problem()
    cfg = with_mesh(tc, 2, 2, offload_optimizer_state=True)
    out = pool.run(C.recon_run, cfg, kw, 1)
    for o in out:
        assert o['off_state'] and o['state_devices'] == ['cpu']
        assert o['state_shapes']['m'] == o['slab_shape'] == (12, 24, 24, 2)
    assert np.isfinite(out[0]['losses'][0])
    ref = jax_run(jc, kw, 1, 2, 2)
    close(out[0]['losses'], ref['losses'], 1e-5)


def _obj_problem(seed=1):
    """``tests/test_offload_object.py``'s problem: a 32^2 x 16 object
    binned by 4, an 8^2 probe on a 4x4 grid, minibatch 4 (grid rows)."""
    return problem(seed=seed, n=32, nz=16, binning=4, non_negativity=True,
                   **PER_ANGLE)


def _obj_offload_cfg(tc, offload, op=2, state=True):
    return with_mesh(tc, 4 // op, op, offload_optimizer_state=state,
                     offload_object=offload)


def test_trajectory_bit_identical_to_device_resident(pool):
    """Each rank's object slab on the host (the per-angle mesh path), the
    trajectory bit-equal to the resident mesh run."""
    jc, tc, kw = _obj_problem(seed=1)
    dev = pool.run(C.recon_run, _obj_offload_cfg(tc, False), kw, 2)[0]
    off = pool.run(C.recon_run, _obj_offload_cfg(tc, True), kw, 2)[0]
    assert off['mc'] and off['obj_off_mesh'] and not dev['obj_off_mesh']
    assert off['losses'] == dev['losses']
    np.testing.assert_array_equal(off['obj'], dev['obj'])


def test_moments_required(pool):
    """Object offload under a mesh needs the moments offloaded."""
    jc, tc, kw = _obj_problem(seed=2)
    b = pool.run(C.recon_build, _obj_offload_cfg(tc, True, state=False),
                 kw, ValueError)[0]
    assert b['raised'] == 'ValueError'
    assert 'offload_optimizer_state' in b['msg']


def test_requires_mc_fast_path(pool):
    """Without the per-angle mesh path (immediate updates) an explicit
    ``offload_object`` raises with the decline reasons."""
    jc, tc, kw = _obj_problem(seed=3)
    tc = dataclasses.replace(tc, train=dataclasses.replace(
        tc.train, update_scheme='immediate', rotate_out_of_loop=False))
    b = pool.run(C.recon_build, _obj_offload_cfg(tc, True), kw,
                 ValueError)[0]
    assert b['raised'] == 'ValueError' and 'fast path' in b['msg']


def test_auto_gate_uses_per_device_share(pool):
    """'auto' under a mesh decides on each rank's share of the object,
    not the whole object."""
    jc, tc, kw = _obj_problem(seed=1)
    cfg = _obj_offload_cfg(tc, 'auto')
    assert not pool.run(C.offload_auto_case, cfg, kw)[0]['obj_off_mesh']
    # A boundary under a rank's share (the whole object is twice it).
    assert pool.run(C.offload_auto_case, cfg, kw, 0.5)[0]['obj_off_mesh']
    assert not pool.run(C.offload_auto_case, cfg, kw, 2.5)[0][
        'obj_off_mesh']


def test_mc_run_epochs_matches_run_epoch(pool):
    """``run_epochs`` on the per-angle mesh path (the port's counterpart
    of the JAX package's fused mesh epoch) gives the ``run_epoch`` calls'
    trajectory bit for bit."""
    jc, tc, kw = problem(seed=0, **PER_ANGLE)
    seq = pool.run(C.recon_run, with_mesh(tc, 2, 2), kw, 2)[0]
    pip = pool.run(C.recon_run, with_mesh(tc, 2, 2), kw, 2,
                   run_epochs=True)[0]
    assert seq['mc'] and seq['losses'] == pip['losses']
    np.testing.assert_array_equal(seq['obj'], pip['obj'])


def test_checkpoint_crosses_mesh_shapes(pool, tmp_path):
    """A (2, 2) mesh run's checkpoint (rank 0 writes the whole object and
    its moments under one device's keys) resumes on one device; the
    resumed epoch follows the uninterrupted one-device run."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.io import checkpoint as ckpt_lib
    jc, tc, kw = problem(seed=4, **PER_ANGLE)
    folder = str(tmp_path / 'mesh')
    got = pool.run(C.run_with_checkpoint, with_mesh(tc, 2, 2), kw, folder,
                   1)[0]
    one_folder = str(tmp_path / 'one')
    one = pt.Reconstructor(tc, device='cpu', output_folder=one_folder, **kw)
    want = one.run(n_epochs=1)
    close(got['losses'], want['loss_history'], 1e-5)
    a = np.load(os.path.join(folder, 'checkpoint', 'checkpoint.npz'))
    b = np.load(os.path.join(one_folder, 'checkpoint', 'checkpoint.npz'))
    assert sorted(a.files) == sorted(b.files)
    close_obj(a['params/obj'], b['params/obj'], 1e-5)
    resumed = pt.Reconstructor(tc, device='cpu', output_folder=folder, **kw)
    assert resumed._start_epoch == 1
    l_res = resumed.run_epoch(1)
    l_one = one.run_epoch(1)
    close(l_res, l_one, 1e-4)
    assert ckpt_lib is not None


MESH_CASES = [
    ('mesh_perangle_rol_shrink',
     dict(update_scheme='per angle', rotate_out_of_loop=True,
          shrink_cycle=2, shrink_threshold=1e-9), {}, {}),
    ('mesh_offload_state_probe_opt',
     dict(), dict(optimize_probe=True), {}),
    ('mesh_rwl1_immediate',
     dict(), {}, dict(alpha_d=1e-8, alpha_b=1e-9, reweighted_l1=True)),
    ('mesh_imm_interp_probe_opt',
     dict(imm_grad_rotation='interp'), dict(optimize_probe=True), {}),
]


@pytest.mark.parametrize('label,train_kw,refine_kw,loss_kw', MESH_CASES,
                         ids=[c[0] for c in MESH_CASES])
def test_feature_combination_mesh(pool, label, train_kw, refine_kw,
                                  loss_kw):
    """``tests/test_config_matrix.py``'s mesh cases on a (2, 2) mesh:
    finite, decreasing losses over 8 epochs."""
    from adorym_tpu.simulate import simulate
    from adorym_tpu.utils.initialize import initialize_probe
    n, pn = 16, 8
    rng = np.random.default_rng(5)
    obj_true = np.stack([rng.random((n, n, n)) * 1e-3,
                         rng.random((n, n, n)) * 3e-5], -1).astype(np.float32)
    probe = np.asarray(initialize_probe(
        (pn, pn), 'gaussian', energy_ev=5000.0, psize_cm=1e-7,
        probe_mag_sigma=3, probe_phase_sigma=3, probe_phase_max=0.3))
    xs = np.arange(0, n - pn + 1, 8)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    theta_ls = np.linspace(0, np.pi, 3, endpoint=False)
    geo = dict(obj_size=(n, n, n), probe_size=(pn, pn), energy_ev=5000.0,
               psize_cm=1e-7, free_prop_cm='inf', binning=2)
    jc, _ = configs(geo, dict(minibatch_size=2))
    data = np.asarray(simulate(jc, obj_true, probe, pos, theta_ls))
    _, tc = configs(geo, dict(minibatch_size=2, learning_rate=1e-6,
                              **train_kw), loss=loss_kw, refine=refine_kw,
                    parallel=dict(data_axis=2, object_axis=2,
                                  offload_optimizer_state='offload'
                                  in label))
    kw = dict(data=data, probe_pos=pos, probe_init=probe,
              theta_ls=theta_ls, obj_init=np.zeros((n, n, n, 2), np.float32))
    got = pool.run(C.matrix_case, tc, kw, 8)[0]
    losses = got['losses']
    assert np.all(np.isfinite(losses)), (label, losses)
    assert losses[-1] < losses[0], (label, losses)


def test_api_on_a_mesh(pool):
    """``reconstruct_ptychography(parallel_data_axis=2,
    parallel_object_axis=2, distribution_mode='distributed_object')`` on
    the ranks: the one-device call's results."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.io.data import ArrayDataset
    jc, tc, kw = problem(seed=6, **PER_ANGLE)
    ds = ArrayDataset(kw['data'], theta=kw['theta_ls'],
                      probe_pos_px=kw['probe_pos'], energy_ev=5000.0,
                      psize_cm=1e-7)
    params = dict(fname='data.h5', save_path='.', output_folder=None,
                  obj_size=(32, 32, 8), n_epochs=2, learning_rate=1e-4,
                  energy_ev=5000.0, psize_cm=1e-7, minibatch_size=4,
                  binning=2, free_prop_cm='inf', probe_type='gaussian',
                  probe_mag_sigma=2, probe_phase_sigma=2,
                  probe_phase_max=0.3, optimizer='adam',
                  rotate_out_of_loop=True, update_scheme='per angle',
                  use_checkpoint=False, store_checkpoint=False,
                  device='cpu', dataset=ds)
    want = pt.reconstruct_ptychography(**params)
    got = pool.run(C.api_run, dict(
        params, parallel_data_axis=2, parallel_object_axis=2,
        distribution_mode='distributed_object'))[0]
    close(got['loss_history'], want['loss_history'], 1e-4)
    close_obj(got['obj'], want['obj'], 1e-3)
