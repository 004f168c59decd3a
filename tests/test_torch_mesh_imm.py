"""The immediate mesh path (``adorym_tpu_torch/recon_mesh.py``,
``mc_imm_step``, the reference's default scheme) on gloo ranks on the CPU,
against the JAX package's ``_build_mc_imm_step`` on its virtual mesh and
the port's one-device band step: the counterparts of
``tests/test_mc_imm.py``, on 4-rank meshes ((2, 4) -> (4, 1)).  GD losses
at rtol 1e-5 and objects at 1e-5 of the largest value (3e-5 across
packages or against the generic one-device step); Adam and bf16 loosely,
as the JAX tests hold them."""

import numpy as np
import pytest

import test_torch_mesh_ranks as C
from test_torch_mesh_setup import _one_torch_thread  # noqa: F401
from test_torch_mesh_setup import (close, close_across, close_obj, comm_counts,
                              jax_run, pool_fixture, port_single, problem,
                              with_mesh)

pool = pool_fixture(4)

IMM = dict(update_scheme='immediate')


def _gd(**kw):
    return dict(IMM, optimizer='gd', learning_rate=1e-3, **kw)


def _mesh_run(pool, tc, kw, dp, op, n_epochs=2, **kwargs):
    out = pool.run(C.recon_run, with_mesh(tc, dp, op), kw, n_epochs,
                   **kwargs)
    return out[0], out


@pytest.mark.parametrize('dp,op', [(2, 2), (1, 4), (4, 1)])
def test_engages_and_matches_single_device(pool, dp, op):
    """The mesh takes the immediate path; its GD trajectory matches the
    one-device band step (and, at (2, 2), the JAX package's mesh run)."""
    jc, tc, kw = problem(**_gd())
    one = port_single(tc, kw, 3)
    assert one['rec']._band
    got, _ = _mesh_run(pool, tc, kw, dp, op, n_epochs=3)
    assert got['mci'], got['reasons']
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)
    if (dp, op) == (2, 2):
        ref = jax_run(jc, kw, 3, dp, op)
        assert ref['rec']._mci is not None
        close(got['losses'], ref['losses'], 1e-5)
        close_obj(got['obj'], ref['obj'], 3e-5)


def test_adam_trajectory_agrees_globally(pool):
    """Adam: the loss curve and the field agree with the JAX package's
    mesh run (per-voxel equality is no contract: near-zero-gradient voxels
    flip sign on f32 noise)."""
    jc, tc, kw = problem(**IMM)
    got, _ = _mesh_run(pool, tc, kw, 2, 2, n_epochs=3)
    ref = jax_run(jc, kw, 3, 2, 2)
    close(got['losses'], ref['losses'], 5e-3)
    o, r = got['obj'].ravel(), ref['obj'].ravel()
    assert np.corrcoef(o, r)[0, 1] > 0.999
    assert np.abs(o - r).max() < 5 * 1e-4 * 36


def test_single_step_matches_tightly(pool):
    """From the same start, one mesh step equals one band step of the
    one-device run at rtol 1e-5."""
    jc, tc, kw = problem(**IMM)
    rec1 = port_single(tc, kw, 0)['rec']
    batches = rec1.make_batches(np.random.default_rng(tc.train.seed))
    pick = batches[:3] + batches[8:9]
    got = pool.run(C.imm_single_steps, with_mesh(tc, 2, 2), kw, pick)[0]
    import adorym_tpu_torch as pt
    import torch
    for (i_theta, inds), (l8, o8) in zip(pick, got):
        rec = pt.Reconstructor(tc, device='cpu', **kw)
        meas = torch.as_tensor(rec.data[i_theta][inds])
        l1 = float(rec.step_band(i_theta, inds, meas))
        close(l8, l1, 1e-5)
        close_obj(o8, rec.obj, 1e-5)


def test_probe_refinement_composes(pool):
    """The probe's per-batch updates ride the auxiliary sum."""
    refine = dict(optimize_probe=True, probe_learning_rate=1e-3)
    jc, tc, kw = problem(seed=2, refine=refine, **_gd())
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2, probe=True)
    assert got['mci'], got['reasons']
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['probe'], one['probe'], 1e-5)


def test_bf16_composes(pool):
    """``run_bfloat16`` through the immediate mesh path tracks the
    one-device bf16 run (rtol 2e-2, as the JAX test)."""
    jc, tc, kw = problem(seed=5, run_bfloat16=True, **IMM)
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    assert got['mci']
    close(got['losses'], one['losses'], 2e-2)


def test_nonuniform_theta_order_consistent(pool):
    """The epoch's shuffled angle order gives the one-device batch order:
    the same losses batch for batch."""
    jc, tc, kw = problem(seed=7, **_gd())
    out = pool.run(C.recon_run, with_mesh(tc, 2, 2), kw, 1, callback=True)
    one = port_single(tc, kw, 1, callback=True)
    b8 = [(b, l) for _, b, l in out[0]['batch_losses']]
    b1 = [(b, l) for _, b, l in one['batch_losses']]
    assert [b for b, _ in b8] == [b for b, _ in b1]
    close([l for _, l in b8], [l for _, l in b1], 1e-5)


def test_collective_budget_and_no_allgather(pool):
    """Per batch: one band sum over 'op' and two sums over the mesh (the
    band's gradient and the scalar/auxiliary sum); nothing else, every
    band no taller than the probe."""
    jc, tc, kw = problem(seed=1, mb=8, pn=4, stride=4, **IMM)
    got, outs = _mesh_run(pool, tc, kw, 2, 2, n_epochs=1)
    assert got['mci'], got['reasons']
    n_b = 3 * 8
    for o in outs:
        assert comm_counts(o) == {('all_reduce', 'op'): n_b,
                                  ('all_reduce', 'dp+op'): 2 * n_b}
        for r in o['comm']['records']:
            if len(r['shape']) >= 3:
                assert r['shape'][0] <= 4, r


def test_small_minibatch_engages_by_padding(pool):
    """A minibatch smaller than the rank count (3 spots on 4 ranks)
    engages by padding at weight 0 (one slot a rank) and matches."""
    jc, tc, kw = problem(seed=3, n=24, stride=8, mb=3, **_gd())
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    assert got['mci'], got['reasons']
    assert (got['lay_mb_pad'], got['lay_mpp']) == (4, 1)
    assert got['ws_sum'] == 3 * 3
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)


def test_prime_row_width_collective_budget(pool):
    """The padded prime-width layout keeps band-sized collectives."""
    jc, tc, kw = problem(seed=19, mb=7, stride=4, grid=7, **IMM)
    got, outs = _mesh_run(pool, tc, kw, 2, 2, n_epochs=1)
    assert got['mci'], got['reasons']
    for o in outs:
        assert set(comm_counts(o)) == {('all_reduce', 'op'),
                                       ('all_reduce', 'dp+op')}
        for r in o['comm']['records']:
            if len(r['shape']) >= 3:
                assert r['shape'][0] <= 8, r


def test_prime_row_width_engages_and_matches(pool):
    """7-wide rows on 4 ranks: padded to 8 slots, trajectory matches."""
    jc, tc, kw = problem(seed=11, mb=7, stride=4, grid=7, **_gd())
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    assert got['mci'], got['reasons']
    assert (got['lay_mpp'], got['lay_mb_pad']) == (2, 8)
    assert got['ws_sum'] == 7 * 7
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)
    ref = jax_run(jc, kw, 2, 2, 2)
    assert ref['rec']._mci['mpp'] == 2
    close_across(got, ref, one, jax_run(jc, kw, 2))


def test_ragged_final_row_engages_and_matches(pool):
    """A partial last row (8x8 grid minus 3): repeat-last multiplicity,
    against the one-device generic step on the same batches."""
    jc, tc, kw = problem(seed=13, mb=8, pn=4, stride=4, **_gd())
    kw['probe_pos'] = kw['probe_pos'][:-3]
    kw['data'] = kw['data'][:, :-3]
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    assert got['mci'], got['reasons']
    assert (got['lay_n_last'], got['lay_n_rows']) == (5, 8)
    w_last = got['ws_last']
    assert float(w_last.sum()) == 8.0 and float(w_last.max()) == 4.0
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 3e-5)
    close_across(got, jax_run(jc, kw, 2, 2, 2), one, jax_run(jc, kw, 2))


def test_imm_interp_grad_rotation_composes(pool):
    """``imm_grad_rotation='interp'`` through the shared band backward."""
    jc, tc, kw = problem(seed=17, imm_grad_rotation='interp', **_gd())
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    assert got['mci'], got['reasons']
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)
    ref = jax_run(jc, kw, 2, 2, 2)
    close(got['losses'], ref['losses'], 1e-5)
    close_obj(got['obj'], ref['obj'], 3e-5)


def test_ineligible_declines_with_reason(pool):
    """Randomized positions decline to the generic mesh path, with the
    JAX package's reasons and a warning, and it still reconstructs."""
    import warnings
    from adorym_tpu.parallel.mesh import make_mesh as jmake_mesh
    from adorym_tpu.recon import Reconstructor as JRec
    jc, tc, kw = problem(seed=3, randomize_probe_pos=True, **IMM)
    b = pool.run(C.recon_build, with_mesh(tc, 2, 2), kw)[0]
    assert not b['mci']
    assert any('row grid' in r for r in b['reasons'])
    jcs = with_mesh(jc, 2, 2)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        jrec = JRec(jcs, mesh=jmake_mesh(jcs.parallel), **kw)
    assert b['reasons'] == jrec._mc_decline_reasons
    assert any('fast path declined' in w for w in b['warnings'])
    got, _ = _mesh_run(pool, tc, kw, 2, 2, n_epochs=1)
    assert np.isfinite(got['losses'][0])


def test_run_epochs_pipelines_mc_imm(pool):
    """``run_epochs`` on the immediate mesh path: the same losses as
    ``run_epoch`` calls, bit for bit."""
    jc, tc, kw = problem(seed=9, **IMM)
    seq, _ = _mesh_run(pool, tc, kw, 2, 2, n_epochs=3)
    pip, _ = _mesh_run(pool, tc, kw, 2, 2, n_epochs=3, run_epochs=True)
    assert seq['losses'] == pip['losses']


def test_regularizers_compose_with_mc_imm(pool):
    """L1 and TV on the slabs with the immediate path: the GD trajectory
    matches the one-device and the JAX package's mesh runs, and no object
    is gathered."""
    n3 = 32 * 32 * 8.
    loss = dict(alpha_d=1e-9 * n3, alpha_b=1e-10 * n3, gamma=1e-9 * n3)
    jc, tc, kw = problem(seed=11, loss=loss, **_gd())
    one = port_single(tc, kw, 2)
    got, outs = _mesh_run(pool, tc, kw, 2, 2)
    assert got['mci']
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)
    # This run's loss grows tenfold, and the two packages' one-device runs
    # already differ by 1e-4 of the object's largest value.
    close_across(got, jax_run(jc, kw, 2, 2, 2), one, jax_run(jc, kw, 2))
    for o in outs:
        assert not any(r['kind'] == 'all_gather'
                       for r in o['comm']['records'])


def test_shrink_wrap_composes_with_mc_imm(pool):
    """Shrink-wrap on the slabs, on the reference's cadence: the support
    matches the one-device run's."""
    jc, tc, kw = problem(seed=13, shrink_cycle=4, shrink_threshold=1e-9,
                         non_negativity=True, **_gd())
    kw['finite_support_mask'] = np.ones(tc.geometry.obj_size, np.float32)
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    assert got['mci'], got['reasons']
    close(got['losses'], one['losses'], 1e-5)
    np.testing.assert_array_equal(
        got['mask'], one['rec'].finite_support_mask.numpy())


def test_probe_pos_correction_composes_with_mc_imm(pool):
    """Per-spot position refinement (indexed by each rank's spots) rides
    the auxiliary sum."""
    refine = dict(optimize_all_probe_pos=True,
                  all_probe_pos_learning_rate=1e-3)
    jc, tc, kw = problem(seed=15, refine=refine, **_gd())
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2,
                       keys=('probe_pos_correction',))
    assert got['mci'], got['reasons']
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['probe_pos_correction'],
              one['rec'].params['probe_pos_correction'].numpy(), 1e-5)
