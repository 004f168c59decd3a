"""The per-angle mesh path (``adorym_tpu_torch/recon_mesh.py``,
``mc_angle_step``) on gloo ranks on the CPU, against the JAX package's
``_mc_step`` on its virtual mesh and the port's one-device run: the
counterparts of ``tests/test_mc_patch.py``.  The port's ranks are four
processes, so the JAX tests' 8-device meshes become 4-rank ones ((2, 4) ->
(2, 2), (4, 2) -> (4, 1)); the comm counter stands in for the compiled
program's collectives.  GD losses are held at rtol 1e-5; objects at 1e-5
of the largest value where both runs take the same decomposition, at 3e-5
where they do not (the JAX package's mesh run, or a one-device run on the
generic path); Adam at rtol 1e-3 across packages (its 1/sqrt(v) amplifies
f32 noise, as the JAX tests note)."""

import dataclasses

import numpy as np
import pytest

import test_torch_mesh_ranks as C
from test_torch_mesh_setup import _one_torch_thread  # noqa: F401
from test_torch_mesh_setup import (close, close_across, close_obj, comm_counts,
                              jax_run, pool_fixture, port_single, problem,
                              with_mesh)

pool = pool_fixture(4)

PER_ANGLE = dict(update_scheme='per angle', rotate_out_of_loop=True)


def _mesh_run(pool, tc, kw, dp, op, n_epochs=2, **kwargs):
    out = pool.run(C.recon_run, with_mesh(tc, dp, op), kw, n_epochs,
                   **kwargs)
    return out[0], out


def _gd(**kw):
    return dict(PER_ANGLE, optimizer='gd', learning_rate=1e-3, **kw)


@pytest.mark.parametrize('dp,op', [(2, 2), (4, 1), (1, 4)])
def test_engages_and_matches_single_device(pool, dp, op):
    """The mesh takes the per-angle path and its GD trajectory matches
    the one-device run at rtol 1e-5 (and, at (2, 2), the JAX package's
    mesh run)."""
    jc, tc, kw = problem(**_gd())
    one = port_single(tc, kw, 2, callback=True)
    assert one['rec']._patch_mode
    got, _ = _mesh_run(pool, tc, kw, dp, op, callback=True)
    assert got['mc'], got['reasons']
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)
    # Per-batch losses line up row for row, not just in the mean.
    close([l for _, _, l in got['batch_losses']],
          [l for _, _, l in one['batch_losses']], 1e-5)
    if (dp, op) == (2, 2):
        ref = jax_run(jc, kw, 2, dp, op)
        assert ref['rec']._mc is not None
        close(got['losses'], ref['losses'], 1e-5)
        close_obj(got['obj'], ref['obj'], 3e-5)


def test_adam_matches_jax_mesh(pool):
    """Adam (the flagship optimizer) on the mesh against the JAX package's
    mesh run, held as ``tests/test_mc_patch.py`` holds Adam."""
    jc, tc, kw = problem(**PER_ANGLE)
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    ref = jax_run(jc, kw, 2, 2, 2)
    close(got['losses'], ref['losses'], 1e-3)
    # Each Adam update moves a voxel by at most about lr (6 updates).
    o, r = got['obj'].ravel(), ref['obj'].ravel()
    assert np.abs(o - r).max() < 6 * 1e-4
    assert np.corrcoef(o, r)[0, 1] > 0.999


def test_probe_refinement_matches(pool):
    """The probe's gradient sums over both axes (the auxiliary sum)."""
    refine = dict(optimize_probe=True, probe_learning_rate=1e-3)
    jc, tc, kw = problem(seed=3, refine=refine, **_gd())
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2, probe=True)
    assert got['mc']
    close_obj(got['probe'], one['probe'], 1e-5)
    close(got['losses'], one['losses'], 1e-5)


def test_padded_geometry_matches(pool):
    """Off-edge scan positions: the padded re-slab offsets, the vacuum
    masking and the rounding of the bottom pad; a ring shift for each
    nonzero side of the halo in, and out the halo add and one for each
    nonzero side of the y padding (the re-slab back)."""
    jc, tc, kw = problem(seed=4, **_gd())
    kw['probe_pos'] = kw['probe_pos'] - 2.0
    from adorym_tpu.simulate import simulate
    import adorym_tpu.config as jcfg
    kw['data'] = np.asarray(simulate(jcfg.ReconConfig(geometry=jc.geometry),
                                     kw['obj_init'] * 2, kw['probe_init'],
                                     kw['probe_pos'], kw['theta_ls']))
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2, step_comm=True)
    assert got['mc'] and (got['lay_p0'], got['lay_px0']) == (2, 2)
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)
    ref = jax_run(jc, kw, 2, 2, 2)
    close(got['losses'], ref['losses'], 1e-5)
    close_obj(got['obj'], ref['obj'], 3e-5)
    c = comm_counts(got, epoch0=True)
    n_angles = len(kw['theta_ls'])
    shifts = ((got['lay_h1'] > 0) + (got['lay_h2'] > 0)
              + 1 + (got['lay_p1'] > 0) + (got['lay_p0'] > 0))
    assert shifts == 4
    assert c[('ring_shift', 'op')] == shifts * n_angles, c


def test_no_full_object_allgather(pool):
    """Sharded memory: the per-angle path gathers no object."""
    jc, tc, kw = problem(seed=1, **PER_ANGLE)
    got, outs = _mesh_run(pool, tc, kw, 2, 2, n_epochs=1)
    assert got['mc']
    for o in outs:
        assert not any(r['kind'] == 'all_gather'
                       for r in o['comm']['records'])


def test_exact_grad_rotation_matches(pool):
    """``exact_grad_rotation=True`` takes the exact rotation transpose
    on each slab too."""
    jc, tc, kw = problem(seed=6, exact_grad_rotation=True, **_gd())
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    assert got['mc']
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)
    ref = jax_run(jc, kw, 2, 2, 2)
    close(got['losses'], ref['losses'], 1e-5)
    close_obj(got['obj'], ref['obj'], 3e-5)


def test_probe_modes_and_bf16_compose(pool):
    """Two probe modes under ``run_bfloat16`` through the mesh path, held
    as the JAX test holds bf16 (rtol 1e-2)."""
    jc, tc, kw = problem(seed=7, n_probe_modes=2, run_bfloat16=True,
                         **PER_ANGLE)
    kw['probe_init'] = np.concatenate([kw['probe_init'],
                                       kw['probe_init'] * 0.3], 0)
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    assert got['mc']
    close(got['losses'], one['losses'], 1e-2)
    close_obj(got['obj'], one['obj'], 1e-2)


def test_offloaded_moments_compose(pool):
    """Adam's moments on the host under an object split: each rank's
    moments of its slab, whole on the host; the trajectory bit-equal to
    the resident mesh run (``tests/test_offload.py:93`` too)."""
    jc, tc, kw = problem(seed=5, **PER_ANGLE)
    res, _ = _mesh_run(pool, tc, kw, 2, 2)
    off, outs = _mesh_run(pool, dataclasses.replace(
        tc, parallel=dataclasses.replace(tc.parallel,
                                         offload_optimizer_state=True)),
                          kw, 2, 2)
    assert off['mc'] and off['off_state']
    for o in outs:
        assert o['state_devices'] == ['cpu']
        assert o['state_shapes']['m'] == o['slab_shape'] == (16, 32, 8, 2)
    assert off['losses'] == res['losses']
    np.testing.assert_array_equal(off['obj'], res['obj'])


@pytest.mark.parametrize('dp,op', [(2, 2), (4, 1)])
def test_prime_row_width_engages_and_matches(pool, dp, op):
    """The flagship's prime row width (7-wide rows here): spots padded at
    weight 0 to a multiple of ``data_axis``; the trajectory matches."""
    jc, tc, kw = problem(seed=8, mb=7, stride=4, grid=7, **_gd())
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, dp, op)
    assert got['mc'], got['reasons']
    assert got['lay_mp'] == -(-7 // dp) and got['lay_mp'] * dp > 7
    assert got['ws_sum'] == 7 * 7
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)
    if (dp, op) == (2, 2):
        ref = jax_run(jc, kw, 2, dp, op)
        assert ref['rec']._mc['mp'] == got['lay_mp']
        close(got['losses'], ref['losses'], 1e-5)
        close_obj(got['obj'], ref['obj'], 3e-5)


def test_ragged_final_row_engages_and_matches(pool):
    """A partial last row: repeat-last weight multiplicity, against the
    one-device generic run that sees the same repeat-last batches."""
    jc, tc, kw = problem(seed=14, **_gd())
    kw['probe_pos'] = kw['probe_pos'][:-2]
    kw['data'] = kw['data'][:, :-2]
    one = port_single(tc, kw, 2)
    assert one['rec']._rowgrid_stride is None
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    assert got['mc'], got['reasons']
    assert got['lay_n_last'] == 2 and got['lay_n_rows'] == 4
    assert got['ws_sum'] == 4 * 4
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 3e-5)
    close_across(got, jax_run(jc, kw, 2, 2, 2), one, jax_run(jc, kw, 2))


def test_prime_row_width_collective_budget(pool):
    """The padded prime-width layout keeps the budget: no all-gather,
    ring shifts of halo height only."""
    jc, tc, kw = problem(seed=9, mb=7, stride=4, grid=7, **PER_ANGLE)
    got, outs = _mesh_run(pool, tc, kw, 2, 2, n_epochs=1)
    assert got['mc']
    for o in outs:
        for r in o['comm']['records']:
            assert r['kind'] != 'all_gather'
            if r['kind'] == 'ring_shift':
                assert r['shape'][0] <= got['lay_h2'], r


@pytest.mark.parametrize('reweighted', [False, True])
def test_regularizers_compose(pool, reweighted):
    """TV and (reweighted) L1 on the rotated slabs (sums over 'op', TV's
    one-row halo): the GD trajectory matches, with no object gathered."""
    n3 = 32 * 32 * 8.
    loss = dict(alpha_d=1e-9 * n3, alpha_b=1e-10 * n3, gamma=1e-9 * n3,
                reweighted_l1=reweighted)
    jc, tc, kw = problem(seed=12, loss=loss, **_gd())
    one = port_single(tc, kw, 2)
    got, outs = _mesh_run(pool, tc, kw, 2, 2)
    assert got['mc']
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)
    for o in outs:
        assert not any(r['kind'] == 'all_gather'
                       for r in o['comm']['records'])
    if not reweighted:
        ref = jax_run(jc, kw, 2, 2, 2)
        close(got['losses'], ref['losses'], 1e-5)
        close_obj(got['obj'], ref['obj'], 3e-5)


def test_literal_flagship_23x23_geometry(pool):
    """The flagship's literal scan (23x23 spots, minibatch = one 23-wide
    row) at a small width: both mesh paths engage, and the per-angle one
    matches the one-device run."""
    w, pn, s = 23, 8, 4
    n = s * (w - 1) + pn
    jc, tc, kw = problem(seed=21, n=n, nz=4, pn=pn, stride=s, mb=w,
                         grid=w, n_theta=2, **_gd())
    for scheme, key in (('per angle', 'mc'), ('immediate', 'mci')):
        tcs = dataclasses.replace(tc, train=dataclasses.replace(
            tc.train, update_scheme=scheme,
            rotate_out_of_loop=scheme == 'per angle'))
        b = pool.run(C.recon_build, with_mesh(tcs, 2, 2), kw)[0]
        assert b[key], (scheme, b['reasons'])
    one = port_single(tc, kw, 1)
    got, _ = _mesh_run(pool, tc, kw, 2, 2, n_epochs=1)
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)


def test_ineligible_configs_fall_back(pool):
    """Randomized positions and the immediate scheme decline the
    per-angle layout, with the JAX package's reasons, word for word."""
    from adorym_tpu.parallel.mesh import make_mesh as jmake_mesh
    from adorym_tpu.recon import Reconstructor as JRec
    jc, tc, kw = problem(seed=2, randomize_probe_pos=True, **PER_ANGLE)
    for over in ({}, dict(randomize_probe_pos=False,
                          update_scheme='immediate'),
                 dict(n_batch_per_update=2)):
        tcs = dataclasses.replace(tc, train=dataclasses.replace(
            tc.train, **over))
        jcs = with_mesh(dataclasses.replace(jc, train=dataclasses.replace(
            jc.train, **over)), 2, 2)
        b = pool.run(C.recon_build, with_mesh(tcs, 2, 2), kw)[0]
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            jrec = JRec(jcs, mesh=jmake_mesh(jcs.parallel), **kw)
        assert not b['mc'] and jrec._mc is None
        assert b['mci'] == (jrec._mci is not None)
        assert b['reasons'] == jrec._mc_decline_reasons, over
        assert any('fast path declined' in w for w in b['warnings'])
    assert 'n_batch_per_update > 1' in b['reasons']


def test_collective_budget_generic_fallback(pool):
    """The generic path (``n_batch_per_update=2`` declines the per-angle
    layout) reads the object through the halo gather, never a
    whole-object all-gather, and runs."""
    jc, tc, kw = problem(seed=10, mb=7, stride=4, grid=7,
                         n_batch_per_update=2, **PER_ANGLE)
    got, outs = _mesh_run(pool, tc, kw, 2, 2, n_epochs=1)
    assert not got['mc'] and got['halo']
    assert 'n_batch_per_update > 1' in got['reasons']
    for o in outs:
        assert not any(r['kind'] == 'all_gather'
                       for r in o['comm']['records'])
    assert np.isfinite(got['losses'][0])


def test_collective_budget_per_angle(pool):
    """The per-angle budget, read from the comm counter: per angle, one
    ring shift in (no padding above: ``h1 = 0``) and one out, one
    accumulator sum over 'dp', one auxiliary sum over the mesh; nothing
    else, and every shifted band no taller than the halo."""
    jc, tc, kw = problem(seed=1, **PER_ANGLE)
    got, outs = _mesh_run(pool, tc, kw, 2, 2, n_epochs=1)
    n_angles = len(kw['theta_ls'])
    assert (got['lay_h1'], got['lay_p0'], got['lay_p1']) == (0, 0, 0)
    for o in outs:
        c = comm_counts(o)
        assert c == {('ring_shift', 'op'): 2 * n_angles,
                     ('all_reduce', 'dp'): n_angles,
                     ('all_reduce', 'dp+op'): n_angles}, c
        for r in o['comm']['records']:
            if r['kind'] == 'ring_shift':
                assert r['shape'][0] <= got['lay_h2'] < 32
