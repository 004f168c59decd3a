"""The generic mesh path (any configuration the structured mesh paths
decline) on gloo ranks on the CPU, against the JAX package's GSPMD run on
its virtual mesh and the port's one-device run: the counterparts of
``tests/test_parallel.py`` and of ``tests/test_halo.py``'s reconstruction
tests.  Each rank runs its 'dp' share of a batch (the whole batch where
``data_axis`` does not divide it); the object is read through the halo
gather, or a counted all-gather where its geometry does not hold.  Losses
and gradients at rtol 1e-5 (objects and gradients at 1e-5 of the largest
value); GD trajectories likewise, 3e-5 across packages; Adam and the
second-order optimizers against the JAX package as its tests hold them."""

import dataclasses

import numpy as np
import pytest

import test_torch_mesh_ranks as C
from test_torch_mesh_setup import _one_torch_thread  # noqa: F401
from test_torch_mesh_setup import (close, close_obj, comm_counts, configs, jax_run,
                              pool_fixture, port_single, with_mesh)

pool = pool_fixture(4)


def _setup(seed=0, **train):
    """``tests/test_parallel.py``'s problem: a 32^2 x 4 object, a 16^2
    probe on a 5x5 grid at stride 4, 4 angles, minibatch 8 (no grid rows:
    the generic step)."""
    from adorym_tpu.simulate import simulate
    from adorym_tpu.utils.initialize import initialize_probe
    import adorym_tpu.config as jcfg
    n, pn = 32, 16
    tr = dict({'minibatch_size': 8, 'learning_rate': 1e-5, 'seed': seed},
              **train)
    jc, tc = configs(dict(obj_size=(n, n, 4), probe_size=(pn, pn),
                          energy_ev=5000.0, psize_cm=1e-7,
                          free_prop_cm='inf'), tr)
    rng = np.random.default_rng(seed)
    obj_true = np.stack([rng.random((n, n, 4)) * 1e-3,
                         rng.random((n, n, 4)) * 3e-5], -1).astype(np.float32)
    probe = np.asarray(initialize_probe(
        (pn, pn), 'gaussian', energy_ev=5000.0, psize_cm=1e-7,
        probe_mag_sigma=4, probe_phase_sigma=4, probe_phase_max=0.3))
    xs = np.arange(0, n - pn + 1, 4)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    theta_ls = np.linspace(0, np.pi, 4, endpoint=False)
    data = np.asarray(simulate(jcfg.ReconConfig(geometry=jc.geometry),
                               obj_true, probe, pos, theta_ls))
    # Half the truth, not zero: at a zero object the Gaussian probe's far
    # field underflows and the gradients are f32 noise in both packages.
    kw = dict(data=data, probe_pos=pos, probe_init=probe,
              theta_ls=theta_ls, obj_init=(obj_true * 0.5).copy())
    return jc, tc, kw, obj_true


def _mesh_run(pool, tc, kw, dp, op, n_epochs=2, **kwargs):
    out = pool.run(C.recon_run, with_mesh(tc, dp, op), kw, n_epochs,
                   **kwargs)
    return out[0], out


def test_dp_gradients_match_single_device(pool):
    """A batch's loss and gradients over a 'dp' split (two spots a rank,
    summed over 'dp') equal the one-device ones and the JAX package's."""
    import jax
    import jax.numpy as jnp
    import torch
    jc, tc, kw, _ = _setup()
    inds = np.arange(8)
    got = pool.run(C.grad_step, with_mesh(tc, 4, 1), kw, 1, inds)[0]
    import adorym_tpu_torch as pt
    rec = pt.Reconstructor(tc, device='cpu', **kw)
    l1, g1 = rec._grad_step(1, inds, torch.as_tensor(kw['data'][1][inds]))
    close(got['loss'], float(l1), 1e-5)
    close_obj(got['g_obj'], g1['obj'].numpy(), 1e-5)
    from adorym_tpu.recon import Reconstructor
    jrec = Reconstructor(jc, **kw)
    batch = {'i_theta': jnp.asarray(1), 'theta': jnp.asarray(
        kw['theta_ls'][1], jnp.float32),
        'pos_batch': jnp.asarray(kw['probe_pos'][:8], jnp.float32),
        'ind_batch': jnp.arange(8)}
    lj, gj = jax.jit(jax.value_and_grad(jrec.loss_fn))(
        jrec.params, batch, jnp.asarray(kw['data'][1][:8]), None)
    # The packages' one-device gradients differ by 1.0e-5 of the largest
    # value here already.
    close(got['loss'], float(lj), 1e-5)
    close_obj(got['g_obj'], np.asarray(gj['obj']), 2e-5)


def test_dp_loss_trajectory_matches(pool):
    """GD over a (4, 1) mesh: the trajectory of the one-device run and of
    the JAX package's mesh run."""
    jc, tc, kw, _ = _setup(optimizer='gd', learning_rate=1e-4)
    one = port_single(tc, kw, 3)
    got, outs = _mesh_run(pool, tc, kw, 4, 1, n_epochs=3)
    assert not got['mc'] and not got['mci']
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)
    ref = jax_run(jc, kw, 3, 4, 1)
    close(got['losses'], ref['losses'], 1e-5)
    close_obj(got['obj'], ref['obj'], 3e-5)
    # Each batch's gradients and loss in one sum over 'dp'.
    n_b = 4 * 4 * 3
    assert comm_counts(outs[1]) == {('all_reduce', 'dp'): n_b}


def test_object_sharded_matches(pool):
    """The object split over 'op' (the distributed object) with a 'dp'
    split: the halo gather, the trajectory of the one-device run and of
    the JAX package's (2, 2) run."""
    jc, tc, kw, _ = _setup(seed=1, optimizer='gd', learning_rate=1e-4)
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    assert got['halo']
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)
    ref = jax_run(jc, kw, 2, 2, 2)
    close(got['losses'], ref['losses'], 1e-5)
    close_obj(got['obj'], ref['obj'], 3e-5)


def test_adam_object_sharded_against_jax(pool):
    """Adam on the generic path over (2, 2), against the JAX package's
    mesh run as ``tests/test_parallel.py`` holds it (rtol 2e-2)."""
    jc, tc, kw, _ = _setup(seed=1)
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    ref = jax_run(jc, kw, 2, 2, 2)
    close(got['losses'], ref['losses'], 2e-2)


def test_object_stays_sharded(pool):
    """After an epoch each rank still holds its y slab alone."""
    jc, tc, kw, _ = _setup(seed=2)
    got, outs = _mesh_run(pool, tc, kw, 1, 4, n_epochs=1)
    for o in outs:
        assert o['slab_shape'] == (8, 32, 4, 2)
        assert o['state_shapes']['m'] == (8, 32, 4, 2)


@pytest.mark.parametrize('use_halo', ['auto', False])
def test_halo_gather_avoids_full_object_allgather(pool, use_halo):
    """Sharded memory: with the halo gather a step gathers no object;
    without it (``use_halo_gather=False``) each step's object read is one
    counted all-gather — why the halo gather exists."""
    import adorym_tpu_torch as pt
    jc, tc, kw, _ = _setup(seed=0)
    tc = dataclasses.replace(tc, train=dataclasses.replace(
        tc.train, minibatch_size=4, update_scheme='per angle',
        rotate_out_of_loop=True))
    cfg = with_mesh(tc, 4 // 2, 2, use_halo_gather=use_halo)
    got = pool.run(C.grad_step, cfg, kw, 0, np.arange(4))
    gathers = comm_counts(got[0]).get(('all_gather', 'op'), 0)
    if use_halo == 'auto':
        assert got[0]['halo'] and gathers == 0
    else:
        assert not got[0]['halo'] and gathers >= 1
    rec = pt.Reconstructor(tc, device='cpu', **kw)
    import torch
    l1, g1 = rec._grad_step(0, np.arange(4),
                            torch.as_tensor(kw['data'][0][:4]))
    close(got[0]['loss'], float(l1), 1e-5)
    close_obj(got[0]['g_obj'], g1['obj'].numpy(), 1e-5)


@pytest.mark.parametrize('optimizer', ['cg', 'curveball'])
def test_second_order_under_dp_mesh(pool, optimizer):
    """CG's line search and Curveball's Gauss-Newton products over a
    (4, 1) mesh: losses summed over 'dp'; one epoch's trajectory (16
    updates) tracks the one-device run (rtol 1e-4) and the JAX package's
    mesh run (rtol 2e-2, as its test, which runs two)."""
    jc, tc, kw, obj_true = _setup(seed=3, optimizer=optimizer,
                                  learning_rate=1e-4)
    one = port_single(tc, kw, 1)
    got, _ = _mesh_run(pool, tc, kw, 4, 1, n_epochs=1)
    close(got['losses'], one['losses'], 1e-4)
    ref = jax_run(jc, kw, 1, 4, 1)
    close(got['losses'], ref['losses'], 2e-2)


def test_second_order_object_split(pool):
    """CG with the object split over 'op': its dot products summed over
    the slabs; the trajectory tracks the one-device run."""
    jc, tc, kw, obj_true = _setup(seed=3, optimizer='cg',
                                  learning_rate=1e-4)
    one = port_single(tc, kw, 1)
    got, _ = _mesh_run(pool, tc, kw, 2, 2, n_epochs=1)
    close(got['losses'], one['losses'], 1e-4)


def test_halo_gather_in_reconstruction(pool):
    """A reconstruction through the halo gather equals one through the
    all-gather of the object (``use_halo_gather`` True and False)."""
    jc, tc, kw, _ = _setup(seed=3)
    tc = dataclasses.replace(tc, geometry=dataclasses.replace(
        tc.geometry, probe_size=(8, 8)))
    kw = dict(kw, probe_init=kw['probe_init'][..., 4:12, 4:12, :]
              if kw['probe_init'].ndim == 4 else kw['probe_init'])
    xs = np.arange(0, 25, 8)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    kw['probe_pos'] = pos
    kw['data'] = kw['data'][:, :len(pos), 4:12, 4:12]
    runs = {}
    for use in (True, False):
        cfg = dataclasses.replace(tc, parallel=dataclasses.replace(
            tc.parallel, use_halo_gather=use))
        runs[use], _ = _mesh_run(pool, cfg, kw, 2, 2)
    assert runs[True]['halo'] and not runs[False]['halo']
    close(runs[True]['losses'], runs[False]['losses'], 1e-5)
    close_obj(runs[True]['obj'], runs[False]['obj'], 1e-5)


def test_multidist_halo_gather_no_allgather(pool):
    """The multi-distance model's tiles through the halo gather (its
    ``gather_window``): the loss and gradient of the one-device run and
    of the JAX package's, and no object gathered."""
    import jax
    import jax.numpy as jnp
    import torch
    from scipy.ndimage import gaussian_filter
    import adorym_tpu_torch as pt
    from adorym_tpu.models import multidist as jmd
    from adorym_tpu.recon import Reconstructor
    from adorym_tpu.simulate import simulate
    from adorym_tpu.utils.initialize import initialize_probe
    from adorym_tpu_torch.models import multidist as tmd
    n, sub, szw = 64, 16, 4
    rng = np.random.default_rng(5)
    ph = gaussian_filter(rng.normal(size=(n, n, 1)), (3, 3, 0))
    ph = ph / np.abs(ph).max() * 0.3
    obj_true = np.stack([np.cos(ph), np.sin(ph)], -1).astype(np.float32)
    geo = dict(obj_size=(n, n, 1), probe_size=(sub, sub),
               energy_ev=17500.0, psize_cm=1e-5, free_prop_cm=(0.05, 0.12),
               n_dists=2, two_d_mode=True, safe_zone_width=szw)
    jc, tc = configs(geo, dict(minibatch_size=4, learning_rate=1e-3,
                               unknown_type='real_imag'),
                     loss=dict(raw_data_type='intensity'))
    probe = np.asarray(initialize_probe((n, n), 'plane'))
    xs = np.arange(0, n, sub, dtype=float)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1)
    data = np.asarray(simulate(jc, obj_true, probe, pos, model=jmd)) ** 2
    obj0 = np.stack([np.ones((n, n, 1)), np.zeros((n, n, 1))],
                    -1).astype(np.float32)
    kw = dict(data=data, probe_pos=pos, probe_init=probe, obj_init=obj0)
    inds = np.arange(4)
    got = pool.run(C.multidist_grad_case, with_mesh(tc, 2, 2), kw,
                   inds)[0]
    assert got['halo']
    assert comm_counts(got).get(('all_gather', 'op'), 0) == 0
    rec = pt.Reconstructor(tc, device='cpu', model=tmd, **kw)
    rows = tmd.expand_indices(inds, rec.n_pos, tc)
    l1, g1 = rec._grad_step(0, inds, torch.as_tensor(data[0][rows]))
    close(got['loss'], float(l1), 1e-5)
    close_obj(got['g_obj'], g1['obj'].numpy(), 1e-5)
    jrec = Reconstructor(jc, model=jmd, **kw)
    batch = {'i_theta': jnp.asarray(0), 'theta': jnp.asarray(0.0),
             'pos_batch': jnp.asarray(pos[inds], jnp.float32),
             'ind_batch': jnp.asarray(inds)}
    lj, gj = jax.jit(jax.value_and_grad(jrec.loss_fn))(
        jrec.params, batch, jnp.asarray(data[0][rows]), None)
    close(got['loss'], float(lj), 1e-5)
    close_obj(got['g_obj'], np.asarray(gj['obj']), 1e-5)


def test_per_angle_whole_object_branch(pool):
    """The per-angle scheme on a table that is not grid rows (randomized
    positions): each angle's chunks through the model on the rotated
    slabs, 'dp' shares of every batch; the GD trajectory of the one-device
    run."""
    from test_torch_mesh_setup import problem
    jc, tc, kw = problem(seed=16, update_scheme='per angle',
                         rotate_out_of_loop=True, randomize_probe_pos=True,
                         optimizer='gd', learning_rate=1e-3)
    one = port_single(tc, kw, 2)
    assert one['rec']._angles and not one['rec']._patch_mode
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    assert not got['mc'] and got['halo']
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)


def test_tilt_reads_the_whole_object(pool):
    """Tilt rotates about three axes, not plane by plane: the generic path
    gathers the object (one counted all-gather a batch) and matches the
    one-device run."""
    from test_torch_mesh_setup import problem
    jc, tc, kw = problem(seed=18, optimizer='gd', learning_rate=1e-3,
                         refine=dict(fixed_tilt=True), n_theta=2)
    n_theta = len(kw['theta_ls'])
    kw['aux_init'] = {'tilt_ls': np.stack(
        [kw['theta_ls'] + 0.01, np.full(n_theta, 0.01),
         np.full(n_theta, -0.005)]).astype(np.float32)}
    one = port_single(tc, kw, 1)
    got, outs = _mesh_run(pool, tc, kw, 2, 2, n_epochs=1)
    assert not got['halo']
    assert comm_counts(outs[0])[('all_gather', 'op')] == 2 * 4
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)


def test_two_d_per_angle(pool):
    """A 2D object on the per-angle mesh path (no rotation)."""
    from test_torch_mesh_setup import problem
    jc, tc, kw = problem(seed=20, nz=1, binning=1, n_theta=1,
                         update_scheme='per angle', rotate_out_of_loop=True,
                         optimizer='gd', learning_rate=1e-3)
    tc = dataclasses.replace(tc, geometry=dataclasses.replace(
        tc.geometry, two_d_mode=True))
    one = port_single(tc, kw, 2)
    got, _ = _mesh_run(pool, tc, kw, 2, 2)
    assert got['mc'], got['reasons']
    close(got['losses'], one['losses'], 1e-5)
    close_obj(got['obj'], one['obj'], 1e-5)
