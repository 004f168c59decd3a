"""Inputs and reference runs for the mesh tests (``tests/test_torch_mesh_
*.py``): the same seeded problems as the JAX package's mesh tests, as a
config of each package, and the three runs each test compares: the port on
gloo ranks (``tests/test_torch_mesh_ranks.py``, sent to a
:class:`~adorym_tpu_torch.parallel.launch.RankPool`), the JAX package on
its virtual CPU mesh of the same shape, and the port on one device."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import adorym_tpu.config as jcfg
import adorym_tpu_torch as pt
from adorym_tpu.simulate import simulate
from adorym_tpu.utils.initialize import initialize_probe


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors (several test
    workers share the cores; with more threads the CPU's reductions are
    not reproducible bit for bit)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pool_fixture(world):
    """A module-scoped fixture: ``world`` gloo ranks on the CPU."""
    @pytest.fixture(scope='module')
    def pool():
        from adorym_tpu_torch.parallel.launch import RankPool
        p = RankPool(world, 'cpu', timeout_s=240)
        yield p
        p.close()
    return pool


def configs(geometry, train, loss=None, refine=None, parallel=None):
    """``(jax_cfg, port_cfg)`` from the same section keywords."""
    out = []
    for mod in (jcfg, pt):
        out.append(mod.ReconConfig(
            geometry=mod.Geometry(**geometry),
            train=mod.TrainConfig(**train),
            loss=mod.LossConfig(**(loss or {})),
            refine=mod.RefineConfig(**(refine or {})),
            parallel=mod.ParallelConfig(**(parallel or {}))))
    return tuple(out)


def with_mesh(cfg, dp, op, **par):
    """``cfg`` (of either package) on a ``dp x op`` mesh."""
    return dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, data_axis=dp, object_axis=op, **par))


def problem(seed=0, n=32, nz=8, pn=8, stride=8, mb=4, binning=2,
            n_theta=3, grid=None, **train):
    """The JAX package's ``tests/test_mc_patch.py`` / ``test_mc_imm.py``
    problem: a random delta/beta object, a Gaussian probe, a grid of
    ``grid`` (default: as many as fit) spots at ``stride``, data simulated
    by the JAX package from the geometry alone.  Returns ``(jax_cfg,
    port_cfg, kw)``; ``kw`` starts the object at half the truth."""
    geo = dict(obj_size=(n, n, nz), probe_size=(pn, pn), energy_ev=5000.0,
               psize_cm=1e-7, free_prop_cm='inf', binning=binning)
    tr = {'minibatch_size': mb, 'learning_rate': 1e-4, 'seed': seed,
          **train}
    extra = {k: tr.pop(k) for k in ('loss', 'refine') if k in tr}
    jc, tc = configs(geo, tr, **extra)
    rng = np.random.default_rng(seed)
    obj_true = np.stack([rng.random((n, n, nz)) * 1e-3,
                         rng.random((n, n, nz)) * 3e-5], -1).astype(np.float32)
    probe = initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                             psize_cm=1e-7, probe_mag_sigma=2,
                             probe_phase_sigma=2, probe_phase_max=0.3)
    xs = (np.arange(0, n - pn + 1, stride) if grid is None
          else np.arange(grid) * stride)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    theta_ls = np.linspace(0, np.pi, n_theta, endpoint=False)
    geo_only = jcfg.ReconConfig(geometry=jc.geometry)
    data = np.asarray(simulate(geo_only, obj_true, probe, pos, theta_ls))
    kw = dict(data=data, probe_pos=pos, probe_init=np.asarray(probe),
              theta_ls=theta_ls, obj_init=(obj_true * 0.5).copy())
    return jc, tc, kw


def jax_run(jc, kw, n_epochs, dp=1, op=1, callback=False, **rec_kw):
    """The JAX package's run on its virtual ``dp x op`` mesh (one device
    at 1 x 1): per-epoch losses, the object, the probe, the run."""
    from adorym_tpu.recon import Reconstructor
    mesh = None
    if dp * op > 1:
        from adorym_tpu.parallel.mesh import make_mesh
        jc = with_mesh(jc, dp, op)
        mesh = make_mesh(jc.parallel)
    rec = Reconstructor(jc, mesh=mesh, **kw, **rec_kw)
    cb = []
    losses = [rec.run_epoch(ep, callback=(lambda e, b, l: cb.append(
        (e, b, l))) if callback else None) for ep in range(n_epochs)]
    return {'losses': losses, 'obj': np.asarray(rec.params['obj']),
            'probe': np.asarray(rec.params['probe']), 'rec': rec,
            'batch_losses': cb}


def port_single(tc, kw, n_epochs, callback=False, **rec_kw):
    """The port on one CPU device."""
    rec = pt.Reconstructor(tc, device='cpu', **kw, **rec_kw)
    cb = []
    losses = [rec.run_epoch(ep, callback=(lambda e, b, l: cb.append(
        (e, b, l))) if callback else None) for ep in range(n_epochs)]
    return {'losses': losses, 'obj': rec.obj,
            'probe': rec.params['probe'].numpy(), 'rec': rec,
            'batch_losses': cb}


def close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def comm_counts(out, epoch0=False):
    """``{(kind, axis): count}`` of a rank's records."""
    recs = (out['comm_epoch0'] if epoch0 else out['comm'])['records']
    c = {}
    for r in recs:
        c[(r['kind'], r['axis'])] = c.get((r['kind'], r['axis']), 0) + 1
    return c


def close_obj(a, b, rtol=1e-5):
    """Objects agree within ``rtol`` of the larger one's largest value
    (near-zero voxels carry the reductions' f32 noise)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = float(np.max(np.abs(b)))
    err = float(np.max(np.abs(a - b)))
    assert err <= rtol * scale, (err, scale, rtol)


def close_across(got, ref, one, ref1):
    """The two packages' mesh runs (``got``, ``ref``) agree within twice
    the two packages' own one-device spread (``one``, ``ref1``): the mesh
    adds no error of its own; or within the usual bounds (losses at rtol
    1e-5, objects at 3e-5 of the largest value), whichever is wider.
    Runs whose loss grows spread further between the packages than
    converging ones."""
    gl, rl = np.asarray(got['losses']), np.asarray(ref['losses'])
    spread = np.abs(np.asarray(one['losses']) - np.asarray(ref1['losses']))
    assert np.all(np.abs(gl - rl) <= np.maximum(2 * spread,
                                                1e-5 * np.abs(rl))), (
        gl, rl, spread)
    so = np.abs(one['obj'] - ref1['obj']).max()
    err = np.abs(got['obj'] - ref['obj']).max()
    assert err <= max(2 * so, 3e-5 * np.abs(ref['obj']).max()), (err, so)
