"""The port's whole slice — the per-angle, rotate-out-of-loop epoch —
against the JAX package's Reconstructor on the same inputs, plus the
port's package boundary: no JAX, CUDA by default, no silent CPU fallback.

JAX runs with ``fused_multislice='on'`` so it reaches the Pallas kernel in
interpret mode; the port's ``'on'`` on the CPU runs the kernel's plain
version.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import adorym_tpu.config as jcfg
from adorym_tpu.recon import Reconstructor as JaxReconstructor
import adorym_tpu_torch as pt
from adorym_tpu_torch import convert

REPO = Path(__file__).resolve().parents[1]


def _setup(n=32, pn=16, n_theta=3, k=4, stride=4, seed=0):
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, np.pi, n_theta, endpoint=False)
    xs = np.arange(k) * stride
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    data = rng.random((n_theta, len(pos), pn, pn)).astype(np.float32)
    obj0 = (rng.random((n, n, n, 2)) * 1e-3).astype(np.float32)
    return data, pos, theta, obj0


def _cfg(mod, optimizer='gd', lr=1e-3, fused='on', zmajor='on', bf16=False,
         n=32, pn=16, mb=4, binning=2, **train):
    return mod.ReconConfig(
        geometry=mod.Geometry(obj_size=(n, n, n), probe_size=(pn, pn),
                              energy_ev=5000., psize_cm=1e-7,
                              free_prop_cm='inf', binning=binning),
        train=mod.TrainConfig(minibatch_size=mb, learning_rate=lr,
                              optimizer=optimizer, rotate_out_of_loop=True,
                              update_scheme='per angle',
                              fused_multislice=fused, zmajor_extract=zmajor,
                              run_bfloat16=bf16, **train))


def _both(n_epochs, **kw):
    data, pos, theta, obj0 = _setup()
    jr = JaxReconstructor(_cfg(jcfg, **kw), data=data, probe_pos=pos,
                          theta_ls=theta, obj_init=obj0.copy())
    tr = pt.Reconstructor(_cfg(pt, **kw), data=data, probe_pos=pos,
                          theta_ls=theta, obj_init=obj0.copy(), device='cpu')
    jl = [jr.run_epoch(e) for e in range(n_epochs)]
    tl = [tr.run_epoch(e) for e in range(n_epochs)]
    return (np.asarray(jl), np.asarray(tl), np.asarray(jr.params['obj']),
            tr.obj, obj0)


@pytest.mark.parametrize('fused,zmajor', [('on', 'on'), ('off', 'off'),
                                          ('auto', 'auto')])
def test_gd_trajectory_matches_jax(fused, zmajor):
    """Plain GD over 3 epochs: losses to rtol 1e-5, the object's total
    update to 1e-4 of its largest entry (f32 noise of FFT vs DFT-matmul
    propagation and of the scatter's summation order)."""
    jl, tl, jo, to, obj0 = _both(3, fused=fused, zmajor=zmajor)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.max(np.abs(to - jo)) < 1e-4 * np.max(np.abs(jo - obj0))


def test_bf16_gd_trajectory_matches_jax():
    """run_bfloat16: the same bf16 patches into the same kernel math; the
    records round to bf16 in the Pallas kernel only, so the losses agree
    to 1e-4 and the updates to 1e-2."""
    jl, tl, jo, to, obj0 = _both(2, bf16=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert np.max(np.abs(to - jo)) < 1e-2 * np.max(np.abs(jo - obj0))


def test_adam_epoch_matches_jax_loosely():
    """Adam normalizes each entry's step, so f32 noise in a near-zero
    gradient can flip the entry's step sign: compare the loss tightly and
    the update only loosely."""
    jl, tl, jo, to, obj0 = _both(2, optimizer='adam', lr=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.mean(np.abs(to - jo)) < 1e-2 * np.mean(np.abs(jo - obj0))


def test_convert_carries_state_across():
    """A JAX run continued in the port after params_from_jax takes the
    same next epoch as the JAX run itself."""
    data, pos, theta, obj0 = _setup(seed=1)
    kw = dict(optimizer='adam', lr=1e-5)
    jr = JaxReconstructor(_cfg(jcfg, **kw), data=data, probe_pos=pos,
                          theta_ls=theta, obj_init=obj0.copy())
    jr.run_epoch(0)
    tr = pt.Reconstructor(_cfg(pt, **kw), data=data, probe_pos=pos,
                          theta_ls=theta, device='cpu')
    params, state = convert.params_from_jax(
        {k: np.asarray(v) for k, v in jr.params.items()},
        {k: {n: np.asarray(a) for n, a in st.items()}
         for k, st in jr.opt_state.items()}, device='cpu')
    tr.params, tr.opt_state = params, state
    tr.i_opt_batch, tr.global_batch = jr.i_opt_batch, jr.global_batch
    np.testing.assert_allclose(tr.run_epoch(1), jr.run_epoch(1), rtol=1e-5)
    back, back_state = convert.params_to_numpy(tr.params, tr.opt_state)
    assert set(back) == set(jr.params) and set(back_state) == {'obj'}
    assert back['obj'].shape == np.asarray(jr.params['obj']).shape


def test_flagship_chunking_matches_jax_on_cpu():
    """The port's chunk budget gives the JAX package's fuse_g and grid
    scatter rows on the CPU, and a whole angle per chunk at the flagship
    (23 rows of the 23x23 grid)."""
    xs = np.arange(23) * 8 - 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    data = np.zeros((1, len(pos), 72, 72), np.float32)
    obj0 = np.zeros((256, 256, 256, 2), np.float32)
    kw = dict(optimizer='adam', lr=1e-7, n=256, pn=72, mb=23, binning=8,
              fused='auto', zmajor='auto')
    jr = JaxReconstructor(_cfg(jcfg, **kw), data=data, probe_pos=pos,
                          obj_init=obj0)
    tr = pt.Reconstructor(_cfg(pt, **kw), data=data, probe_pos=pos,
                          obj_init=obj0, device='cpu')
    assert jr._data_dev_ok
    assert (tr._fuse_g, tr._grid_scatter_rows) == (jr._fuse_g,
                                                   jr._grid_scatter_rows)
    assert tr._grid_scatter_rows == 23
    np.testing.assert_array_equal(tr.pad_arr, jr.pad_arr)


def test_make_batches_same_draws():
    data, pos, theta, obj0 = _setup()
    jr = JaxReconstructor(_cfg(jcfg), data=data, probe_pos=pos,
                          theta_ls=theta, obj_init=obj0)
    tr = pt.Reconstructor(_cfg(pt), data=data, probe_pos=pos,
                          theta_ls=theta, obj_init=obj0, device='cpu')
    for seed in range(3):
        jb = jr.make_batches(np.random.default_rng(seed))
        tb = tr.make_batches(np.random.default_rng(seed))
        assert [(i, list(b)) for i, b in jb] == [(i, list(b)) for i, b in tb]


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    data, pos, theta, obj0 = _setup()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        pt.Reconstructor(_cfg(pt), data=data, probe_pos=pos, obj_init=obj0)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        pt.Reconstructor(_cfg(pt), data=data, probe_pos=pos, obj_init=obj0,
                         device='cuda')


@pytest.mark.parametrize('section,kw,exc,match', [
    ('parallel', dict(offload_optimizer_state=True, data_axis=2),
     ValueError, 'device meshes'),
    ('parallel', dict(data_axis=2), ValueError, 'device meshes'),
    ('parallel', dict(object_axis=2), ValueError, 'device meshes'),
    ('parallel', dict(offload_object=True), ValueError,
     'offload_object requires: offload_optimizer_state')])
def test_unported_configs_raise(section, kw, exc, match):
    """What the per-angle path refuses: a config that asks for a mesh (with offload too) without one (no process
    group, no ``mesh=``), a ValueError rather than a one-device run; and
    object offload without offloaded moments, the JAX package's
    ``ValueError``."""
    data, pos, theta, obj0 = _setup()
    cfg = _cfg(pt)
    cfg = cfg.replace(**{section: dataclasses.replace(getattr(cfg, section),
                                                      **kw)})
    with pytest.raises(exc, match=match):
        pt.Reconstructor(cfg, data=data, probe_pos=pos, obj_init=obj0,
                         device='cpu')


@pytest.mark.parametrize('section,kw', [('io', dict(use_orbax=True))],
                         ids=['orbax'])
def test_orbax_per_angle_runs_and_writes_sharded_checkpoint(tmp_path, section,
                                                            kw):
    """``use_orbax=True`` on the per-angle path: the epoch runs and its
    checkpoint is the sharded form (``checkpoint/dcp/``)."""
    data, pos, theta, obj0 = _setup()
    cfg = _cfg(pt)
    cfg = cfg.replace(**{section: dataclasses.replace(getattr(cfg, section),
                                                      **kw)})
    rec = pt.Reconstructor(cfg, data=data, probe_pos=pos, theta_ls=theta,
                           obj_init=obj0, device='cpu',
                           output_folder=str(tmp_path))
    assert rec._angles and np.isfinite(rec.run_epoch(0))
    rec.save_checkpoint(1, 0)
    assert (tmp_path / 'checkpoint' / 'dcp' / '.metadata').is_file()
    assert not (tmp_path / 'checkpoint' / 'checkpoint.npz').exists()


def test_non_grid_scan_raises():
    """A jittered (non-grid) table on the per-angle path cannot keep its
    object on the host (the JAX package's ``ValueError``: object offload
    needs the patch-granular path); without it the table runs, through
    the whole-object branch, one update an angle."""
    data, pos, theta, obj0 = _setup()
    pos = pos + np.random.default_rng(0).integers(0, 3, pos.shape)
    cfg = _cfg(pt)
    with pytest.raises(ValueError, match='patch-granular prebin angle path'):
        pt.Reconstructor(cfg.replace(parallel=dataclasses.replace(
            cfg.parallel, offload_object=True)), data=data, probe_pos=pos,
            obj_init=obj0, device='cpu')
    rec = pt.Reconstructor(cfg, data=data, probe_pos=pos, theta_ls=theta,
                           obj_init=obj0, device='cpu')
    assert rec._angles and not rec._patch_mode
    assert np.isfinite(rec.run_epoch(0)) and rec.i_opt_batch == 3


def test_import_pulls_in_no_jax():
    code = ('import sys, adorym_tpu_torch, adorym_tpu_torch.convert; '
            'bad = sorted(m for m in sys.modules if m == "jax" '
            'or m.startswith("jax.") or m == "adorym_tpu" '
            'or m.startswith("adorym_tpu.")); print(bad); '
            'sys.exit(1 if bad else 0)')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_import_no_jax_or_reference_package():
    pat = re.compile(r'^\s*(import|from)\s+(jax\b|adorym_tpu(?!_torch)\b)',
                     re.M)
    for path in list((REPO / 'adorym_tpu_torch').rglob('*.py')) + [
            REPO / 'chip_smoke.py']:
        assert not pat.search(path.read_text()), path
