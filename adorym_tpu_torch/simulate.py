"""Forward simulation of measurement data (``adorym_tpu/simulate.py``):
the port's forward model (ptychography, or with ``model=`` the
multi-distance model's holograms; each with its projection, sparse and
CTF branches as the geometry and ``forward_algorithm`` select them) on a
known object, without autograd, on
the run's device (CUDA unless the caller passes ``device='cpu'``), written
to the reference's HDF5 layout by :func:`simulate_to_file`."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .config import RefineConfig, ReconConfig
from .models import ptychography as ptycho_model
from .ops import patches as patch_ops
from .recon import resolve_device


def simulate(cfg: ReconConfig, obj: np.ndarray, probe: np.ndarray,
             probe_pos: np.ndarray, theta_ls: Optional[np.ndarray] = None,
             return_wave: bool = False, minibatch_size: int = 0,
             model=None, device=None) -> np.ndarray:
    """Diffraction data for every (angle, scan position):
    ``[n_theta, n_pos, py, px]`` float32 magnitudes, or with
    ``return_wave`` mode 0's complex exit waves.

    ``obj`` ``[y, x, z, 2]``, ``probe`` ``[n_modes, py, px, 2]``,
    ``probe_pos`` ``[n_pos, 2]`` pixels, ``theta_ls`` in rad (default one
    angle at 0).  The bare forward model runs: the config's refinements
    are switched off.  ``model``: the forward model (default ptychography;
    a geometry of several distances needs :mod:`.models.multidist`, whose
    batches of blocks give the holograms of every distance, so that a
    batch of all ``n_pos`` blocks lays them out as the data file does,
    ``[n_theta, n_dists * n_pos, sy, sx]``)."""
    geo = cfg.geometry
    model = model or ptycho_model
    if model is ptycho_model and (
            geo.n_dists > 1 or (geo.free_prop_cm is not None
                                and not isinstance(geo.free_prop_cm, str)
                                and np.size(geo.free_prop_cm) > 1)):
        raise ValueError('several distances: pass '
                         'model=adorym_tpu_torch.models.multidist')
    cfg = dataclasses.replace(cfg, refine=RefineConfig())
    obj = np.asarray(obj)
    probe = np.asarray(probe)
    if obj.ndim != 4 or obj.shape[-1] != 2:
        raise ValueError(f'obj must be [y, x, z, 2], got {obj.shape}')
    if probe.ndim != 4 or probe.shape[-1] != 2:
        raise ValueError(
            f'probe must be [n_modes, py, px, 2], got {probe.shape}')
    if theta_ls is None:
        theta_ls = np.zeros(1)
    dev = resolve_device(device)
    probe_pos = np.asarray(probe_pos, dtype=np.float64)
    n_pos = len(probe_pos)
    compute_pad = getattr(model, 'compute_pad', None)
    if compute_pad is not None:
        pad_arr = compute_pad(cfg, geo.obj_size[:2], probe_pos)
    else:
        pad_arr = patch_ops.calculate_pad(geo.obj_size[:2], probe_pos,
                                          geo.probe_size)
    params = {'obj': torch.as_tensor(obj, dtype=torch.float32, device=dev),
              'probe': torch.as_tensor(probe, dtype=torch.float32,
                                       device=dev)}
    mb = minibatch_size or n_pos
    if not minibatch_size:
        # Cap the default batch so the full-depth patch stack stays near
        # 512 MB.
        per_pos = int(np.prod(geo.probe_size)) * geo.obj_size[2] * 2 * 4
        mb = max(1, min(mb, int(512e6 // max(1, per_pos))))
    out = []
    with torch.no_grad():
        for i_theta, theta in enumerate(np.asarray(theta_ls, np.float32)):
            per_angle = []
            for b0 in range(0, n_pos, mb):
                inds = np.arange(b0, min(b0 + mb, n_pos))
                batch = {'i_theta': i_theta, 'theta': float(theta),
                         'pos_batch': probe_pos[inds].astype(np.float32),
                         'ind_batch': inds}
                pred = model.predict(params, batch, cfg, pad_arr,
                                     return_wave=return_wave)
                if return_wave:
                    pred = pred[0]       # mode 0's complex wave
                per_angle.append(pred.cpu().numpy())
            out.append(np.concatenate(per_angle, axis=0))
    return np.stack(out, axis=0)


def _file_metadata(cfg, theta_ls, probe_pos):
    fp = cfg.geometry.free_prop_cm
    return dict(theta=theta_ls, probe_pos=probe_pos,
                energy_ev=cfg.geometry.energy_ev,
                psize_cm=cfg.geometry.psize_cm,
                free_prop_cm=None if isinstance(fp, str) else fp)


def simulate_to_file(path: str, cfg: ReconConfig, obj, probe, probe_pos,
                     theta_ls=None, use_checkpoint: bool = False, **kwargs):
    """Simulate and write the reference-layout HDF5 file; returns the
    data.  ``use_checkpoint``: write angle by angle with an ``i_theta``
    resume file beside the data file (``<path>.sim_checkpoint_i_theta.txt``),
    so that a killed simulation restarts where it stopped; the resume file
    is removed at the end."""
    from .io.data import _h5py, write_data_file
    if not use_checkpoint:
        data = simulate(cfg, obj, probe, probe_pos, theta_ls, **kwargs)
        write_data_file(path, data, **_file_metadata(cfg, theta_ls,
                                                     probe_pos))
        return data
    h5py = _h5py()
    if theta_ls is None:
        theta_ls = np.zeros(1)
    ckpt = path + '.sim_checkpoint_i_theta.txt'
    start = 0
    if os.path.exists(ckpt) and os.path.exists(path):
        start = int(np.loadtxt(ckpt).ravel()[0])
    if start == 0:
        # One angle gives the per-angle shape; the whole dataset is made
        # at once and later angles land in place.
        first = simulate(cfg, obj, probe, probe_pos, theta_ls[:1], **kwargs)
        write_data_file(path, np.zeros((len(theta_ls),) + first.shape[1:],
                                       first.dtype),
                        **_file_metadata(cfg, theta_ls, probe_pos))
        with h5py.File(path, 'r+') as f:
            f['exchange/data'][0] = first[0]
        start = 1
        np.savetxt(ckpt, [start], fmt='%d')
    for i_theta in range(start, len(theta_ls)):
        per_angle = simulate(cfg, obj, probe, probe_pos,
                             theta_ls[i_theta:i_theta + 1], **kwargs)
        with h5py.File(path, 'r+') as f:
            f['exchange/data'][i_theta] = per_angle[0]
        np.savetxt(ckpt, [i_theta + 1], fmt='%d')
    os.remove(ckpt)
    with h5py.File(path, 'r') as f:
        return f['exchange/data'][...]
