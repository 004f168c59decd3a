"""Run outputs in the reference's tree (``adorym_tpu/io/output.py``):

  output_folder/
    convergence/loss_rank_0.txt     i_epoch,i_batch,loss,time
    delta_ds_1.tiff, beta_ds_1.tiff (obj_mag / obj_phase for real_imag)
    probe_mag_ds_1.tiff, probe_phase_ds_1.tiff
    intermediate/ ...               the same names, dumped during the run,
                                    and the refined parameters' history
                                    (probe_pos/, prj_affine/, ...)
    summary.txt

TIFFs are float32, single- or multi-page, through Pillow (mode ``'F'``),
which is imported when a TIFF is read or written, not with the package.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import Optional

import numpy as np


def write_tiff(arr, path) -> str:
    """Write a 2D array as a float32 TIFF, or a 3D one as a multi-page
    TIFF; ``.tiff`` is appended to a path without a TIFF suffix."""
    from PIL import Image
    arr = np.asarray(arr, dtype=np.float32)
    path = str(path)
    if not path.endswith(('.tif', '.tiff')):
        path = path + '.tiff'
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if arr.ndim == 2:
        Image.fromarray(arr, mode='F').save(path)
    elif arr.ndim == 3:
        frames = [Image.fromarray(a, mode='F') for a in arr]
        frames[0].save(path, save_all=True, append_images=frames[1:])
    else:
        raise ValueError(f'cannot write {arr.ndim}-D array as TIFF')
    return path


def read_tiff(path) -> np.ndarray:
    """A TIFF's pages as float32: one page as 2D, several stacked."""
    from PIL import Image, ImageSequence
    with Image.open(path) as img:
        frames = [np.asarray(f, dtype=np.float32)
                  for f in ImageSequence.Iterator(img)]
    return frames[0] if len(frames) == 1 else np.stack(frames)


def output_object(obj, output_folder, unknown_type='delta_beta',
                  ds_level=1, name_suffix=''):
    """The object's two channels as TIFF stacks, z-major: ``delta`` and
    ``beta``, or ``obj_mag`` and ``obj_phase`` for real_imag."""
    obj = np.asarray(obj)
    c0, c1 = obj[..., 0], obj[..., 1]
    if unknown_type == 'real_imag':
        c0, c1 = np.sqrt(c0 ** 2 + c1 ** 2), np.arctan2(c1, c0)
        names = ('obj_mag', 'obj_phase')
    else:
        names = ('delta', 'beta')
    paths = []
    for name, ch in zip(names, (c0, c1)):
        img = np.moveaxis(ch, -1, 0) if ch.ndim == 3 else ch
        paths.append(write_tiff(img, os.path.join(
            output_folder, f'{name}_ds_{ds_level}{name_suffix}')))
    return paths


def output_probe(probe, output_folder, ds_level=1, name_suffix=''):
    """The probe's magnitude and phase, one page a mode (and angle, for
    per-angle probes)."""
    probe = np.asarray(probe)
    if probe.ndim > 4:
        probe = probe.reshape((-1,) + probe.shape[-3:])
    pr, pi = probe[..., 0], probe[..., 1]
    mag = np.sqrt(pr ** 2 + pi ** 2)
    ph = np.arctan2(pi, pr)
    return [write_tiff(mag, os.path.join(
                output_folder, f'probe_mag_ds_{ds_level}{name_suffix}')),
            write_tiff(ph, os.path.join(
                output_folder, f'probe_phase_ds_{ds_level}{name_suffix}'))]


def output_refined_params(params, names, inter, i_epoch, i_batch):
    """The refined auxiliary parameters' history under ``inter``
    (``intermediate/``), in the reference's layout: the per-angle offsets
    append one line a dump to ``<name>/<name>.txt``; ``prj_affine_ls``
    writes ``prj_affine/prj_affine_<epoch>.txt``,
    ``probe_pos_correction`` ``probe_pos/probe_pos_correction_<epoch>.txt``
    and any other leaf ``<name>/<name>_<epoch>.txt``.  ``params``: numpy
    arrays by name; ``names``: the refined leaves to write."""
    ep = max(i_epoch, 0)
    folders = {'prj_affine_ls': 'prj_affine',
               'probe_pos_correction': 'probe_pos'}
    for name in names:
        if name in ('obj', 'probe'):
            continue
        arr = np.asarray(params[name])
        d = os.path.join(inter, folders.get(name, name))
        os.makedirs(d, exist_ok=True)
        if name in ('probe_pos_offset', 'prj_pos_offset'):
            mode = 'a' if (i_epoch > 0 or i_batch > 0) else 'w'
            with open(os.path.join(d, f'{name}.txt'), mode) as f:
                f.write(f'{i_epoch:4d}, {max(i_batch, 0):4d}, '
                        f'{list(arr.flatten())}\n')
        elif name == 'prj_affine_ls':
            np.savetxt(os.path.join(d, f'prj_affine_{ep}.txt'),
                       np.concatenate(arr, 0))
        elif name == 'probe_pos_correction':
            np.savetxt(os.path.join(d, f'probe_pos_correction_{ep}.txt'),
                       arr.reshape(-1, arr.shape[-1]))
        else:
            np.savetxt(os.path.join(d, f'{name}_{ep}.txt'),
                       arr.reshape(arr.shape[0], -1) if arr.ndim > 1
                       else np.atleast_1d(arr))


class LossLogger:
    """The per-rank loss CSV, ``convergence/loss_rank_N.txt`` with rows
    ``i_epoch,i_batch,loss,time``; appended to after a resume."""

    def __init__(self, output_folder, rank=0, append=False):
        conv = os.path.join(output_folder, 'convergence')
        os.makedirs(conv, exist_ok=True)
        self.path = os.path.join(conv, f'loss_rank_{rank}.txt')
        if append and os.path.exists(self.path):
            self._f = open(self.path, 'a')
        else:
            self._f = open(self.path, 'w')
            self._f.write('i_epoch,i_batch,loss,time\n')
        self._t0 = time.time()

    def log(self, i_epoch, i_batch, loss):
        self._f.write(f'{i_epoch},{i_batch},{loss},{time.time() - self._t0}\n')
        self._f.flush()

    def close(self):
        self._f.close()


def parse_loss_data(output_folder) -> np.ndarray:
    """The loss curve averaged over the rank CSVs."""
    conv = os.path.join(output_folder, 'convergence')
    curves = []
    for p in sorted(glob.glob(os.path.join(conv, 'loss_rank_*.txt'))):
        rows = np.genfromtxt(p, delimiter=',', names=True)
        curves.append(np.atleast_1d(rows['loss']))
    n = min(len(c) for c in curves)
    return np.mean([c[:n] for c in curves], axis=0)


def write_summary(cfg, output_folder, extra: Optional[dict] = None) -> str:
    """The whole configuration as ``summary.txt``."""
    os.makedirs(output_folder, exist_ok=True)
    path = os.path.join(output_folder, 'summary.txt')
    with open(path, 'w') as f:
        f.write('============== SUMMARY ==============\n')
        for section in dataclasses.fields(cfg):
            sub = getattr(cfg, section.name)
            f.write(f'[{section.name}]\n')
            for field in dataclasses.fields(sub):
                f.write(f'  {field.name} = {getattr(sub, field.name)}\n')
        for k, v in (extra or {}).items():
            f.write(f'{k} = {v}\n')
    return path
