"""Measurement files in the reference's HDF5 layout
(``adorym_tpu/io/data.py``):

  exchange/data            [n_theta, n_pos, det_y, det_x] (complex or float)
  metadata/theta           [n_theta] (optional; else linspace(st, end))
  metadata/probe_pos_px    [n_pos, 2] (optional)
  metadata/probe_pos_px_i  per-angle positions when not common (optional)
  metadata/energy_ev, metadata/psize_cm, metadata/free_prop_cm (optional)

``h5py`` is imported when a file is opened, not with the package; without
it the readers raise an ``ImportError`` that names it.
:class:`ArrayDataset` holds the same contents in memory, with the same
methods, for a caller that has the arrays but no ``h5py``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError('h5py is needed to read or write HDF5 measurement '
                          'files; without it, pass the arrays as an '
                          'adorym_tpu_torch.io.data.ArrayDataset') from e
    return h5py


class _Metadata:
    """The metadata accessors shared by the file and in-memory datasets;
    ``_meta(key)`` returns the ``metadata/<key>`` entry or None."""

    def _meta(self, key):
        raise NotImplementedError

    def theta_ls(self, theta_st=0.0, theta_end=0.0):
        t = self._meta('theta')
        if t is not None:
            return np.asarray(t, dtype=np.float64)
        return np.linspace(theta_st, theta_end, self.n_theta)

    def probe_pos(self) -> Optional[np.ndarray]:
        p = self._meta('probe_pos_px')
        return None if p is None else np.asarray(p, dtype=np.float64)

    def probe_pos_per_angle(self, i: int) -> Optional[np.ndarray]:
        p = self._meta(f'probe_pos_px_{i}')
        return None if p is None else np.asarray(p, dtype=np.float64)

    def energy_ev(self, default=None):
        e = self._meta('energy_ev')
        return default if e is None else float(e)

    def psize_cm(self, default=None):
        p = self._meta('psize_cm')
        return default if p is None else float(p)

    def free_prop_cm(self, default=None):
        fp = self._meta('free_prop_cm')
        return default if fp is None else np.asarray(fp)

    def magnitudes(self, i_theta: int, indices, ds_level: int = 1):
        """|data| of one angle's spots ``indices``."""
        out = self.all_magnitudes()[i_theta][np.asarray(indices)]
        if ds_level > 1:
            out = out[:, ::ds_level, ::ds_level]
        return out


class RawDataset(_Metadata):
    """Reader of a reference-layout measurement file; ``preload`` reads
    the magnitudes into host memory at once."""

    def __init__(self, path: str, preload: bool = True):
        self.path = path
        self._f = _h5py().File(path, 'r')
        self.data = self._f['exchange/data']
        self.shape = self.data.shape
        self.n_theta, self.n_pos = self.shape[:2]
        self.det_shape = tuple(self.shape[2:])
        self._cache = None
        if preload:
            self._cache = np.abs(np.asarray(self.data)).astype(np.float32)

    def _meta(self, key):
        try:
            return self._f[f'metadata/{key}'][...]
        except KeyError:
            return None

    def magnitudes(self, i_theta: int, indices, ds_level: int = 1):
        if self._cache is not None:
            return super().magnitudes(i_theta, indices, ds_level)
        idx = np.asarray(indices)
        order = np.argsort(idx)
        out = np.abs(self.data[i_theta, idx[order]]).astype(np.float32)
        out = out[np.argsort(order)]
        if ds_level > 1:
            out = out[:, ::ds_level, ::ds_level]
        return out

    def all_magnitudes(self) -> np.ndarray:
        if self._cache is not None:
            return self._cache
        return np.abs(np.asarray(self.data)).astype(np.float32)

    def close(self):
        self._f.close()


class ArrayDataset(_Metadata):
    """A measurement dataset held in memory: the ``exchange/data`` array
    and the ``metadata/*`` entries as keywords (``theta``,
    ``probe_pos_px``, ``probe_pos_px_<i>``, ``energy_ev``, ``psize_cm``,
    ``free_prop_cm``)."""

    def __init__(self, data: np.ndarray, **metadata):
        self.data = np.asarray(data)
        self.shape = self.data.shape
        self.n_theta, self.n_pos = self.shape[:2]
        self.det_shape = tuple(self.shape[2:])
        self.metadata = {k: v for k, v in metadata.items() if v is not None}
        self._mag = None

    def _meta(self, key):
        return self.metadata.get(key)

    def all_magnitudes(self) -> np.ndarray:
        if self._mag is None:
            self._mag = np.abs(self.data).astype(np.float32)
        return self._mag

    def close(self):
        pass


def write_data_file(path: str, data: np.ndarray, *, theta=None,
                    probe_pos=None, energy_ev=None, psize_cm=None,
                    free_prop_cm=None, probe_pos_per_angle=None):
    """Write a measurement file in the reference layout."""
    h5py = _h5py()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, 'w') as f:
        f.create_dataset('exchange/data', data=data)
        if theta is not None:
            f.create_dataset('metadata/theta', data=np.asarray(theta))
        if probe_pos is not None:
            f.create_dataset('metadata/probe_pos_px',
                             data=np.asarray(probe_pos))
        if probe_pos_per_angle is not None:
            for i, p in enumerate(probe_pos_per_angle):
                f.create_dataset(f'metadata/probe_pos_px_{i}',
                                 data=np.asarray(p))
        if energy_ev is not None:
            f.create_dataset('metadata/energy_ev', data=float(energy_ev))
        if psize_cm is not None:
            f.create_dataset('metadata/psize_cm', data=float(psize_cm))
        if free_prop_cm is not None:
            f.create_dataset('metadata/free_prop_cm',
                             data=np.asarray(free_prop_cm))


def parse_source_folder(src_dir, prefix):
    """A ``prefix_<iTheta>_<iDist>.tiff`` folder in (theta, dist) order:
    ``(files, n_theta, n_dists, raw image shape)``."""
    from .output import read_tiff
    flist = glob.glob(os.path.join(src_dir, prefix + '*.tif*'))
    if not flist:
        raise FileNotFoundError(f'no {prefix}*.tif* in {src_dir}')
    raw_shape = np.squeeze(read_tiff(flist[0])).shape
    theta_full, dist_full = [], []
    for f in flist:
        nums = re.findall(r'\d+', os.path.basename(f))
        theta_full.append(int(nums[-2]))
        dist_full.append(int(nums[-1]))
    n_theta = len(np.unique(theta_full))
    n_dists = len(flist) // n_theta
    order = np.argsort(np.asarray(theta_full) * n_dists
                       + np.asarray(dist_full))
    return [flist[i] for i in order], n_theta, n_dists, raw_shape
