"""ctypes binding of the native batch loader (``native/fastloader.cpp``),
with the JAX package's API (``adorym_tpu/io/fastloader.py``).

The library maps a raw float32 dataset ``[n_theta, n_pos, h, w]`` and
gathers a batch's rows on a worker thread, so a batch is assembled while
the card runs the previous step.  It is compiled with ``g++ -O3 -shared
-fPIC -pthread`` at first use into ``build/adorym_tpu_torch/`` at the root
of the checkout, named by the hash of the source (nothing is written into
``native/``).  A loader that cannot be built or cannot map its file raises;
nothing falls back to numpy on its own.

:func:`convert_h5_to_raw` turns an ``exchange/data`` HDF5 file into the raw
magnitude file the loader maps, once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / 'native' / 'fastloader.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'adorym_tpu_torch'
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-pthread')

_lock = threading.Lock()
_LIB = None


def _lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + ' '.join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'fastloader-{digest}.so'


def _build() -> Path:
    """The library, compiled first if it is not there; raises
    ``RuntimeError`` with the compiler's output when it cannot be built."""
    out = _lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    try:
        proc = subprocess.run(['g++', *CXX_FLAGS, '-o', str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f'native fastloader: cannot run g++ ({e})') from e
    if proc.returncode != 0:
        raise RuntimeError('native fastloader: g++ failed\n' + proc.stdout
                           + proc.stderr)
    os.replace(tmp, out)
    return out


def _lib():
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.loader_open.restype = ctypes.c_void_p
            lib.loader_open.argtypes = [ctypes.c_char_p] + [i64] * 6
            lib.loader_close.argtypes = [ctypes.c_void_p]
            lib.loader_prefetch.argtypes = [ctypes.c_void_p, i64, i64, i64p,
                                            i64]
            lib.loader_get.argtypes = [ctypes.c_void_p, i64, f32p, i64]
            lib.loader_gather.argtypes = [ctypes.c_void_p, i64, i64p, i64,
                                          f32p]
            _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        _lib()
        return True
    except (RuntimeError, OSError):
        return False


def convert_h5_to_raw(h5_path: str, raw_path: str) -> tuple:
    """One-time conversion of ``|exchange/data|`` to a raw float32 file.
    Returns the dataset's shape.  Imports ``h5py`` only when called."""
    import h5py
    with h5py.File(h5_path, 'r') as f:
        dset = f['exchange/data']
        shape = dset.shape
        with open(raw_path, 'wb') as out:
            for i in range(shape[0]):
                np.abs(np.asarray(dset[i])).astype(np.float32).tofile(out)
    return shape


def _out_ptr(out: np.ndarray, n: int, frame):
    if (out.dtype != np.float32 or not out.flags['C_CONTIGUOUS']
            or out.shape[0] < n or tuple(out.shape[1:]) != tuple(frame)):
        raise ValueError(f'out must be a C-contiguous float32 array of at '
                         f'least {n} rows of {tuple(frame)}, got '
                         f'{out.dtype} {out.shape}')
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class FastLoader:
    """Asynchronous minibatch loader over a raw dataset file: ``n_slots``
    staging buffers of ``max_batch`` rows each, filled by ``prefetch`` on
    the worker thread and read by ``get``; ``gather`` reads rows at once.
    ``get`` and ``gather`` take an ``out`` array to write into (a pinned
    staging buffer), else return a new one."""

    def __init__(self, raw_path: str, shape, n_slots: int = 2,
                 max_batch: int = 256):
        n_theta, n_pos, h, w = (int(s) for s in shape)
        self.shape = (n_theta, n_pos, h, w)
        self.n_slots = int(n_slots)
        self.max_batch = int(max_batch)
        self._h = _lib().loader_open(str(raw_path).encode(), n_theta, n_pos,
                                     h, w, self.n_slots, self.max_batch)
        if not self._h:
            raise RuntimeError(f'failed to map {raw_path} as a float32 '
                               f'dataset {self.shape}')

    def _indices(self, i_theta: int, indices: Sequence[int]) -> np.ndarray:
        idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
        if not 0 <= int(i_theta) < self.shape[0] or (
                idx.size and (idx.min() < 0 or idx.max() >= self.shape[1])):
            raise IndexError(f'rows {i_theta}, {idx.tolist()} outside '
                             f'{self.shape[:2]}')
        return idx

    def prefetch(self, slot: int, i_theta: int, indices: Sequence[int]):
        """Queue the rows ``indices`` of angle ``i_theta`` into ``slot``."""
        idx = self._indices(i_theta, indices)
        if len(idx) > self.max_batch or not 0 <= slot < self.n_slots:
            raise ValueError(f'{len(idx)} rows into slot {slot}: the loader '
                             f'holds {self.n_slots} slots of '
                             f'{self.max_batch}')
        self._live()
        _lib().loader_prefetch(
            self._h, int(slot), int(i_theta),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx))

    def get(self, slot: int, n: int,
            out: Optional[np.ndarray] = None) -> np.ndarray:
        """The first ``n`` rows of ``slot``, once its prefetch is done."""
        if n > self.max_batch:
            raise ValueError(f'{n} rows: a slot holds {self.max_batch}')
        if out is None:
            out = np.empty((n,) + self.shape[2:], np.float32)
        self._live()
        _lib().loader_get(self._h, int(slot),
                          _out_ptr(out, n, self.shape[2:]), int(n))
        return out[:n]

    def gather(self, i_theta: int, indices: Sequence[int],
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """The rows ``indices`` of angle ``i_theta``, read now."""
        idx = self._indices(i_theta, indices)
        if out is None:
            out = np.empty((len(idx),) + self.shape[2:], np.float32)
        self._live()
        _lib().loader_gather(
            self._h, int(i_theta),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            _out_ptr(out, len(idx), self.shape[2:]))
        return out[:len(idx)]

    def _live(self):
        if not self._h:
            raise RuntimeError('the loader is closed')

    def close(self):
        if self._h:
            _lib().loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
