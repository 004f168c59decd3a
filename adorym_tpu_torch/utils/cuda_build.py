"""Build and bind the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (Hopper)
into a shared library with a plain C interface and loaded with
``ctypes``.  Libraries are built on first use into ``build/adorym_tpu_torch/``
at the root of the checkout, named by the hash of their source and of the
shared headers (``csrc/*.cuh``) so that an edited source or header
rebuilds.  Nothing is compiled when a module is imported: the
CPU tests import every module on machines without ``nvcc``.

:class:`Kernel` wraps one C entry point: it builds its library on first
call, launches on PyTorch's current CUDA stream, raises when the launch is
refused, and counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'adorym_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else the toolkit's default location."""
    home = os.environ.get('CUDA_HOME')
    if home and os.path.exists(os.path.join(home, 'bin', 'nvcc')):
        return os.path.join(home, 'bin', 'nvcc')
    return shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'


def _lib_path(source: str) -> Path:
    """The library of ``source``, named by the hash of the source, every
    header under ``csrc/`` (any may be included) and the flags."""
    text = (CSRC / source).read_bytes() + b''.join(
        h.read_bytes() for h in sorted(CSRC.glob('*.cuh')))
    flags = ' '.join(NVCC_FLAGS).encode()
    digest = hashlib.sha1(text + flags).hexdigest()[:12]
    return BUILD_DIR / f'{Path(source).stem}-{digest}.so'


def build(sources: Iterable[str]) -> float:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together.  Returns the wall seconds taken;
    raises ``RuntimeError`` with the compiler's output on failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for src in sources:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{src}:\n{log}')
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError('nvcc failed\n' + '\n'.join(failed))
    return time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(_lib_path(source)))
            _libs[source] = lib
        return lib


class Kernel:
    """One C entry point of a ``csrc`` source.

    ``argtypes`` are the ctypes of the arguments before the trailing stream
    pointer, which the call appends.  Every C entry returns the CUDA error
    code of its launch; a nonzero code raises ``RuntimeError``.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None

    def function(self):
        """The bound C entry point (its library built and loaded on first
        use), for callers that pass the stream and count launches
        themselves."""
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        err = self.function()(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            self.fail(err)
        self.launches += 1

    def fail(self, err: int):
        raise RuntimeError(
            f'{self.symbol} launch failed: CUDA error {err} '
            f'({torch.cuda.get_device_name()})')


#: PyTorch's raw accessor of the current stream (what
#: ``torch.cuda.current_stream(i).cuda_stream`` returns, without building a
#: Stream object), where this build of PyTorch has it.
_raw_stream = getattr(torch._C, '_cuda_getCurrentRawStream', None)


def stream_ptr(device_index: int) -> int:
    """The current CUDA stream of device ``device_index``, as an int."""
    if _raw_stream is not None:
        return _raw_stream(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None -> a null pointer)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())
