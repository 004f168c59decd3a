"""Process bootstrap (``adorym_tpu/parallel/bootstrap.py``): the reference
runs ``mpirun -n N``; here each rank is a process of one
``torch.distributed`` process group, launched by ``torchrun
--nproc-per-node=N`` (which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``) or by a caller that passes the
address, the world size and the rank.  One rank drives one device: a card
of its own (``nccl``), or a share of one card or the CPU (``gloo``)."""

from __future__ import annotations

import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..config import ParallelConfig
from ..utils import profiling as _prof
from .comm import check_backend, default_backend, ranks_per_card


def free_port() -> int:
    """A free TCP port on localhost."""
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` where given (``'cpu'``), else
    ``cuda:{LOCAL_RANK % device_count}``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           'run the ranks on the CPU')
    local = int(os.environ.get('LOCAL_RANK', '0'))
    return torch.device(f'cuda:{local % torch.cuda.device_count()}')


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None, local_world: Optional[int] = None,
                           timeout_s: float = 600.0) -> torch.device:
    """Join the process group and return this rank's device.

    Without arguments the address, world size and rank come from
    ``torchrun``'s environment; a process outside any launcher makes a
    world of one.  ``backend``: ``'nccl'`` or ``'gloo'``; by default nccl
    where every rank has a card of its own, else gloo.  ``local_world``:
    the ranks on this host (``LOCAL_WORLD_SIZE``, else ``world_size``),
    which sets how many ranks share a card and so each rank's memory
    budget.  Already initialized: nothing is joined again, but a
    ``world_size`` that differs from the group's raises."""
    if dist.is_initialized():
        if world_size is not None and world_size != dist.get_world_size():
            raise ValueError(f'the process group has {dist.get_world_size()}'
                             f' ranks, not {world_size}')
        return local_device(device)
    env = os.environ
    if world_size is None:
        world_size = int(env.get('WORLD_SIZE', '1'))
    if rank is None:
        rank = int(env.get('RANK', '0'))
    if init_method is None:
        if 'MASTER_ADDR' in env and 'MASTER_PORT' in env:
            init_method = 'env://'
        elif world_size == 1:
            init_method = f'tcp://localhost:{free_port()}'
        else:
            raise ValueError('initialize_distributed: pass init_method '
                             "('tcp://host:port') or launch with torchrun")
    if local_world is None:
        local_world = int(env.get('LOCAL_WORLD_SIZE', world_size))
    dev = local_device(device)
    per_card = ranks_per_card(world_size, local_world) if dev.type == 'cuda' \
        else 1
    if backend is None:
        backend = default_backend(dev, per_card)
    check_backend(backend, dev, per_card)
    import datetime
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
        _prof.set_ranks_per_device(per_card)
    return dev


def auto_mesh(object_axis: int = 1, device=None) -> Tuple[object,
                                                         ParallelConfig]:
    """``(mesh, ParallelConfig)`` over every rank of the process group:
    ``object_axis`` ranks split the object's y extent, the rest split the
    data."""
    from .mesh import make_mesh
    n = dist.get_world_size()
    if n % object_axis:
        raise ValueError(f'{n} ranks do not split into object_axis='
                         f'{object_axis}')
    pcfg = ParallelConfig(data_axis=n // object_axis,
                          object_axis=object_axis)
    return make_mesh(pcfg, device=local_device(device)), pcfg
