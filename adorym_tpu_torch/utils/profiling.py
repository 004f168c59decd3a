"""Device-memory budget for the Reconstructor's working-set heuristics.

Counterpart of the budget half of ``adorym_tpu/utils/profiling.py``.  The
capacity comes from the card (``torch.cuda.get_device_properties``); on
the CPU the JAX package's 16e9 default keeps the heuristics, and so the
gradient chunking, identical to the reference package's CPU runs.  The
reserves keep the JAX package's formulas: they scale with the capacity
and are capped at absolute sizes tied to the program's working set, not
to the device.
"""

from __future__ import annotations

import torch

#: Capacity assumed off the card (the JAX package's CPU default).
DEFAULT_DEVICE_BYTES = 16e9


def hbm_limit_bytes(device=None) -> float:
    """Memory capacity in bytes of ``device`` (a CUDA card's total memory;
    :data:`DEFAULT_DEVICE_BYTES` for the CPU)."""
    device = torch.device('cpu' if device is None else device)
    if device.type == 'cuda':
        return float(torch.cuda.get_device_properties(device).total_memory)
    return DEFAULT_DEVICE_BYTES


def xla_reserve_bytes(hbm: float) -> float:
    """Memory held back from the gradient-chunk budget for temporaries and
    fragmentation (the JAX package's name and formula: 6 GB, or 3/8 of a
    smaller device)."""
    return min(6e9, 0.375 * hbm)


def data_headroom_bytes(hbm: float) -> float:
    """Headroom kept free when deciding whether the measured data lives on
    the device (1.5 GB, or 3/32 of a smaller device)."""
    return min(1.5e9, 0.09375 * hbm)
