"""The least work of one angle's multislice sweep, forward and adjoint,
counted from the cell's shapes whatever implements it (the yardstick of
``multislice_roofline_pct``).

Operations are counted as FFTs, ``5 n log2 n`` real operations per 2-D
transform of ``n`` pixels, and 6 per complex product:

* forward: ``S - 1`` propagations (a transform, the product with the
  transfer function, an inverse transform), one far-field transform, and
  one complex product per step (the modulation);
* adjoint: one sweep of the same, with two complex products per step (the
  wave's cotangent and the slice's gradient);

all of it times the probe modes times the positions.  A form that stores
the forward's waves and one that rebuilds them do the same work here: the
rebuild is the implementation's choice.  The transmissions' exponentials
are not counted.

Bytes are counted at the stage's boundary: the binned object over the
scan's footprint (both channels) and the probe modes read once, the
angle's magnitudes read once, the object's gradient over the same
footprint written once.  Patches and stored records are the
implementation's and are not counted.

This is the program's own count (``ops/cuda_multislice.py``: ``flops`` and
``bytes_moved``) corrected to a yardstick: the program counts the
invertible backward's second sweep and the kernels' record traffic, which
another implementation would not do.
"""

from __future__ import annotations

import math

F32 = 4


def fft2_ops(ny: int, nx: int) -> float:
    n = ny * nx
    return 5.0 * n * math.log2(n)


def steps(config: dict) -> int:
    return -(-int(config['obj_size'][2]) // int(config['binning']))


def ops_per_pattern(n_steps: int, n_modes: int, ny: int, nx: int) -> float:
    """Real operations of one pattern's forward and adjoint sweeps."""
    plane = ny * nx
    prop = 2 * fft2_ops(ny, nx) + 6 * plane
    fwd = (n_steps - 1) * prop + fft2_ops(ny, nx) + n_steps * 6 * plane
    adj = (n_steps - 1) * prop + fft2_ops(ny, nx) + n_steps * 2 * 6 * plane
    return float(n_modes * (fwd + adj))


def footprint(traffic: dict, probe_size) -> tuple:
    """Rows and columns of the object the scan's windows cover."""
    ny, nx = traffic['grid']
    s = traffic['stride_px']
    return ((ny - 1) * s + int(probe_size[0]), (nx - 1) * s + int(probe_size[1]))


def angle_work(config: dict, traffic: dict) -> dict:
    """``{'ops', 'bytes', 'patterns'}`` of one angle's sweeps."""
    py, px = config['probe_size']
    n_pos = traffic['grid'][0] * traffic['grid'][1]
    m = int(config['n_probe_modes'])
    s = steps(config)
    fy, fx = footprint(traffic, (py, px))
    obj_bytes = fy * fx * s * 2 * F32
    nbytes = (2 * obj_bytes + m * py * px * 2 * F32
              + n_pos * py * px * F32)
    return {'ops': n_pos * ops_per_pattern(s, m, py, px),
            'bytes': float(nbytes), 'patterns': n_pos}


def bound_seconds(work: dict, peaks: dict) -> tuple:
    """The least time of ``work`` on a device of ``peaks`` and what bounds
    it: ``(seconds, 'operations' | 'bytes')``."""
    t_ops = work['ops'] / peaks['f32_flops_per_s']
    t_bytes = work['bytes'] / peaks['bytes_per_s']
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')
