"""3D rotation of the object about the y axis by bilinear (or nearest)
gather.

Main-path subset of ``adorym_tpu/ops/rotate.py``, with its coordinate math
(not ``F.grid_sample``): rotation of the (x, z) planes about the array
center ``(s-1)/2``, source coordinates edge-clamped, bilinear weights.  The
per-angle scheme rotates outside autograd, so these are plain gathers with
no backward.
"""

from __future__ import annotations

import torch


def _rotation_source_coords(shape2, theta, device):
    """Source coordinates ``(c1, c2)``, float32 ``shape2``, of each target
    pixel of a plane rotated by ``theta`` (``_rotation_source_coords`` of
    the JAX package, in f32)."""
    s1, s2 = shape2
    ctr1 = (s1 - 1) / 2.0
    ctr2 = (s2 - 1) / 2.0
    g1 = torch.arange(s1, dtype=torch.float32, device=device)[:, None] - ctr1
    g2 = torch.arange(s2, dtype=torch.float32, device=device)[None, :] - ctr2
    th = torch.tensor(theta, dtype=torch.float32, device=device)
    cos_t = torch.cos(th)
    sin_t = torch.sin(th)
    c1 = cos_t * g1 - sin_t * g2 + ctr1
    c2 = sin_t * g1 + cos_t * g2 + ctr2
    return c1, c2


def _corners(c1, c2, s1, s2):
    """Flat corner indices and bilinear weights of the sample points
    ``(c1, c2)`` in an ``s1 x s2`` grid, in the JAX package's corner
    order."""
    c1 = torch.clamp(c1, 0.0, s1 - 1.0)
    c2 = torch.clamp(c2, 0.0, s2 - 1.0)
    f1 = torch.floor(c1)
    f2 = torch.floor(c2)
    w1 = c1 - f1
    w2 = c2 - f2
    i1 = f1.long()
    i2 = f2.long()
    i1c = torch.clamp(i1 + 1, max=s1 - 1)
    i2c = torch.clamp(i2 + 1, max=s2 - 1)
    idx = [(i1, i2), (i1, i2c), (i1c, i2), (i1c, i2c)]
    wts = [(1 - w1) * (1 - w2), (1 - w1) * w2, w1 * (1 - w2), w1 * w2]
    return [(a.ravel(), b.ravel()) for a, b in idx], [w.ravel() for w in wts]


def _check_method(method):
    if method not in ('bilinear', 'nearest'):
        raise ValueError(f'unknown interpolation method {method!r} '
                         "(expected 'bilinear' or 'nearest')")


def rotate(obj, theta, method='bilinear'):
    """Rotate ``obj[y, x, z, ...]`` about the y axis by ``theta`` rad
    (a Python float); trailing axes (the delta/beta channels) ride along."""
    _check_method(method)
    s1, s2 = obj.shape[1], obj.shape[2]
    c1, c2 = _rotation_source_coords((s1, s2), theta, obj.device)
    v = obj.movedim(0, 2)                      # [x, z, y, ...]
    if method == 'nearest':
        i1 = torch.clamp(torch.round(c1), 0, s1 - 1).long().ravel()
        i2 = torch.clamp(torch.round(c2), 0, s2 - 1).long().ravel()
        out = v[i1, i2]
    else:
        idx, wts = _corners(c1, c2, s1, s2)
        out = None
        for (a, b), wt in zip(idx, wts):
            vals = v[a, b]                     # [x*z, y, ...]
            wt = wt.reshape((-1,) + (1,) * (vals.dim() - 1)).to(vals.dtype)
            out = vals * wt if out is None else out + vals * wt
    out = out.reshape((s1, s2) + tuple(v.shape[2:]))
    return out.movedim(2, 0).contiguous()


def rotate_expanded_from_binned_z(g_binned, theta, binning, nz_full,
                                  method='bilinear'):
    """``rotate(expand_z(g_binned), theta)`` without the expanded volume:
    the z expansion is piecewise constant, so corner index ``z`` reads
    ``g_binned[:, :, z // binning]``.  ``g_binned``: ``[y, x, zb, ...]``;
    returns ``[y, x, nz_full, ...]``."""
    _check_method(method)
    s1 = g_binned.shape[1]
    c1, c2 = _rotation_source_coords((s1, nz_full), theta, g_binned.device)
    if method == 'nearest':
        i1 = torch.clamp(torch.round(c1), 0, s1 - 1).long().ravel()
        i2 = (torch.clamp(torch.round(c2), 0, nz_full - 1).long()
              // binning).ravel()
        out = g_binned[:, i1, i2]
    else:
        idx, wts = _corners(c1, c2, s1, nz_full)
        out = None
        for (a, b), wt in zip(idx, wts):
            vals = g_binned[:, a, b // binning]          # [y, x*z, ...]
            wt = wt.reshape((1, -1) + (1,) * (vals.dim() - 2)).to(vals.dtype)
            out = vals * wt if out is None else out + vals * wt
    return out.reshape((g_binned.shape[0], s1, nz_full)
                       + tuple(g_binned.shape[3:]))
