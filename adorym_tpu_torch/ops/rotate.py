"""3D rotation of the object about any of its axes by bilinear (or
nearest) gather, the three-axis tilt sequence, and the exact transpose.

Counterpart of ``adorym_tpu/ops/rotate.py``, with its coordinate math (not
``F.grid_sample``): rotation of the planes across the axis about the array
center ``(s-1)/2``, source coordinates edge-clamped, bilinear weights.  The
rotations are index gathers, so autograd differentiates them in the object
and, under ``'bilinear'``, in the angle (a tensor angle: the refined tilts
of :func:`tilt_rotate`); the band step applies the transpose explicitly,
either through autograd (:func:`rotate_adjoint`) or as the 9-tap gather of
:func:`rotate_adjoint_taps`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling as _prof
from .propagate import bin_z_sum


def _angle(theta, device):
    """``theta`` as a float32 0-d tensor on ``device``; a tensor keeps its
    graph (a refined angle)."""
    if torch.is_tensor(theta):
        return theta.to(device=device, dtype=torch.float32)
    return torch.tensor(theta, dtype=torch.float32, device=device)


def _rotation_source_coords(shape2, theta, device):
    """Source coordinates ``(c1, c2)``, float32 ``shape2``, of each target
    pixel of a plane rotated by ``theta`` (``_rotation_source_coords`` of
    the JAX package, in f32); differentiable in a tensor ``theta``."""
    s1, s2 = shape2
    ctr1 = (s1 - 1) / 2.0
    ctr2 = (s2 - 1) / 2.0
    g1 = torch.arange(s1, dtype=torch.float32, device=device)[:, None] - ctr1
    g2 = torch.arange(s2, dtype=torch.float32, device=device)[None, :] - ctr2
    th = _angle(theta, device)
    cos_t = torch.cos(th)
    sin_t = torch.sin(th)
    c1 = cos_t * g1 - sin_t * g2 + ctr1
    c2 = sin_t * g1 + cos_t * g2 + ctr2
    return c1, c2


def _clip(c, hi):
    """``c`` clamped to ``[0, hi]``.  Where ``c`` carries an angle's
    gradient, a point on the edge passes half of it, as the JAX package's
    ``clip`` (a max and a min, which split ties) does; ``torch.clamp``
    would pass all of it."""
    if c.requires_grad:
        return torch.minimum(torch.maximum(c, c.new_zeros(())),
                             c.new_full((), hi))
    return torch.clamp(c, 0.0, hi)


def _corners(c1, c2, s1, s2):
    """Flat corner indices and bilinear weights of the sample points
    ``(c1, c2)`` in an ``s1 x s2`` grid, in the JAX package's corner
    order."""
    c1 = _clip(c1, s1 - 1.0)
    c2 = _clip(c2, s2 - 1.0)
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


#: Above this share of the device's capacity the rotations process the
#: carried axis in chunks: each of the four corner gathers makes an
#: object-sized temporary, so a whole-volume rotation peaks at about four
#: objects.  A chunk aims at the second share.  The JAX package's
#: fractions (``_CHUNK_THRESHOLD_FRAC``, ``_CHUNK_TARGET_FRAC``).
_CHUNK_THRESHOLD_FRAC = 1 / 32
_CHUNK_TARGET_FRAC = 1 / 128


def _carried_chunks(n_carried: int, nbytes: int, device) -> int:
    """The chunks of the carried axis (``n_carried`` long) for a volume of
    ``nbytes`` on ``device``: 1 at or below the threshold, else the
    smallest divisor of ``n_carried`` whose chunks fit the target."""
    hbm = _prof.hbm_limit_bytes(device)
    if nbytes <= hbm * _CHUNK_THRESHOLD_FRAC:
        return 1
    want = int(np.ceil(nbytes / (hbm * _CHUNK_TARGET_FRAC)))
    for k in range(want, n_carried + 1):
        if n_carried % k == 0:
            return k
    return 1


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _by_chunks(fn, vol, k, out_shape):
    """``fn`` applied to ``k`` equal slices of ``vol`` along axis 0, the
    results written into one ``out_shape`` volume (each slice's
    temporaries freed before the next)."""
    cy = vol.shape[0] // k
    out = vol.new_empty(out_shape)
    for i in range(k):
        out[i * cy:(i + 1) * cy] = fn(vol[i * cy:(i + 1) * cy])
    return out


def rotate(obj, theta, axis=0, method='bilinear'):
    """Rotate ``obj[y, x, z, ...]`` about ``axis`` (0, the y axis, by
    default) by ``theta`` rad, a Python float or a 0-d tensor (under
    ``'bilinear'`` the result is differentiable in it); trailing axes (the
    delta/beta channels) ride along.  The plane across the axis may be
    rectangular.  Above :data:`_CHUNK_THRESHOLD_FRAC` of the device's
    memory the carried axis rotates in chunks (:func:`_carried_chunks`):
    each slice rotates alone, so the values are the same."""
    _check_method(method)
    k = _carried_chunks(obj.shape[axis], _nbytes(obj), obj.device)
    if k > 1:
        vol = obj.movedim(axis, 0)
        out = _by_chunks(
            lambda sl: _rotate_bulk(sl.movedim(0, axis), theta, axis,
                                    method).movedim(axis, 0),
            vol, k, vol.shape)
        return out.movedim(0, axis).contiguous()
    return _rotate_bulk(obj, theta, axis, method)


def _rotate_bulk(obj, theta, axis, method):
    """:func:`rotate` of the whole volume at once."""
    axes = [a for a in range(3) if a != axis]
    s1, s2 = obj.shape[axes[0]], obj.shape[axes[1]]
    c1, c2 = _rotation_source_coords((s1, s2), theta, obj.device)
    perm = axes + [axis] + list(range(3, obj.dim()))
    v = obj.permute(perm)                      # [s1, s2, carried, ...]
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
    return out.permute(list(np.argsort(perm))).contiguous()


def tilt_rotate(obj, tilts):
    """The three-axis tilt sequence: rotate about axes 0, 1 and 2 in turn
    by ``tilts[0]``, ``tilts[1]``, ``tilts[2]``, always bilinear (the
    nearest gather has no gradient in the angles); differentiable in a
    tensor ``tilts``."""
    obj = rotate(obj, tilts[0], axis=0)
    obj = rotate(obj, tilts[1], axis=1)
    return rotate(obj, tilts[2], axis=2)


def rotate_expanded_from_binned_z(g_binned, theta, binning, nz_full,
                                  method='bilinear'):
    """``rotate(expand_z(g_binned), theta)`` without the expanded volume:
    the z expansion is piecewise constant, so corner index ``z`` reads
    ``g_binned[:, :, z // binning]``.  ``g_binned``: ``[y, x, zb, ...]``;
    returns ``[y, x, nz_full, ...]``, in y chunks when the result passes
    :data:`_CHUNK_THRESHOLD_FRAC` of the device's memory."""
    _check_method(method)
    out_shape = ((g_binned.shape[0], g_binned.shape[1], nz_full)
                 + tuple(g_binned.shape[3:]))
    k = _carried_chunks(g_binned.shape[0],
                        int(np.prod(out_shape)) * g_binned.element_size(),
                        g_binned.device)
    if k > 1:
        return _by_chunks(lambda sl: _expanded_bulk(
            sl, theta, binning, nz_full, method), g_binned, k, out_shape)
    return _expanded_bulk(g_binned, theta, binning, nz_full, method)


def _expanded_bulk(g_binned, theta, binning, nz_full, method):
    """:func:`rotate_expanded_from_binned_z` of the whole volume at once."""
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


def rotate_and_bin_z(obj, theta, binning, method='bilinear'):
    """``bin_z_sum(rotate(obj, theta), binning)``: ``obj[y, x, z, 2]``
    (delta/beta channels, the bin identity is 0) to ``[y, x,
    ceil(z/binning), 2]``, without the rotated full-depth volume when the
    object passes :data:`_CHUNK_THRESHOLD_FRAC` of the device's memory:
    each y chunk is rotated and binned before the next (the per-angle
    path's streaming rotation).  Each y plane rotates alone, so the values
    are the one-chunk form's."""
    def one(sl):
        return bin_z_sum(_rotate_bulk(sl, theta, 0, method), binning, axis=2)
    _check_method(method)
    y, x, nz = obj.shape[:3]
    k = _carried_chunks(y, _nbytes(obj), obj.device)
    if k > 1:
        return _by_chunks(one, obj, k, (y, x, -(-nz // binning))
                          + tuple(obj.shape[3:]))
    return one(obj)


def rotate_adjoint(cotangent, theta, method='bilinear'):
    """Transpose of :func:`rotate` about axis 0 at the same ``theta``, by
    autograd through the rotation's gathers (on CUDA their backward sorts
    the indices and sums each target's terms in sorted order).  The
    linear-map transpose, not a rotation by ``-theta``."""
    x = torch.zeros_like(cotangent, requires_grad=True)
    with torch.enable_grad():
        y = rotate(x, theta, method=method)
        return torch.autograd.grad(y, x, cotangent)[0]


def _taps_margin(s1: int, s2: int) -> int:
    """Extension margin covering every theta: the rotated grid's sample
    coordinates overshoot an axis by at most ``sqrt(a^2 + b^2) - a``
    (half-extents a, b), plus slack for the +-1 tap window and f32
    rounding of the inverse-map centers."""
    a, b = (s1 - 1) / 2.0, (s2 - 1) / 2.0
    return int(np.ceil(float(np.hypot(a, b)) - min(a, b))) + 2


def rotate_adjoint_taps(cot, theta, binning: int = 1, nz_full: int = None):
    """Exact transpose of ``rotate(., theta, method='bilinear')`` as a pure
    gather: 9 weighted tap gathers, no scatter (the JAX package's form for
    the TPU, where the scatter of the gathers' transpose serialises).

    Edge-clamped bilinear sampling of ``src`` equals unclamped sampling of
    the edge-replicated extension of ``src``, so the adjoint is the
    unclamped adjoint on the extended grid followed by the transpose of the
    replication (the margin strips summed into the edge lines).  The
    unclamped adjoint at extended texel ``e`` sums the output points ``p``
    with ``|c(p) - e| < 1`` per axis, all inside the 3x3 window around
    ``round(R^-1 e)``.  The tap weights recompute ``c(p)`` with the f32
    expression of :func:`_rotation_source_coords`, so they equal the
    forward's weights.

    ``cot``: the rotated-frame cotangent ``[Y, S1, S2, *rest]``; with
    ``binning > 1`` it is z-binned (``[Y, S1, ceil(nz_full/binning),
    *rest]``) and read as its piecewise-constant expansion to ``nz_full``.
    Returns the source-frame cotangent at full depth."""
    dev = cot.device
    s1 = cot.shape[1]
    s2 = int(nz_full) if binning > 1 else cot.shape[2]
    m1 = _taps_margin(s1, s2)
    m2 = _taps_margin(s2, s1)
    ctr1 = (s1 - 1) / 2.0
    ctr2 = (s2 - 1) / 2.0
    th = torch.tensor(theta, dtype=torch.float32, device=dev)
    cos_t = torch.cos(th)
    sin_t = torch.sin(th)
    # Inverse-map centers of every extended texel (they only locate the
    # tap window, so their rounding cannot break exactness).
    e1 = (torch.arange(s1 + 2 * m1, dtype=torch.float32, device=dev)[:, None]
          - m1 - ctr1)
    e2 = (torch.arange(s2 + 2 * m2, dtype=torch.float32, device=dev)[None, :]
          - m2 - ctr2)
    b1 = torch.round(cos_t * e1 + sin_t * e2 + ctr1).long()
    b2 = torch.round(-sin_t * e1 + cos_t * e2 + ctr2).long()
    e1_idx = e1 + ctr1          # the source index each texel holds
    e2_idx = e2 + ctr2
    v = cot.movedim(0, 2)       # [S1, S2 (binned), Y, *rest]
    acc = None
    for d1 in (-1, 0, 1):
        for d2 in (-1, 0, 1):
            t1 = b1 + d1
            t2 = b2 + d2
            valid = (t1 >= 0) & (t1 < s1) & (t2 >= 0) & (t2 < s2)
            t1 = torch.clamp(t1, 0, s1 - 1)
            t2 = torch.clamp(t2, 0, s2 - 1)
            # The forward coordinates of the tap's output point, in the
            # f32 expression of _rotation_source_coords.
            g1 = t1.float() - ctr1
            g2 = t2.float() - ctr2
            c1t = cos_t * g1 - sin_t * g2 + ctr1
            c2t = sin_t * g1 + cos_t * g2 + ctr2
            w = (torch.clamp(1.0 - torch.abs(c1t - e1_idx), min=0.0)
                 * torch.clamp(1.0 - torch.abs(c2t - e2_idx), min=0.0)
                 * valid)
            t2v = t2 // binning if binning > 1 else t2
            vals = v[t1.ravel(), t2v.ravel()]          # [n, Y, *rest]
            w = w.reshape((-1,) + (1,) * (vals.dim() - 1)).to(vals.dtype)
            acc = vals * w if acc is None else acc + vals * w
    ext = acc.reshape((s1 + 2 * m1, s2 + 2 * m2) + tuple(acc.shape[1:]))
    # The replication's transpose: the margin strips into the edge lines.
    core = ext[m1:m1 + s1].clone()
    core[0] += ext[:m1].sum(0)
    core[s1 - 1] += ext[m1 + s1:].sum(0)
    core2 = core[:, m2:m2 + s2].clone()
    core2[:, 0] += core[:, :m2].sum(1)
    core2[:, s2 - 1] += core[:, m2 + s2:].sum(1)
    return core2.movedim(2, 0).contiguous()     # [Y, S1, S2, *rest]
