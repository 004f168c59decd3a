"""Conventional (non-AD) reconstruction: ePIE and multi-distance CTF phase
retrieval.

Counterpart of ``adorym_tpu/conventional.py``.  ePIE updates the object
position by position, each window reading what the one before wrote, so
it is a host loop over the scan positions with the object updated in
place on the device.  Each window's start follows ``lax.dynamic_slice``
and ``dynamic_update_slice`` under their default
``allow_negative_indices=True``: a negative start counts from the far
end, and the start is then clamped so that the window stays inside the
object (no window wraps round an edge).  The loop issues its small
operations without a host synchronization.  The CTF retrieval is the
filter math on complex tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .constants import PI, wavelength_nm
from .ops.fourier import (fft2, fft2_and_shift, fourier_shift, ifft2,
                          ishift_and_ifft2)
from .ops.propagate import gen_freq_mesh
from .ops.warp import affine_transform_2d
from .recon import resolve_device


def _tensor(x, dtype, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


def _window_starts(start, dim, size):
    """The starts ``lax.dynamic_slice`` takes for ``start`` along an axis
    of ``dim``: a negative start plus ``dim``, then clamped to ``[0, dim -
    size]``."""
    start = np.where(start < 0, start + dim, start)
    return np.clip(start, 0, dim - size)


def epie_reconstruct(data, probe, probe_pos, obj_init, energy_ev=None,
                     psize_cm=None, alpha=1.0, n_epochs=100,
                     raw_data_type='magnitude', update_probe=True,
                     probe_pos_correction=None, device=None):
    """The extended ptychographic iterative engine.

    ``data``: ``[n_pos, py, px]`` measured magnitudes (intensities under
    ``raw_data_type='intensity'``) of one view; ``probe``: complex ``[py,
    px]``; ``probe_pos``: int ``[n_pos, 2]`` window starts, meant to be
    non-negative (pad the object); others are taken as
    :func:`_window_starts` takes them;
    ``obj_init``: complex ``[Y, X]``; ``probe_pos_correction``: optional
    float ``[n_pos, 2]`` sub-pixel probe shifts, one per position.
    ``device``: where it runs (``None`` means CUDA, which must then exist).

    Per position, sequentially: the Fraunhofer magnitude replacement
    (magnitudes floored at 1e-12), then
      O += alpha conj(P) d / max|P|^2;  P += alpha conj(O) d / max|O|^2
    with ``O`` the window before its update.  Returns ``(object, probe)``,
    complex64 tensors on the device, after ``n_epochs`` sweeps."""
    dev = resolve_device(device)
    data = torch.abs(_tensor(data, torch.float32, dev))
    if raw_data_type == 'intensity':
        data = torch.sqrt(data)
    probe = _tensor(probe, torch.complex64, dev).clone()
    obj = _tensor(obj_init, torch.complex64, dev).clone()
    pos = np.asarray(probe_pos).astype(np.int64)
    py, px = probe.shape
    ys = _window_starts(pos[:, 0], obj.shape[0], py)
    xs = _window_starts(pos[:, 1], obj.shape[1], px)
    corr = (None if probe_pos_correction is None
            else _tensor(probe_pos_correction, torch.float32, dev))
    for _ in range(n_epochs):
        for j in range(len(pos)):
            win = obj[ys[j]:ys[j] + py, xs[j]:xs[j] + px]
            sub = win.clone()
            probe_j = probe if corr is None else fourier_shift(probe, corr[j])
            ex = probe_j * sub
            dp = fft2_and_shift(ex)
            mag = torch.clamp(torch.abs(dp), min=1e-12)
            d = ishift_and_ifft2(dp * (data[j] / mag)) - ex
            win.copy_(sub + alpha * torch.conj(probe_j) * d
                      / torch.max(torch.abs(probe_j) ** 2))
            if update_probe:
                probe = probe + (alpha * torch.conj(sub) * d
                                 / torch.max(torch.abs(sub) ** 2))
    return obj, probe


def multidistance_ctf(prj_ls, free_prop_cm, energy_ev, psize_cm, kappa=50.0,
                      safe_zone_width=0, prj_affine_ls=None, device=None):
    """Multi-distance CTF phase retrieval.

    ``prj_ls``: ``[n_dists, y, x]`` measured normalized intensities (flat
    field ~ 1); ``free_prop_cm``: ``[n_dists]`` distances;
    ``prj_affine_ls``: optional ``[n_dists, 2, 3]`` affines, each warping
    its hologram first; ``safe_zone_width``: an edge pad taken off again
    at the end.  Returns the retrieved phase map ``[y, x]``, float32 on
    the device (``None`` means CUDA)."""
    dev = resolve_device(device)
    prj = _tensor(prj_ls, torch.float32, dev)
    if prj_affine_ls is not None:
        aff = _tensor(prj_affine_ls, torch.float32, dev)
        prj = torch.stack([affine_transform_2d(prj[i:i + 1], aff[i])[0]
                           for i in range(prj.shape[0])])
    s = int(safe_zone_width)
    if s > 0:
        prj = F.pad(prj[None], (s, s, s, s), mode='replicate')[0]
    lmbda_nm = wavelength_nm(energy_ev)
    u, v = gen_freq_mesh((psize_cm * 1e7,) * 2, prj.shape[-2:], dev)
    quad = u * u + v * v
    ft = fft2((prj - 1.0).to(torch.complex64), norm='ortho')
    dist_nm_ls = np.atleast_1d(np.asarray(free_prop_cm, np.float64)) * 1e7
    num = 0.0
    den = 0.0
    for i in range(len(dist_nm_ls)):
        xi = float(PI * lmbda_nm * dist_nm_ls[i]) * quad
        filt = torch.sin(xi) + torch.cos(xi) / kappa
        num = num + filt * ft[i]
        den = den + 2.0 * filt ** 2
    phase = torch.real(ifft2(num / (den + 1e-10), norm='ortho'))
    if s > 0:
        phase = phase[s:-s, s:-s]
    return phase
