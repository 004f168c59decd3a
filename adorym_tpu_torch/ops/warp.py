"""2D affine image warping with torch-``affine_grid`` semantics, as the
JAX package computes it (``adorym_tpu/ops/warp.py``): the ``[2, 3]``
matrix maps output normalized coordinates (x, y in [-1, 1],
align_corners=False) to input ones, and the image is sampled bilinearly at
the edge-clamped input pixel.  The gather is written out here (not
``F.grid_sample``) so that the edges and the matrix's gradient there
follow the JAX gather: the coordinates clamp to ``[0, s - 1]`` by
``minimum``/``maximum``, whose gradient splits at a tie as ``jnp.clip``'s
does.  Differentiable in the image and the matrix (``prj_affine_ls`` is
a refinable)."""

from __future__ import annotations

import torch


def _clip(c, hi):
    """``c`` clamped to ``[0, hi]``, with ``jnp.clip``'s gradient (half at
    a tie)."""
    return torch.minimum(torch.maximum(c, c.new_tensor(0.0)),
                         c.new_tensor(float(hi)))


def bilinear_gather_plane(imgs, c_row, c_col):
    """Bilinear samples of ``imgs[N, H, W]`` at ``(c_row, c_col)`` (each
    ``[H', W']``), the coordinates edge-clamped: ``[N, H', W']``."""
    _, h, w = imgs.shape
    c1 = _clip(c_row, h - 1)
    c2 = _clip(c_col, w - 1)
    f1 = torch.floor(c1)
    f2 = torch.floor(c2)
    w1 = c1 - f1
    w2 = c2 - f2
    i1 = f1.long()
    i2 = f2.long()
    i1c = torch.clamp(i1 + 1, max=h - 1)
    i2c = torch.clamp(i2 + 1, max=w - 1)
    out = None
    for a, b, wt in ((i1, i2, (1 - w1) * (1 - w2)), (i1, i2c, (1 - w1) * w2),
                     (i1c, i2, w1 * (1 - w2)), (i1c, i2c, w1 * w2)):
        term = imgs[:, a, b] * wt.to(imgs.dtype)
        out = term if out is None else out + term
    return out


def affine_transform_2d(imgs, mat):
    """Warp the stack ``imgs[N, H, W]`` by one ``[2, 3]`` affine matrix
    ``mat`` (rows (x, y) in torch order, x the W axis; align_corners=False
    normalization ``x_norm = (2 j + 1) / W - 1``)."""
    _, h, w = imgs.shape
    dev = imgs.device
    jj = (2.0 * torch.arange(w, dtype=torch.float32, device=dev) + 1.0) / w - 1.0
    ii = (2.0 * torch.arange(h, dtype=torch.float32, device=dev) + 1.0) / h - 1.0
    x_out = jj[None, :].expand(h, w)
    y_out = ii[:, None].expand(h, w)
    x_in = mat[0, 0] * x_out + mat[0, 1] * y_out + mat[0, 2]
    y_in = mat[1, 0] * x_out + mat[1, 1] * y_out + mat[1, 2]
    c_col = ((x_in + 1.0) * w - 1.0) / 2.0
    c_row = ((y_in + 1.0) * h - 1.0) / 2.0
    return bilinear_gather_plane(imgs, c_row, c_col)
