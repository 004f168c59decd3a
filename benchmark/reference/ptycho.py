"""Plain reference of one per-angle step of multislice ptychotomography
(Adorym's ``update_scheme='per angle'`` with ``rotate_out_of_loop``), in
plain PyTorch, float32, TF32 off (the control rounds the DFTs' operands
to TF32 itself).

One step, for one angle ``theta`` and its minibatches:

1. rotate the object ``[y, x, z, 2]`` (delta, beta) about the y axis by
   ``theta``: each (x, z) plane resampled bilinearly about its centre
   ``(n - 1) / 2``, source points clamped to the edges;
2. sum it over bins of ``binning`` slices in z (the far end padded with 0);
3. cut a ``py x px`` window at each scan position, vacuum (0) past the
   object's edge;
4. multislice: the probe modes times the transmission ``exp(-k1 beta -
   i k1 delta)`` of each binned slice, ``k1 = 2 pi dz / lambda`` with
   ``dz`` one voxel, a Fresnel propagation ``H = exp(-i pi lambda d (u^2 +
   v^2))`` over ``d = binning * dz`` between slices, and after the last
   slice the far field, the fftshifted and unnormalised 2-D DFT;
5. the detected magnitude ``sqrt(sum over modes |psi|^2)`` and the loss,
   each minibatch's mean over its patterns of the mean squared difference
   from the measured magnitudes; the step's objective is the sum of its
   minibatches' losses;
6. the gradient (autograd) in the binned, rotated object and in the probe,
   the binned gradient spread back over each bin's slices and rotated by
   ``-theta`` the same way as in 1 (Adorym's rotate-back, which is not the
   rotation's exact transpose);
7. Adam (b1 0.9, b2 0.999, eps 1e-7 after the square root, bias-corrected)
   on the object, and on the probe where it is refined.

Departures from the program's arithmetic, none of which changes the
mathematics: the 2-D DFTs are products with the DFT matrices (complex64
matmuls, whose operands the control rounds to TF32) and not FFTs; the
propagation is DFT, product with H, inverse DFT, not a folded step;
the gradient is taken by autograd through the sweep, with the sweep
recomputed in segments (``torch.utils.checkpoint``) so that it fits;
the square root's derivative is clamped below at ``1e-6`` as Adorym's,
where the intensity underflows; sums run in another order.

Imports only torch and numpy.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

HC_EV_NM = 1240.0
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-7
#: Bytes of transmissions ``[S, B, py, px]`` complex64 one block of
#: patterns may hold; the angle's patterns go through in blocks of whole
#: minibatches under it.
BLOCK_BYTES = 6e9


# -- geometry ------------------------------------------------------------

def rotate_y(vol: torch.Tensor, theta: float) -> torch.Tensor:
    """``vol[y, x, z, ...]`` rotated about the y axis by ``theta``."""
    nx, nz = vol.shape[1], vol.shape[2]
    dev = vol.device
    th = torch.tensor(theta, dtype=torch.float32, device=dev)
    c, s = torch.cos(th), torch.sin(th)
    gx = torch.arange(nx, dtype=torch.float32, device=dev)[:, None] - (nx - 1) / 2
    gz = torch.arange(nz, dtype=torch.float32, device=dev)[None, :] - (nz - 1) / 2
    sx = (c * gx - s * gz + (nx - 1) / 2).clamp(0, nx - 1)
    sz = (s * gx + c * gz + (nz - 1) / 2).clamp(0, nz - 1)
    x0, z0 = torch.floor(sx), torch.floor(sz)
    wx, wz = sx - x0, sz - z0
    x0, z0 = x0.long(), z0.long()
    x1, z1 = (x0 + 1).clamp(max=nx - 1), (z0 + 1).clamp(max=nz - 1)
    planes = vol.movedim(0, 2)                 # [x, z, y, ...]
    tail = (1,) * (planes.dim() - 2)
    out = 0
    for xi, zi, w in ((x0, z0, (1 - wx) * (1 - wz)), (x0, z1, (1 - wx) * wz),
                      (x1, z0, wx * (1 - wz)), (x1, z1, wx * wz)):
        out = out + planes[xi, zi] * w.reshape(w.shape + tail)
    return out.movedim(2, 0).contiguous()


def bin_z(vol: torch.Tensor, binning: int) -> torch.Tensor:
    """Sums over bins of ``binning`` slices along z (axis 2), the far end
    padded with zeros."""
    nz = vol.shape[2]
    nb = -(-nz // binning)
    pad = nb * binning - nz
    if pad:
        vol = torch.cat([vol, vol.new_zeros(vol.shape[:2] + (pad,)
                                            + vol.shape[3:])], 2)
    return vol.reshape(vol.shape[:2] + (nb, binning) + vol.shape[3:]).sum(3)


def expand_z(vol: torch.Tensor, binning: int, nz: int) -> torch.Tensor:
    """Each bin's value at each of its slices (the transpose of
    :func:`bin_z`), cut to ``nz`` slices."""
    return torch.repeat_interleave(vol, binning, dim=2)[:, :, :nz]


def windows(positions: np.ndarray, probe_size, obj_yx):
    """Row and column indices ``[N, py]``, ``[N, px]`` of each window in the
    object padded by ``pads`` (returned too), which holds every window."""
    pos = np.round(np.asarray(positions)).astype(np.int64)
    pads = []
    for ax in range(2):
        lo = int(pos[:, ax].min())
        hi = int(pos[:, ax].max()) + int(probe_size[ax])
        pads.append((max(0, -lo), max(0, hi - int(obj_yx[ax]))))
    iy = pos[:, :1] + pads[0][0] + np.arange(probe_size[0])
    ix = pos[:, 1:] + pads[1][0] + np.arange(probe_size[1])
    return iy, ix, pads


# -- transforms ----------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (complex64) with its real and imaginary parts rounded to TF32
    (10 mantissa bits), its gradient passed through: TF32's input
    rounding, the products then summed in float32."""
    i = torch.view_as_real(x.detach()).contiguous().view(torch.int32)
    r = torch.view_as_complex(((i + 0x1000) & -0x2000).view(torch.float32))
    return x + (r - x).detach()


class Transforms:
    """The DFT matrices and the step's transfer function of one geometry,
    and the precision of the matmuls' operands (``'f32'``, or ``'tf32'``:
    rounded to TF32, the products summed in float32, on any device)."""

    def __init__(self, n: int, m: int, psize_nm: float, lmbda_nm: float,
                 dist_nm: float, device, precision: str = 'f32'):
        if precision not in ('f32', 'tf32'):
            raise ValueError(f'unknown precision {precision!r}')
        self.emulate = precision == 'tf32'
        self.fy, self.gy = self._dft(n, device)
        self.fx, self.gx = self._dft(m, device)
        u = np.fft.fftfreq(n)[:, None] / psize_nm
        v = np.fft.fftfreq(m)[None, :] / psize_nm
        h = np.exp(-1j * np.pi * lmbda_nm * dist_nm * (u * u + v * v))
        self.h = torch.from_numpy(h.astype(np.complex64)).to(device)

    @staticmethod
    def _dft(n, device):
        """The DFT matrix of size ``n`` and its inverse, complex64."""
        k = np.arange(n)
        f = np.exp(-2j * np.pi * np.outer(k, k) / n)
        return (torch.from_numpy(f.astype(np.complex64)).to(device),
                torch.from_numpy((np.conj(f) / n).astype(np.complex64))
                .to(device))

    def _mm(self, a, b):
        if self.emulate:
            a, b = _tf32(a), _tf32(b)
        return torch.matmul(a, b)

    def dft2(self, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
        """``F_y x F_x`` (the DFT matrices are symmetric); ``inverse``: the
        inverse DFT, ``conj(F) / n`` on each axis."""
        fy, fx = (self.gy, self.gx) if inverse else (self.fy, self.fx)
        return self._mm(self._mm(fy, x), fx)

    @staticmethod
    @contextlib.contextmanager
    def tf32_off():
        """TF32 off for CUDA matmuls inside, the flags restored after (the
        control rounds its operands itself)."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


class _SqrtClamped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * 0.5 / torch.clamp(y, min=1e-6)


def _segment(tr: Transforms, w, t_seg):
    for t in t_seg:
        w = tr.dft2(tr.dft2(w * t) * tr.h, inverse=True)
    return w


def magnitudes(tr: Transforms, patches, probe, k1: float):
    """Detected magnitudes ``[N, py, px]`` of binned patches ``[N, py, px,
    S, 2]`` under the probe modes ``[M, py, px, 2]``."""
    delta = patches[..., 0].movedim(-1, 0)            # [S, N, py, px]
    beta = patches[..., 1].movedim(-1, 0)
    mag = torch.exp(-k1 * beta)
    t = torch.complex(mag * torch.cos(-k1 * delta), mag * torch.sin(-k1 * delta))
    p = torch.complex(probe[..., 0], probe[..., 1])   # [M, py, px]
    w = p[:, None].expand(p.shape[0], t.shape[1], *p.shape[1:])
    n_steps = t.shape[0]
    seg = max(1, int(math.ceil(math.sqrt(n_steps))))
    for s0 in range(0, n_steps - 1, seg):
        s1 = min(s0 + seg, n_steps - 1)
        w = checkpoint(_segment, tr, w, t[s0:s1], use_reentrant=False)
    far = torch.fft.fftshift(tr.dft2(w * t[-1]), dim=(-2, -1))
    return _SqrtClamped.apply((far.real ** 2 + far.imag ** 2).sum(0))


# -- one step ------------------------------------------------------------

def angle_step(cfg: dict, obj, probe, theta: float, positions, batches,
               measured, precision: str = 'f32', refine_probe: bool = False):
    """Losses and gradients of one angle at ``(obj, probe)``: returns
    ``(per-minibatch losses [n_b], grad obj [y, x, z, 2], grad probe or
    None)``.  ``batches``: the minibatches' spot indices; ``measured``:
    the angle's magnitudes ``[n_pos, py, px]``."""
    dev = obj.device
    binning = int(cfg['binning'])
    py, px = cfg['probe_size']
    psize_nm = cfg['psize_cm'] * 1e7
    lmbda_nm = HC_EV_NM / cfg['energy_ev']
    k1 = 2 * math.pi * psize_nm / lmbda_nm
    tr = Transforms(py, px, psize_nm, lmbda_nm, psize_nm * binning, dev,
                    precision)
    nz = obj.shape[2]
    with tr.tf32_off():
        binned = bin_z(rotate_y(obj, theta), binning)
        iy, ix, pads = windows(positions, (py, px), obj.shape[:2])
        slab = torch.nn.functional.pad(
            binned, (0, 0, 0, 0, pads[1][0], pads[1][1], pads[0][0],
                     pads[0][1])).requires_grad_(True)
        pr = probe.detach().clone().requires_grad_(refine_probe)
        mb = len(batches[0])
        n_steps = slab.shape[2]
        per_block = max(1, int(BLOCK_BYTES // (n_steps * mb * py * px * 8)))
        g_slab = torch.zeros_like(slab)
        g_probe = torch.zeros_like(pr) if refine_probe else None
        losses = []
        for b0 in range(0, len(batches), per_block):
            blk = batches[b0:b0 + per_block]
            spots = np.concatenate([np.asarray(b) for b in blk])
            ry = torch.from_numpy(iy[spots]).to(dev)
            rx = torch.from_numpy(ix[spots]).to(dev)
            with torch.enable_grad():
                patches = slab[ry[:, :, None], rx[:, None, :]]
                mag = magnitudes(tr, patches, pr, k1)
                meas = measured[torch.from_numpy(spots).to(dev)]
                per_batch = ((mag - meas) ** 2).mean((1, 2)).reshape(
                    len(blk), -1).mean(1)
                leaves = [slab] + ([pr] if refine_probe else [])
                grads = torch.autograd.grad(per_batch.sum(), leaves)
            g_slab += grads[0]
            if refine_probe:
                g_probe += grads[1]
            losses.append(per_batch.detach())
            del patches, mag, grads
        g_binned = g_slab[pads[0][0]:g_slab.shape[0] - pads[0][1],
                          pads[1][0]:g_slab.shape[1] - pads[1][1]]
        g_obj = rotate_y(expand_z(g_binned, binning, nz), -theta)
    return torch.cat(losses), g_obj, g_probe


def adam(p, g, state, t: int, lr: float):
    """One Adam step of leaf ``p`` (``t`` counts from 1); returns the new
    leaf and state."""
    m = ADAM_B1 * state['m'] + (1 - ADAM_B1) * g
    v = ADAM_B2 * state['v'] + (1 - ADAM_B2) * g * g
    bc1 = float(1 - np.float32(ADAM_B1) ** np.float32(t))
    bc2 = float(1 - np.float32(ADAM_B2) ** np.float32(t))
    return p - lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS), {'m': m, 'v': v}


def follow(cfg: dict, obj0, probe0, steps: Sequence[dict], positions,
           precision: str = 'f32') -> Dict[str, object]:
    """The reference run from ``(obj0, probe0)`` through ``steps`` (each
    ``{'theta', 'batches', 'measured'}``): each step's losses, the first
    step's gradient of each refined leaf, and each leaf's change after the
    last step."""
    refine_probe = bool(cfg.get('optimize_probe'))
    lrs = {'obj': cfg['learning_rate']}
    if refine_probe:
        lrs['probe'] = cfg.get('probe_learning_rate', 1e-3)
    params = {'obj': obj0.clone(), 'probe': probe0.clone()}
    state = {k: {'m': torch.zeros_like(params[k]),
                 'v': torch.zeros_like(params[k])} for k in lrs}
    out: Dict[str, object] = {'losses': [], 'grad1': {}, 'change': {},
                              'seconds': []}
    for k, st in enumerate(steps):
        t0 = time.perf_counter()
        losses, g_obj, g_probe = angle_step(
            cfg, params['obj'], params['probe'], st['theta'], positions,
            st['batches'], st['measured'], precision, refine_probe)
        grads = {'obj': g_obj, 'probe': g_probe}
        out['losses'].append(losses.cpu())
        if k == 0:
            out['grad1'] = {n: grads[n].detach().cpu() for n in lrs}
        for n, lr in lrs.items():
            params[n], state[n] = adam(params[n], grads[n], state[n], k + 1, lr)
        if obj0.is_cuda:
            torch.cuda.synchronize(obj0.device)
        out['seconds'].append(time.perf_counter() - t0)
    out['change'] = {n: (params[n] - p0).cpu() for n, p0 in
                     (('obj', obj0), ('probe', probe0)) if n in lrs}
    return out


def leaf_names(cfg: dict) -> List[str]:
    return ['obj'] + (['probe'] if cfg.get('optimize_probe') else [])
