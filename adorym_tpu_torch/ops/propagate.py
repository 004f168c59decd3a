"""Wave-optics propagation: Fresnel kernels, multislice, far field, the
projection approximation, sparse multislice and the CTF.

Counterpart of ``adorym_tpu/ops/propagate.py``.  Sign conventions as in
the reference: ``sign_convention=1`` is the Goodman ``exp(ikz)``
convention with ``n = 1 - delta + i*beta``.  Energies in eV, wavelengths
and voxels in nm, distances in nm unless the name says ``_cm``.

:func:`multislice_propagate` keeps the JAX package's branches: the plain
FFT z scan; the fused delta_beta dispatch, which on CUDA runs one of the
two multislice kernels of :mod:`.cuda_multislice` (stored intermediates,
or invertible steps when the records would be large); the general fused
scan (real_imag, or a non-paraxial transfer function), which runs the
kernel of :mod:`.cuda_multislice_fused`; one slice repeated; and the
propagation in -z (``backprop``), which hands the kernels the -z step and
the flipped modulator sign.  Each kernel's plain version runs on the CPU.
A single-material ``kappa`` (``beta = kappa * delta``) reaches the
kernels through a freshly packed stack.

Distances may be tensors (a refined ``free_prop_cm``, probe defocus or
slice position, and the CTF's kappa): the kernels and propagations built
from them stay differentiable in them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import PI, wavelength_nm
from ..utils.profiling import hbm_limit_bytes
from .fourier import dft_matrix, fft2, fft2_and_shift, ifft2, ifft2_and_shift


def _db_stored_max_bytes(device) -> float:
    """Stored-intermediates switch of the fused delta_beta branch: above
    this many bytes of per-chunk forward records the invertible kernel
    (K4) takes over from the stored one (K1), as in the JAX package.  One
    eighth of the device's memory (16e9 / 8 on the CPU, the JAX package's
    default)."""
    return hbm_limit_bytes(device) / 8


@functools.lru_cache(maxsize=64)
def _freq_mesh_np(voxel_nm: tuple, shape: tuple):
    """(u, v) spatial-frequency grids in cycles/nm, fftfreq-ordered: ``u``
    varies along y scaled by 1/voxel_y, ``v`` along x."""
    u = (np.fft.fftfreq(shape[0]) / voxel_nm[0]).astype(np.float32)
    v = (np.fft.fftfreq(shape[1]) / voxel_nm[1]).astype(np.float32)
    uu = np.ascontiguousarray(np.broadcast_to(u[:, None], shape))
    vv = np.ascontiguousarray(np.broadcast_to(v[None, :], shape))
    return uu, vv


def gen_freq_mesh(voxel_nm, shape, device='cpu'):
    """The (u, v) frequency mesh (:func:`_freq_mesh_np`) as float32
    tensors on ``device``."""
    uu, vv = _freq_mesh_np(tuple(float(v) for v in voxel_nm[:2]),
                           tuple(int(s) for s in shape[:2]))
    return (torch.from_numpy(uu).to(device), torch.from_numpy(vv).to(device))


def fresnel_kernel(shape, voxel_nm, lmbda_nm, dist_nm, fresnel_approx=True,
                   sign_convention=1, device='cpu'):
    """Unshifted Fresnel transfer function H(u, v), complex64 on
    ``device``; the non-paraxial form masks evanescent modes.  ``dist_nm``
    may be a float32 tensor on ``device`` (a refined distance): H is then
    differentiable in it."""
    u, v = gen_freq_mesh(voxel_nm, shape, device)
    quad = u * u + v * v
    if fresnel_approx:
        phase = -sign_convention * PI * lmbda_nm * dist_nm * quad
        return torch.polar(torch.ones_like(phase), phase)
    q = 1.0 - lmbda_nm ** 2 * quad
    mask = (q > 0).float()
    phase = (sign_convention * 2.0 * PI * dist_nm / lmbda_nm
             * torch.sqrt(torch.clamp(q, min=0.0)))
    return torch.polar(mask, phase)


@functools.lru_cache(maxsize=16)
def _step_kernel(shape, voxel_nm, lmbda_nm, dist_nm, fresnel_approx,
                 sign_convention, device):
    """The multislice step's transfer function, one tensor per geometry and
    device: the kernels' step operands built from it (K5's step table) are
    then built once, not per chunk.  Read only.  The distance is geometry,
    a float: a refined (tensor) distance goes through
    :func:`fresnel_kernel`."""
    return fresnel_kernel(shape, voxel_nm, lmbda_nm, dist_nm,
                          fresnel_approx=fresnel_approx,
                          sign_convention=sign_convention, device=device)


def fresnel_kernel_ir(shape, voxel_nm, lmbda_nm, dist_nm, sign_convention=1,
                      device='cpu'):
    """The impulse-response method's Fresnel kernel: the FFT of the
    sampled real-space response, built in float64 and returned complex64
    on ``device``."""
    size_nm = np.asarray(voxel_nm[:2]) * np.asarray(shape[:2])
    k = 2.0 * PI / lmbda_nm
    y = np.arange(shape[0], dtype=np.float64) * voxel_nm[0] - size_nm[0] / 2.0
    x = np.arange(shape[1], dtype=np.float64) * voxel_nm[1] - size_nm[1] / 2.0
    yy = y[:, None]
    xx = x[None, :]
    h = (np.exp(sign_convention * 1j * k * dist_nm) / (1j * lmbda_nm * dist_nm)
         * np.exp(sign_convention * 1j * k / (2.0 * dist_nm)
                  * (xx ** 2 + yy ** 2)))
    return torch.from_numpy(np.fft.fft2(h).astype(np.complex64)).to(device)


def fresnel_propagate(wave, dist_nm, lmbda_nm, voxel_nm, fresnel_approx=True,
                      sign_convention=1):
    """Propagate a (batched) wave by ``dist_nm`` with the TF method."""
    kernel = fresnel_kernel(wave.shape[-2:], voxel_nm, lmbda_nm, dist_nm,
                            fresnel_approx=fresnel_approx,
                            sign_convention=sign_convention,
                            device=wave.device)
    return ifft2(fft2(wave) * kernel)


def final_prop_mats(shape, voxel_nm, lmbda_nm, free_prop_cm,
                    sign_convention=1, normalize_fft=False,
                    fresnel_approx=True, device='cpu'):
    """Object-to-detector propagation as per-axis dense matrices
    ``(ay, ax, ay_inv, ax_inv)``, complex64 on ``device``, such that
    ``free_space_propagate(w) == ay @ w @ ax.T``; None when the
    propagation is not a separable matrix pair (non-paraxial finite
    distance).  The Fraunhofer pair is fftshift @ DFT per axis and is NOT
    unitary when unnormalized, so its exact inverse is returned."""
    ny, nx = int(shape[0]), int(shape[1])

    def to_dev(*mats):
        return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                     for m in mats)

    if isinstance(free_prop_cm, str) and free_prop_cm == 'inf':
        def axis(n):
            shift_perm = np.fft.fftshift(np.eye(n, dtype=np.complex64),
                                         axes=0)
            f = dft_matrix(n)
            g = dft_matrix(n, inverse=True)
            if sign_convention == 1:
                a, ai = shift_perm @ f, g @ shift_perm.T
            else:
                a, ai = shift_perm @ g, f @ shift_perm.T
            if normalize_fft:          # 'ortho'
                r = np.sqrt(np.float32(n))
                if sign_convention == 1:
                    a, ai = a / r, ai * r
                else:
                    a, ai = a * r, ai / r
            return a, ai

        ay, ayi = axis(ny)
        ax, axi = axis(nx)
        return to_dev(ay, ax, ayi, axi)
    if not fresnel_approx:
        return None
    # Folded TF pair built in float64: the Fresnel phase reaches 1e3..1e6
    # rad at detector distances, where f32 phase rounding shows.
    dist_nm = float(free_prop_cm) * 1e7

    def axis_tf(n, voxel):
        u = np.fft.fftfreq(n) / voxel
        h = np.exp(-1j * sign_convention * np.pi * lmbda_nm * dist_nm
                   * u * u)
        k = np.arange(n)
        f = np.exp(-2j * np.pi * np.outer(k, k) / n)
        g = np.conj(f) / n
        a = (g * h[None, :]) @ f
        ai = (g * np.conj(h)[None, :]) @ f
        return a.astype(np.complex64), ai.astype(np.complex64)

    ay, ayi = axis_tf(ny, float(voxel_nm[0]))
    ax, axi = axis_tf(nx, float(voxel_nm[1]))
    return to_dev(ay, ax, ayi, axi)


def free_space_propagate(wave, free_prop_cm, lmbda_nm, voxel_nm,
                         sign_convention=1, normalize_fft=False,
                         fresnel_approx=True):
    """Object-to-detector propagation: ``'inf'`` is the Fraunhofer far
    field (fftshifted FFT2, IFFT2 for the opposite sign convention,
    unnormalized unless ``normalize_fft``); a finite distance uses the
    Fresnel TF method.  A tensor distance (a refined ``free_prop_cm``)
    keeps the propagation differentiable in it."""
    if free_prop_cm is None or (isinstance(free_prop_cm, (int, float))
                                and free_prop_cm == 0):
        return wave
    if isinstance(free_prop_cm, str) and free_prop_cm == 'inf':
        norm = 'ortho' if normalize_fft else None
        if sign_convention == 1:
            return fft2_and_shift(wave, norm=norm)
        return ifft2_and_shift(wave, norm=norm)
    dist_nm = (free_prop_cm * 1e7 if torch.is_tensor(free_prop_cm)
               else float(free_prop_cm) * 1e7)
    return fresnel_propagate(wave, dist_nm, lmbda_nm, voxel_nm,
                             fresnel_approx=fresnel_approx,
                             sign_convention=sign_convention)


def slice_modulator(delta, beta, k1, unknown_type='delta_beta',
                    sign_convention=1):
    """Complex64 transmission of one (possibly binned) slice:
    ``exp(-k1*beta) * exp(-i*sign*k1*delta)`` for delta_beta; the channels
    themselves for real_imag."""
    if unknown_type == 'delta_beta':
        mag = torch.exp(-k1 * beta.float())
        phase = -sign_convention * k1 * delta.float()
        return torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    if unknown_type == 'real_imag':
        return torch.complex(delta.float(), beta.float())
    raise ValueError("unknown_type must be 'delta_beta' or 'real_imag'")


def _pad_z_to_multiple(arr, binning, unknown_type):
    """Pad the leading z axis (far end) up to a multiple of ``binning``
    with the reduction identity (0 for sums, 1 for products)."""
    pad = -arr.shape[0] % binning
    if pad:
        cval = 0.0 if unknown_type == 'delta_beta' else 1.0
        fill = torch.full((pad,) + tuple(arr.shape[1:]), cval,
                          dtype=arr.dtype, device=arr.device)
        arr = torch.cat([arr, fill], 0)
    return arr


def bin_z_sum(arr, binning, axis):
    """Zero-padded bin-sum along ``axis`` (the delta_beta binning: the
    far-end pad joins the short tail bin)."""
    if binning == 1:
        return arr
    axis = axis % arr.dim()
    nz = arr.shape[axis]
    pad = -nz % binning
    if pad:
        shape = list(arr.shape)
        shape[axis] = pad
        arr = torch.cat([arr, arr.new_zeros(shape)], axis)
    shape = (tuple(arr.shape[:axis]) + ((nz + pad) // binning, binning)
             + tuple(arr.shape[axis + 1:]))
    return arr.reshape(shape).sum(axis + 1)


def _bin_slices(arr, binning, unknown_type):
    """Reduce the leading (pre-padded) z axis in bins of ``binning``."""
    if binning == 1:
        return arr
    arr = arr.reshape((arr.shape[0] // binning, binning)
                      + tuple(arr.shape[1:]))
    if unknown_type == 'delta_beta':
        return arr.sum(1)
    return arr.prod(1)


class BinRealImag(torch.autograd.Function):
    """The real_imag transmissions of packed patches, binned in z in one
    pass: ``stack[N, py, px, nz, 2]`` (f32 or bf16; channel 0 the real
    part, 1 the imaginary part) to ``t[S, N, py, px]`` complex64 with ``S =
    ceil(nz / binning)``.  Each channel is multiplied over each bin of
    ``binning`` slices on its own, the short tail bin over the slices it
    has (the reference pads it with 1): the JAX package's ``_pad_z_to_multiple``
    and ``_bin_slices`` of both channels, then ``delta + i beta``.  The
    products are taken in f32 whatever the storage type.

    The backward writes the packed gradient in one pass over the stack,
    each slice's the incoming gradient times the exact product of its
    bin's other slices, in f32 (:func:`_bin_product_grad`): no division,
    so zeros need no count, and no scan.  Its temporaries, by chunks of
    patches, hold three eighths of the stack's elements; nothing of it selects
    channels or holds per-channel copies of the stack."""

    @staticmethod
    def forward(ctx, stack, binning):
        stack = stack.contiguous()
        ctx.save_for_backward(stack)
        ctx.binning = binning
        n, py, px, nz, _ = stack.shape
        full = nz // binning * binning
        parts = []
        if full:
            parts.append(stack[..., :full, :].reshape(
                n, py, px, full // binning, binning, 2).prod(
                    4, dtype=torch.float32))
        if full < nz:
            parts.append(stack[..., full:, :].prod(3, keepdim=True,
                                                   dtype=torch.float32))
        t = parts[0] if len(parts) == 1 else torch.cat(parts, 3)
        ctx.save_for_forward(stack)
        return torch.view_as_complex(t.permute(3, 0, 1, 2, 4).contiguous())

    @staticmethod
    def jvp(ctx, dstack, _):
        """The binned product's tangent: at each bin, the sum over its
        slices of the slice's tangent times the product of the bin's
        other slices (:func:`_bin_product_grad` at a unit gradient), in
        f32."""
        (stack,) = ctx.saved_tensors
        binning = ctx.binning
        n, py, px, nz, _ = stack.shape
        full = nz // binning * binning
        parts = []
        for zs, size in ((slice(0, full), binning),
                         (slice(full, nz), nz - full)):
            if zs.stop > zs.start:
                x = stack[..., zs, :]
                bins = (zs.stop - zs.start) // size
                others = torch.empty(x.shape, dtype=torch.float32,
                                     device=x.device)
                _bin_product_grad(x, others.new_ones((n, py, px, bins, 2)),
                                  others, size)
                parts.append((others * dstack[..., zs, :].float()).reshape(
                    n, py, px, bins, size, 2).sum(4))
        t = parts[0] if len(parts) == 1 else torch.cat(parts, 3)
        return torch.view_as_complex(t.permute(3, 0, 1, 2, 4).contiguous())

    @staticmethod
    def backward(ctx, grad_t):
        (stack,) = ctx.saved_tensors
        binning = ctx.binning
        nz = stack.shape[3]
        full = nz // binning * binning
        # d t / d re is the real part of PyTorch's gradient, d t / d im the
        # imaginary part: [N, py, px, S, 2], patch-major like the stack.
        g = torch.view_as_real(grad_t.resolve_conj()).permute(
            1, 2, 3, 0, 4).contiguous()
        grad = torch.empty_like(stack)
        groups = [(slice(0, full), slice(0, full // binning), binning),
                  (slice(full, nz), slice(full // binning, None), nz - full)]
        for zs, bins, size in groups:
            if zs.stop > zs.start:
                _bin_product_grad(stack[..., zs, :], g[..., bins, :],
                                  grad[..., zs, :], size)
        return grad, None


#: Patch chunks of the binning's backward: its temporaries are this
#: fraction of the stack.
_BIN_CHUNKS = 8


def _bin_product_grad(x, g, grad, size):
    """Writes ``grad[N, py, px, bins * size, 2]``: at each slice, ``g[N,
    py, px, bins, 2]`` of its bin times the product of the bin's other
    slices, in f32.  By chunks of patches, each bin is doubled, so that
    the ``size - 1`` slices after slice k, cyclically, are the bin without
    k: one product over those windows, read whole bins at a time."""
    n, py, px = x.shape[:3]
    bins = g.shape[3]
    step = -(-n // _BIN_CHUNKS)
    for c0 in range(0, n, step):
        c = slice(c0, c0 + step)
        gc = g[c].unsqueeze(4)
        out = grad[c].view(-1, py, px, bins, size, 2)
        if size == 1:
            out.copy_(gc)
            continue
        xc = x[c].reshape(-1, py, px, bins, size, 2)
        y = torch.cat([xc, xc], 4)
        st = y.stride()
        others = y.as_strided(y.shape[:4] + (size, size - 1, 2),
                              st[:4] + (st[4], st[4], st[5]),
                              y.storage_offset() + st[4])
        torch.mul(others.prod(5, dtype=torch.float32), gc, out=out)


def bin_real_imag(stack, binning):
    """``t[S, N, py, px]`` complex64 from the packed real_imag patches
    ``stack[N, py, px, nz, 2]``, each channel multiplied over bins of
    ``binning`` slices (:class:`BinRealImag`)."""
    return BinRealImag.apply(stack, int(binning))


def multislice_propagate(delta, beta, wave, energy_ev, psize_cm,
                         slice_spacing_cm=None, binning=1,
                         unknown_type='delta_beta', fresnel_approx=True,
                         sign_convention=1, scale_ri_by_k=True, kappa=None,
                         repeats=None, backprop=False, fused='auto',
                         prebinned=False, final_prop=None, db_stack=None,
                         db_zmajor=None):
    """Multislice propagation through an object batch.

    ``delta``, ``beta``: ``[..., y, x, nz]`` channels; ``wave``: complex
    ``[..., y, x]``.  ``fused``: ``'auto'`` (the kernel when the wave is on
    CUDA) | True (the kernel; its plain version on the CPU) | False (the
    plain FFT scan).  ``final_prop``: optional ``{'free_prop_cm',
    'normalize_fft'}``; the returned wave then includes the detector
    propagation, folded into the kernel's last step where it is a
    separable matrix pair.  ``db_stack`` ``[..., y, x, nz, 2]`` or
    ``db_zmajor`` ``[nz, 2, ..., y, x]``: the packed channels the kernel
    consumes; a real_imag ``db_stack`` is binned from the packed layout in
    one pass (:func:`bin_real_imag`).  ``prebinned``: the z axis is already
    bin-summed.  ``kappa``: ``beta = kappa * delta`` (a float or a tensor,
    which then gets its gradient); the packed stacks are then stale and
    dropped.  ``repeats``: slice 0 applied this many times.
    ``backprop``: propagate in -z, the slices last to first, with the
    delta phase's sign flipped (absorption keeps its sign); not with
    ``final_prop``.  See ``adorym_tpu.ops.propagate.multislice_propagate``
    for the full contract.
    """
    lmbda_nm = wavelength_nm(energy_ev)
    dz_cm = psize_cm if slice_spacing_cm is None else slice_spacing_cm
    voxel_nm = (psize_cm * 1e7, psize_cm * 1e7, dz_cm * 1e7)
    delta_nm = voxel_nm[2]
    k1 = 2.0 * PI * delta_nm / lmbda_nm if scale_ri_by_k else 1.0
    prop_sign = -1.0 if backprop else 1.0
    mod_sign = -sign_convention if backprop else sign_convention
    if kappa is not None:
        beta = delta * kappa
        db_stack = db_zmajor = None
    if final_prop is not None and backprop:
        raise ValueError('final_prop is a detector-side propagation; '
                         'meaningless under backprop')

    def to_det(out):
        if final_prop is None:
            return out
        return free_space_propagate(
            out, final_prop['free_prop_cm'], lmbda_nm, voxel_nm,
            sign_convention=sign_convention,
            normalize_fft=final_prop.get('normalize_fft', False),
            fresnel_approx=fresnel_approx)

    if repeats is not None:
        if binning > 1:
            raise NotImplementedError('repeats with binning > 1')
        t = slice_modulator(delta[..., 0], beta[..., 0], k1, unknown_type,
                            mod_sign)
        kernel = fresnel_kernel(wave.shape[-2:], voxel_nm, lmbda_nm,
                                prop_sign * delta_nm,
                                fresnel_approx=fresnel_approx,
                                sign_convention=sign_convention,
                                device=wave.device)
        for i in range(repeats):
            wave = wave * t
            if i < repeats - 1:
                wave = ifft2(fft2(wave) * kernel)
        return to_det(wave)

    def z_first(arr, nz_axis=-1):
        """The z axis in front, padded at the far end to whole bins, in
        -z order under ``backprop`` (the pad joins the short bin in either
        direction), and binned."""
        arr = torch.movedim(arr, nz_axis, 0)
        if not prebinned:
            arr = _pad_z_to_multiple(arr, binning, unknown_type)
        if backprop:
            arr = torch.flip(arr, (0,))
        if not prebinned:
            arr = _bin_slices(arr, binning, unknown_type)
        return arr

    t_all = None
    if (unknown_type == 'real_imag' and db_stack is not None and not prebinned
            and not backprop):
        # The packed patches to the binned transmissions in one pass: no
        # channel selects or per-channel products for autograd to undo.
        t_all = bin_real_imag(db_stack, binning)
        n_steps, z_dims = t_all.shape[0], t_all.dim()
    else:
        delta_z = z_first(delta)
        beta_z = z_first(beta)
        n_steps, z_dims = delta_z.shape[0], delta_z.dim()

    db_z = None
    if unknown_type == 'delta_beta':
        if db_zmajor is not None:
            db_z = z_first(db_zmajor, 0)
        elif db_stack is not None:
            db_z = z_first(torch.movedim(db_stack, -1, 0))

    # The step's transfer function; in -z its factors per axis still give
    # the FFT route's step vectors (the route depends on the shape alone).
    kernel = _step_kernel(tuple(int(v) for v in wave.shape[-2:]), voxel_nm,
                          lmbda_nm, prop_sign * delta_nm * binning,
                          fresnel_approx, sign_convention, wave.device)
    if fused == 'auto':
        fused = wave.is_cuda
    fused = fused and wave.dim() == 4 and z_dims == 4

    if (fused and n_steps > 1 and unknown_type == 'delta_beta'
            and fresnel_approx):
        from . import cuda_multislice as cm
        # K1 keeps the forward's records through the backward; above one
        # eighth of the device's memory K4 rebuilds them instead.
        inter_bytes = n_steps * wave.numel() * 8
        invertible = inter_bytes > _db_stored_max_bytes(wave.device)
        if db_z is None:
            db_z = torch.stack([delta_z, beta_z.to(delta_z.dtype)], 1)
        if db_z.dtype not in (torch.float32, torch.bfloat16):
            db_z = db_z.float()
        f_mats = (None, None, None, None)
        folded = False
        if final_prop is not None:
            fp = final_prop['free_prop_cm']
            if fp is None or (isinstance(fp, (int, float)) and fp == 0):
                folded = True
            else:
                mats = final_prop_mats(
                    wave.shape[-2:], voxel_nm, lmbda_nm, fp,
                    sign_convention=sign_convention,
                    normalize_fft=final_prop.get('normalize_fft', False),
                    fresnel_approx=fresnel_approx, device=wave.device)
                if mats is not None:
                    f_mats, folded = mats, True
        wave = wave.to(torch.complex64)
        if invertible:
            out = cm.multislice_db_packed(db_z, wave, kernel, k1, mod_sign,
                                          *f_mats)
        else:
            out = cm.multislice_db_stored_packed(db_z, wave, kernel, k1,
                                                 mod_sign, *f_mats[:2])
        return out if folded else to_det(out)

    if t_all is None:
        t_all = slice_modulator(delta_z, beta_z, k1, unknown_type, mod_sign)
    if fused and n_steps > 1:
        # real_imag, or a transfer function that is not separable: the
        # general fused kernel, with the detector propagation after it.
        from .cuda_multislice_fused import multislice_fused
        return to_det(multislice_fused(t_all.to(torch.complex64),
                                       wave.to(torch.complex64), kernel))

    wv = wave
    for t in t_all[:-1]:
        wv = ifft2(fft2(wv * t) * kernel)
    return to_det(wv * t_all[-1])


def _as_complex(x):
    """A real tensor as complex64 with a zero imaginary part."""
    x = x.float()
    return torch.complex(x, torch.zeros_like(x))


def pure_projection_modulate(delta, beta, wave, energy_ev, psize_cm,
                             slice_spacing_cm=None, unknown_type='delta_beta',
                             sign_convention=1, scale_ri_by_k=True,
                             kappa=None, is_minus_logged=False,
                             return_sqrt=False, backprop=False):
    """The projection approximation: ``wave`` times the transmission of the
    z-summed (delta_beta) or z-multiplied (real_imag) object, no
    diffraction inside it.  ``is_minus_logged``: the projected beta (or
    ``-log |t|^2``) is the image itself, its square root with
    ``return_sqrt`` (intensity data).  ``kappa``: ``beta = kappa * delta``
    (a float or a tensor)."""
    lmbda_nm = wavelength_nm(energy_ev)
    dz_cm = psize_cm if slice_spacing_cm is None else slice_spacing_cm
    k1 = 2.0 * PI * (dz_cm * 1e7) / lmbda_nm if scale_ri_by_k else 1.0
    mod_sign = -sign_convention if backprop else sign_convention
    if unknown_type == 'delta_beta':
        d = torch.sum(delta, -1)
        b = d * kappa if kappa is not None else torch.sum(beta, -1)
        if is_minus_logged:
            t = _as_complex(torch.sqrt(b + 1e-10) if return_sqrt else b)
        else:
            t = slice_modulator(d, b, k1, 'delta_beta', mod_sign)
    elif unknown_type == 'real_imag':
        d = torch.prod(delta, -1)
        b = torch.prod(beta, -1)
        if is_minus_logged:
            val = -torch.log(d * d + b * b)
            t = _as_complex(torch.sqrt(val + 1e-10) if return_sqrt else val)
        else:
            t = torch.complex(d.float(), b.float())
    else:
        raise ValueError("unknown_type must be 'delta_beta' or 'real_imag'")
    return wave * t


def sparse_multislice_propagate(delta, beta, wave, energy_ev, psize_cm,
                                slice_pos_cm_ls, unknown_type='delta_beta',
                                fresnel_approx=True, sign_convention=1,
                                scale_ri_by_k=True):
    """Multislice through a few slices ``delta[..., i]`` at arbitrary z
    positions ``slice_pos_cm_ls`` (a sequence, or a float32 tensor that
    then gets its gradient: the refined slice positions), one Fresnel
    propagation between neighbours.  As in the reference, ``k1`` takes the
    lateral voxel size as the slice thickness."""
    lmbda_nm = wavelength_nm(energy_ev)
    voxel_nm = (psize_cm * 1e7,) * 3
    k1 = 2.0 * PI * voxel_nm[2] / lmbda_nm if scale_ri_by_k else 1.0
    if not torch.is_tensor(slice_pos_cm_ls):
        slice_pos_cm_ls = torch.as_tensor(
            np.asarray(slice_pos_cm_ls, np.float32), device=wave.device)
    slice_pos_nm = slice_pos_cm_ls * 1e7
    n_slices = delta.shape[-1]
    for i in range(n_slices):
        wave = wave * slice_modulator(delta[..., i], beta[..., i], k1,
                                      unknown_type, sign_convention)
        if i < n_slices - 1:
            wave = fresnel_propagate(
                wave, slice_pos_nm[i + 1] - slice_pos_nm[i], lmbda_nm,
                voxel_nm, fresnel_approx=fresnel_approx,
                sign_convention=sign_convention)
    return wave


def ctf_intensity_spectrum(wave, dist_nm, lmbda_nm, voxel_nm,
                           sign_convention=1):
    """The Fourier transform of the propagated intensity, ``F[I] = [Psi'
    H] * [Psi H']``, the convolution taken by orthonormal FFTs."""
    f = fft2(wave, norm='ortho')
    h = fresnel_kernel(wave.shape[-2:], voxel_nm, lmbda_nm, dist_nm,
                       sign_convention=sign_convention, device=wave.device)
    a1 = torch.conj(f) * h
    a2 = f * torch.conj(h)
    return ifft2(fft2(a1, norm='ortho') * fft2(a2, norm='ortho'),
                 norm='ortho')


def pure_phase_ctf(delta_proj, beta_proj, dist_nm, lmbda_nm, voxel_nm,
                   kappa=50.0):
    """The pure-phase CTF: the predicted detected magnitude (complex64, a
    zero imaginary part) of the projected phase ``delta_proj``; ``kappa``
    (the delta/beta ratio) and ``dist_nm`` may be tensors."""
    u, v = gen_freq_mesh(voxel_nm, delta_proj.shape[-2:], delta_proj.device)
    f = fft2(_as_complex(delta_proj))
    xi = PI * lmbda_nm * dist_nm * (u * u + v * v)
    osc = 2.0 * (torch.sin(xi) + torch.cos(xi) / kappa)
    img = torch.real(ifft2(osc * f)) + 1.0
    return _as_complex(torch.sqrt(torch.clamp(img, min=0.0)))


def modulate_and_get_ctf(delta, beta, energy_ev, psize_cm, free_prop_cm,
                         kappa=50.0):
    """Project the object in z and apply the pure-phase CTF at the
    distance ``free_prop_cm`` (a float or a tensor)."""
    lmbda_nm = wavelength_nm(energy_ev)
    voxel_nm = (psize_cm * 1e7,) * 3
    if not torch.is_tensor(free_prop_cm):
        free_prop_cm = torch.tensor(float(free_prop_cm), dtype=torch.float32,
                                    device=delta.device)
    d = torch.sum(delta, -1)
    return pure_phase_ctf(d, None, free_prop_cm * 1e7, lmbda_nm, voxel_nm,
                          kappa=kappa)
