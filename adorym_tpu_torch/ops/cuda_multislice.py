"""Multislice propagation through a delta/beta object: the CUDA kernel pairs
``csrc/multislice_db_stored.cu`` (K1, stored intermediates) and
``csrc/multislice_db.cu`` (K4, invertible steps), each with its plain
PyTorch version.

Counterpart of ``adorym_tpu/ops/pallas_multislice.py``'s
``multislice_db_stored_packed`` (``:1125``; Pallas kernels
``_fwd_db_st_kernel`` ``:353`` and ``_bwd_db_st_kernel`` ``:422``) and
``multislice_db_packed`` (``:941``; ``_fwd_db_kernel`` ``:294`` and
``_bwd_db_kernel`` ``:495``).  The object arrives packed and z-major,
``db[S, 2, N, ny, nx]`` (slot 0 delta, slot 1 beta, one binned slice per
step), in f32 or bf16; the incident wave is ``[M, N, ny, nx]`` complex64
(M probe modes).  Each step multiplies the wave by the slice transmission
``t = exp(-k1 b) exp(-i s k1 d)`` and propagates it with the folded
per-axis Fresnel matrices ``w <- Py w Px^T``; the last step applies the
optional far-field matrices instead.

K1 records the wave entering every step for its backward, M times the
size of db.  K4 records nothing: its backward rebuilds the waves by
inverting the steps, at two propagations per step instead of one.
``propagate.multislice_propagate`` picks K4 when K1's records would pass
one eighth of the device's memory.

Both pairs take each step by one of three routes, chosen from the shape
alone (:func:`k1_route`, :func:`k4_route`): ``'fft'`` when both sides split
as ``n1 * n2`` with ``2 <= n1 <= n2 <= 9`` (72 = 8 x 9) and the block fits,
where the kernels run the step unfolded, as two-stage FFTs in shared
memory with the step's vectors of :func:`fft_step_vectors`; ``'dense'``
otherwise, the folded matrices, while the block's planes and matrices fit
in shared memory; ``'global'`` for larger planes (K1 from 88^2, K4 from
80^2), the dense route's kernels with the block's planes in a workspace in
device memory and the matrices read where they lie.  :func:`fft_stages_plain`,
:func:`fft_stages_back_plain` and :func:`fft_step_plain` model the FFT
route's stages, roots and orders in PyTorch for the tests.

:func:`multislice_db_stored_packed` and :func:`multislice_db_packed` route
by device: CUDA tensors go through the kernels (an autograd Function whose
backward is the second kernel), CPU tensors through the plain versions,
:func:`multislice_db_stored_plain` (op by op, the gradient from autograd)
and :func:`multislice_db_plain` (op by op in both directions, the backward
rebuilding the waves as K4's does).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils.cuda_build import Kernel, library, ptr
from .fourier import dft_matrix, fft2, ifft2

#: Dynamic shared memory one block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448
#: Probe modes the backward kernels take: the portable thread-block
#: cluster size (one block per mode of a patch).
MAX_MODES = 8

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p
K1_FWD = Kernel('multislice_db_stored.cu', 'k1_fwd',
                [_I, _I] + [_P] * 8 + [_I] * 5 + [_F, _F, _P])
K1_BWD = Kernel('multislice_db_stored.cu', 'k1_bwd',
                [_I, _I] + [_P] * 9 + [_I] * 5 + [_F, _F, _F, _P])
K4_FWD = Kernel('multislice_db.cu', 'k4_fwd',
                [_I, _I] + [_P] * 7 + [_I] * 5 + [_F, _F, _P])
K4_BWD = Kernel('multislice_db.cu', 'k4_bwd',
                [_I, _I] + [_P] * 11 + [_I] * 5 + [_F, _F, _F, _P])
#: The step routes, as the C entry points of K1, K4 and K5 number them.
STEP_ROUTES = {'dense': 0, 'fft': 1, 'global': 2}
#: K1 launches (forward and backward) by route, counted beside
#: ``K1_FWD.launches`` and ``K1_BWD.launches``.
K1_ROUTE_LAUNCHES = {'dense': 0, 'fft': 0, 'global': 0}
#: K4 launches (forward and backward) by route, counted beside
#: ``K4_FWD.launches`` and ``K4_BWD.launches``.
K4_ROUTE_LAUNCHES = {'dense': 0, 'fft': 0, 'global': 0}
#: Resident blocks an SM of each K4 launch shape, ``'K4f|K4b.<route>.<dtype>
#: .M<modes>.<ny>x<nx>'`` -> blocks, from the card's occupancy calculator
#: (``k4_blocks_per_sm`` in ``csrc/multislice_db.cu``; at M > 1 the
#: backward's resident clusters times M over the SMs), asked once a shape on
#: the host at the shape's first launch, beside ``K4_ROUTE_LAUNCHES``.
K4_BLOCKS_PER_SM = {}
#: K4 keeps no records, so it has no forward-mode rule yet; the plain
#: FFT scan (``fused_multislice='off'``) has one, on the card too.
K4_NO_TANGENT = ('forward mode through the invertible multislice (K4), '
                 'which keeps no records: ROADMAP B.16, a tangent kernel; '
                 "TrainConfig(fused_multislice='off') runs the plain FFT "
                 'scan, which has forward mode')
#: The largest radix of the FFT route's two stages (``csrc`` kMaxRadix).
MAX_RADIX = 9


def _fold_prop_mats(kernel):
    """Per-axis folded propagation matrices ``P = G diag(h) F`` of a
    separable (paraxial) transfer kernel ``H[y, x] = hy[y] hx[x]`` with
    ``hy = H[:, 0] / H[0, 0]``, ``hx = H[0, :]``; complex64, ``P[out, in]``
    orientation (``pallas_multislice._fold_prop_mats``)."""
    h = kernel.to(torch.complex64)
    ny, nx = h.shape
    hy = h[:, 0] / h[0, 0]
    hx = h[0, :]
    dev = h.device

    def mats(n):
        return (torch.from_numpy(dft_matrix(n)).to(dev),
                torch.from_numpy(dft_matrix(n, inverse=True)).to(dev))

    fy, gy = mats(ny)
    fx, gx = mats(nx)
    return (gy * hy[None, :]) @ fy, (gx * hx[None, :]) @ fx


def fft_radix(n):
    """``n1`` of the split ``n = n1 * n2`` the FFT route takes: the largest
    ``n1`` with ``2 <= n1 <= n2 <= MAX_RADIX``, or 0 when there is none
    (``msdb::fft_radix``)."""
    for r in range(MAX_RADIX, 1, -1):
        if n % r == 0 and r * r <= n and n // r <= MAX_RADIX:
            return r
    return 0


def _step_route(ny, nx, planes, kernel):
    if (fft_radix(ny) and fft_radix(nx)
            and smem_bytes(ny, nx, planes, 'fft', kernel) <= MAX_SMEM_BYTES):
        return 'fft'
    if smem_bytes(ny, nx, planes, 'dense', kernel) <= MAX_SMEM_BYTES:
        return 'dense'
    return 'global'


def k1_route(ny, nx):
    """K1's route for ``ny x nx`` planes: ``'fft'`` when both sides take
    the radix split and its two-plane block fits in shared memory with the
    FFT route's padding and table, else ``'dense'`` when the dense route's
    two planes and folded mats fit, else ``'global'`` (88^2 and larger
    without the split)."""
    return _step_route(ny, nx, 2, 'K1')


def k4_route(ny, nx):
    """K4's route for ``ny x nx`` planes: as :func:`k1_route`, sized by
    K4's larger block, the backward's three planes (``'global'`` from 80^2
    without the split; K4f's FFT-route block is less than half of
    it)."""
    return _step_route(ny, nx, 3, 'K4')


def fft_step_vectors(kernel):
    """The FFT route's step vectors ``(hy / ny, hx / nx)``, complex64 on
    ``kernel``'s device: the separable transfer function's factors
    (``hy = H[:, 0] / H[0, 0]``, ``hx = H[0, :]``, as :func:`_fold_prop_mats`
    takes them) with the ``1/n`` of each axis's ``G = conj(F) / n``."""
    h = kernel.to(torch.complex64)
    ny, nx = h.shape
    hy = h[:, 0] / h[0, 0]
    return (hy / ny).contiguous(), (h[0, :] / nx).contiguous()


def _unit_roots(n, device=None):
    """``exp(-2 pi i k / n)`` for ``k < n``, from an angle reduced to at
    most half a turn, as ``msdb::unit_root`` takes it (there in f32)."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    kk = torch.where(2 * k <= n, k, k - n)
    return torch.polar(torch.ones_like(kk), -2 * math.pi * kk / n).to(
        torch.complex64)


def _radix_dfts(n1, n2, roots):
    """The ``n1``- and ``n2``-point DFT matrices ``[k, j]`` from the
    ``n``-th roots, and the stage roots ``w^(k1 j2)`` ``[n1, n2]``."""
    j1 = torch.arange(n1, device=roots.device)
    j2 = torch.arange(n2, device=roots.device)
    return (roots[(j1[:, None] * j1[None, :]) % n1 * n2],
            roots[(j2[:, None] * j2[None, :]) % n2 * n1],
            roots[j1[:, None] * j2[None, :]])


def fft_stages_plain(x, n1, n2, inverse=False):
    """The FFT route's transform of length ``n = n1 * n2`` over the last
    axis of complex64 ``x``, in the kernel's two stages (unnormalised;
    ``inverse`` flips the roots' sign).  With ``j = n2 j1 + j2`` and ``k =
    k1 + n1 k2``: the ``n1``-point DFT over ``j1`` of each ``j2``'s
    elements, times the root ``w^(j2 k1)``, leaving ``Y[k1, j2]`` at ``n2
    k1 + j2`` (pass A); the ``n2``-point DFT over ``j2`` of each ``k1``'s
    neighbours, ``X[k1 + n1 k2]`` in natural order (pass B's first
    half)."""
    roots = _unit_roots(n1 * n2, x.device)
    d1, d2, tw = _radix_dfts(n1, n2, roots.conj() if inverse else roots)
    y = (d1 @ x.reshape(*x.shape[:-1], n1, n2)) * tw     # [k1, j2]
    return (y @ d2.transpose(0, 1)).transpose(-1, -2).reshape(x.shape)


def fft_stages_back_plain(x, n1, n2, inverse=False):
    """The FFT route's transform back, from natural order to natural order:
    the transpose of :func:`fft_stages_plain`'s stages.  The ``n2``-point
    DFT over ``k2`` of each ``k1``'s elements ``x[k1 + n1 k2]``, times the
    root ``w^(j2 k1)`` (pass B's second half, leaving ``Z[k1, j2]`` at ``n2
    k1 + j2``); the ``n1``-point DFT over ``k1`` of each ``j2``'s elements,
    stored at ``n2 j1 + j2`` (pass C)."""
    roots = _unit_roots(n1 * n2, x.device)
    d1, d2, tw = _radix_dfts(n1, n2, roots.conj() if inverse else roots)
    z = x.reshape(*x.shape[:-1], n2, n1).transpose(-1, -2)  # [k1, k2]
    z = (z @ d2.transpose(0, 1)) * tw                        # [k1, j2]
    return (d1 @ z).reshape(x.shape)                          # [j1, j2]


def fft_step_plain(w, vy, vx, step='P'):
    """The FFT route's step on planes ``[..., ny, nx]``: per axis (y, then
    x) the transform (:func:`fft_stages_plain`), the product with the
    axis's step vector (:func:`fft_step_vectors`) and the transform back
    (:func:`fft_stages_back_plain`), each axis ``w <- V_y w V_x^T``.
    ``step``: ``'P'`` (forward: FFT, h, inverse FFT), ``'PT'`` (``P^T``:
    inverse FFT, h, FFT) or ``'Pinv'`` (``P^-1``: FFT, conj(h), inverse
    FFT)."""
    first_inverse = step == 'PT'
    for dim, v in ((-2, vy), (-1, vx)):
        n = w.shape[dim]
        r = fft_radix(n)
        x = fft_stages_plain(w.movedim(dim, -1), r, n // r, first_inverse)
        x = x * (v.conj() if step == 'Pinv' else v)
        w = fft_stages_back_plain(x, r, n // r,
                                  not first_inverse).movedim(-1, dim)
    return w


def _modulator(db_z, k1, s):
    """Slice transmission of one packed step ``[2, ...]``, in f32 whatever
    the storage dtype."""
    d = db_z[0].float()
    b = db_z[1].float()
    amp = torch.exp(-k1 * b)
    ph = -s * k1 * d
    return torch.complex(amp * torch.cos(ph), amp * torch.sin(ph))


def _modulator_and_inverse(db_z, k1, s):
    """``t`` and ``1/t = exp(+k1 b) exp(+i s k1 d)``, each from its own
    exponential (no division), in f32 (``_bwd_db_kernel``'s arithmetic)."""
    d = db_z[0].float()
    b = db_z[1].float()
    ph = -s * k1 * d
    cs, sn = torch.cos(ph), torch.sin(ph)
    amp = torch.exp(-k1 * b)
    inv_amp = torch.exp(k1 * b)
    return (torch.complex(amp * cs, amp * sn),
            torch.complex(inv_amp * cs, -inv_amp * sn))


def _apply_prop(w, my, mx):
    """``w <- my w mx^T`` over the last two axes: the x pass, then the y
    pass (``pallas_multislice._apply_prop``)."""
    return my @ (w @ mx.transpose(0, 1))


def multislice_db_stored_plain(db, wave, kernel, k1, s, fay=None, fax=None,
                               records=False):
    """Plain PyTorch version of K1: the same steps op by op,
    differentiable by autograd.  ``fay``/``fax``: optional far-field mats
    applied at the last step as ``fay w fax^T``.  ``records``: also return
    the wave entering each step, ``[S, M, N, ny, nx]`` complex64, what
    K1's forward kernel records."""
    py, px = _fold_prop_mats(kernel)
    w = wave
    n_steps = db.shape[0]
    rec = []
    for z in range(n_steps):
        rec.append(w)
        w = w * _modulator(db[z], k1, s)
        if z < n_steps - 1:
            w = _apply_prop(w, py, px)
        elif fay is not None:
            w = _apply_prop(w, fay, fax)
    return (w, torch.stack(rec)) if records else w


#: Calls of :func:`multislice_tangent` from the forward-mode rules of the
#: kernel Functions, by kernel (K1, K5), counted beside
#: ``K1_ROUTE_LAUNCHES``.
TANGENT_LAUNCHES = {'K1': 0, 'K5': 0}


def multislice_tangent(t, dt, rec, dwave, kernel, far=None):
    """The forward-mode derivative of the multislice sweep ``w_{k+1} =
    P(w_k t_k)``, ``out = F(w_{S-1} t_{S-1})``, from the waves ``rec[S,
    M, N, ny, nx]`` entering each step (the forward kernels' records):
    ``w'_{k+1} = P(w'_k t_k + w_k t'_k)``, and ``F`` at the last step.
    ``t[S, N, ny, nx]`` the transmissions, ``dt`` their tangent and
    ``dwave[M, N, ny, nx]`` the incident wave's (one of the two may be
    None: no tangent); ``P(w) = ifft2(fft2(w) * kernel)``; ``far``:
    ``(ay, bx)``,
    ``F(u) = ay u bx``, or None.  Plain torch ops: the forward-mode rule
    of K1 and K5, and testable on the CPU from the plain versions'
    records.  Returns the tangent of ``out``, ``[M, N, ny, nx]``
    complex64."""
    dw = dwave
    n_steps = t.shape[0]
    for z in range(n_steps):
        u = None if dw is None else dw * t[z]
        if dt is not None:
            u = rec[z] * dt[z] if u is None else u + rec[z] * dt[z]
        if z < n_steps - 1:
            dw = ifft2(fft2(u) * kernel)
        elif far is not None:
            dw = far[0] @ u @ far[1]
        else:
            dw = u
    return dw


def modulator_tangent(db, ddb, k1, s):
    """The transmissions ``t[S, N, ny, nx]`` of the packed stack ``db[S,
    2, N, ny, nx]`` and their tangent along ``ddb``: ``t' = t (-k1 b' - i
    s k1 d')``."""
    t = _modulator(db.transpose(0, 1), k1, s)
    ddb = ddb.float()
    return t, t * torch.complex(-k1 * ddb[:, 1], -s * k1 * ddb[:, 0])


class MultisliceDbPlain(torch.autograd.Function):
    """Plain PyTorch version of K4, the arithmetic twin of its kernels: the
    forward stores nothing step-sized, and the backward rebuilds each
    step's wave from the output (``_bwd_db_kernel``): ``a <- P^T a``,
    ``m = P^-1 w``, ``w = m (1/t)``, with the exact inverse far-field mats
    at the first step.  JAX's unconjugated cotangent inside, converted from
    and to PyTorch's convention at the ends.  Takes tensors on any
    device."""

    @staticmethod
    def forward(ctx, db, wave, kernel, k1, s, fay, fax, fayi, faxi):
        out = multislice_db_stored_plain(db, wave, kernel, k1, s, fay, fax)
        ctx.save_for_backward(db, out)
        ctx.mats = (kernel, fay, fax, fayi, faxi)
        ctx.k1, ctx.s = k1, s
        return out

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(K4_NO_TANGENT)

    @staticmethod
    def backward(ctx, grad_out):
        db, out = ctx.saved_tensors
        kernel, fay, fax, fayi, faxi = ctx.mats
        k1, s = ctx.k1, ctx.s
        py, px = _fold_prop_mats(kernel)
        ty, tx = py.transpose(0, 1), px.transpose(0, 1)
        iy, ix = py.conj().transpose(0, 1), px.conj().transpose(0, 1)
        a = torch.conj_physical(grad_out)
        v = out
        if fay is not None:
            a = _apply_prop(a, fay.transpose(0, 1), fax.transpose(0, 1))
            v = _apply_prop(v, fayi, faxi)
        n_steps = db.shape[0]
        gdb = torch.empty_like(db)
        for z in range(n_steps - 1, -1, -1):
            if z < n_steps - 1:
                a = _apply_prop(a, ty, tx)
                v = _apply_prop(v, iy, ix)
            t, t_inv = _modulator_and_inverse(db[z], k1, s)
            w = v * t_inv
            gt = (a * w).sum(0)
            cu = gt * t
            gdb[z, 1] = (-k1 * cu.real).to(db.dtype)
            gdb[z, 0] = (s * k1 * cu.imag).to(db.dtype)
            a = a * t
            v = w
        return (gdb, torch.conj_physical(a), None, None, None, None, None,
                None, None)


def multislice_db_plain(db, wave, kernel, k1, s, fay=None, fax=None,
                        fayi=None, faxi=None):
    """Plain PyTorch version of K4 (:class:`MultisliceDbPlain`).  With the
    far-field mats ``fay``/``fax``, their exact inverses ``fayi``/``faxi``
    (``propagate.final_prop_mats``'s last two) are required."""
    _check_far_field(fay, fax, fayi, faxi)
    return MultisliceDbPlain.apply(db, wave, kernel, k1, s, fay, fax, fayi,
                                   faxi)


def _check_far_field(fay, fax, fayi, faxi):
    given = [m is not None for m in (fay, fax, fayi, faxi)]
    if any(given) and not all(given):
        raise ValueError('the invertible multislice takes the far-field mats '
                         'with their exact inverses: fay, fax, fayi, faxi')


def fft_slot_elems(planes, ny, nx):
    """Complex elements of an FFT-route block's slot region: the two mat
    slots, which hold the far field once a launch and during the steps the
    step's f32 db planes (``ny * nx`` elements; in K1b also its f32 record
    plane, as many more), and in K4b (``planes`` = 3) first the rebuilt
    wave's scratch plane (``msdb::fft_slot_elems``)."""
    steps = (ny * (nx | 1) if planes == 3 else 0) + ny * nx
    return max(ny * ny + nx * nx, steps)


def smem_bytes(ny, nx, planes=2, route='dense', kernel='K1'):
    """Dynamic shared memory of one block of ``kernel`` (``'K1'`` or
    ``'K4'``): ``planes`` complex planes (2 in K1 and K4f, the wave and a
    scratch plane; 3 in K4b, which adds the rebuilt wave) and the two
    per-axis matrices.  The FFT route pads the planes' rows to an odd
    length, takes the slot region of :func:`fft_slot_elems`, and adds the
    step vectors and both axes' roots of unity (``msdb::fft_smem_bytes``);
    there K4f (``'K4'``, 2 planes) keeps no slot region: it reads the
    step's db planes through L2, so its block is the two padded planes and
    the table (``fwd_fft_smem_bytes`` in ``csrc/multislice_db.cu``), and
    two fit an SM.  The global route takes none: its planes lie in
    :func:`workspace`."""
    if kernel not in ('K1', 'K4'):
        raise ValueError(f"kernel must be 'K1' or 'K4', got {kernel!r}")
    if route == 'global':
        return 0
    if route == 'fft':
        if kernel == 'K4' and planes == 2:
            return 8 * (2 * ny * (nx | 1) + 2 * (ny + nx))
        return 8 * (planes * ny * (nx | 1) + fft_slot_elems(planes, ny, nx)
                    + 2 * (ny + nx))
    return 8 * (planes * ny * nx + ny * ny + nx * nx)


def workspace(route, planes, m, n, ny, nx, device):
    """The global route's device-memory planes, ``planes`` complex64
    ``ny x nx`` planes for each of the ``m * n`` blocks (None on the other
    routes, whose planes lie in shared memory)."""
    if route != 'global':
        return None
    return torch.empty((m * n * planes, ny, nx), dtype=torch.complex64,
                       device=device)


def k4_blocks_per_sm(backward, dtype, route, m, ny, nx):
    """Resident blocks an SM of K4f (``backward`` False) or K4b launched
    on ``route`` with ``m`` modes of ``ny x nx`` planes in ``dtype``, from
    the card's occupancy calculator, asked once a shape (no launch, no
    synchronisation) and kept in :data:`K4_BLOCKS_PER_SM`."""
    key = (f"{'K4b' if backward else 'K4f'}.{route}."
           f"{str(dtype).rsplit('.', 1)[-1]}.M{m}.{ny}x{nx}")
    got = K4_BLOCKS_PER_SM.get(key)
    if got is None:
        out = ctypes.c_float()
        err = _k4_occupancy()(int(backward), _dtype_code(dtype),
                              STEP_ROUTES[route], m, ny, nx,
                              ctypes.byref(out))
        if err:
            raise RuntimeError(f'k4_blocks_per_sm failed: CUDA error {err}')
        got = K4_BLOCKS_PER_SM[key] = out.value
    return got


def _k4_occupancy():
    fn = library('multislice_db.cu').k4_blocks_per_sm
    fn.argtypes = [_I] * 6 + [ctypes.POINTER(_F)]
    fn.restype = _I
    return fn


def _dtype_code(dtype):
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f'db must be float32 or bfloat16, got {dtype}')


class MultisliceDbStored(torch.autograd.Function):
    """K1 as one autograd Function.  ``mats`` holds the step and far-field
    matrices in the orientations the kernels take, as :func:`prop_mats`
    builds them for ``mats['route']``: forward ``Py, Px^T`` (far field
    ``Fy, Fx^T``), backward the transposes ``Py^T, Px`` (``Fy^T, Fx``); on
    the FFT route the step slots hold the step's vectors.  Takes
    contiguous CUDA operands (see :func:`multislice_db_stored_packed`)."""

    @staticmethod
    def forward(ctx, db, wave, mats, k1, s):
        n_steps, _, n, ny, nx = db.shape
        m = wave.shape[0]
        out = torch.empty((m, n, ny, nx), dtype=torch.complex64,
                          device=db.device)
        rec = torch.empty((n_steps, m, n, ny, nx, 2), dtype=db.dtype,
                          device=db.device)
        route = mats['route']
        K1_FWD(_dtype_code(db.dtype), STEP_ROUTES[route], ptr(db),
               ptr(wave), ptr(mats['fwd_y']), ptr(mats['fwd_x']),
               ptr(mats.get('ffwd_y')), ptr(mats.get('ffwd_x')),
               ptr(out), ptr(rec), n_steps, m, n, ny, nx,
               -k1, -s * k1, ptr(workspace(route, 2, m, n, ny, nx,
                                           db.device)))
        K1_ROUTE_LAUNCHES[route] += 1
        ctx.save_for_backward(db, rec)
        ctx.save_for_forward(db, rec)
        ctx.mats = mats
        ctx.k1, ctx.s = k1, s
        return out

    @staticmethod
    def jvp(ctx, ddb, dwave, *_):
        """Forward mode from the records (:func:`multislice_tangent`)."""
        db, rec = ctx.saved_tensors
        mats = ctx.mats
        t, dt = modulator_tangent(db, ddb, ctx.k1, ctx.s)
        far = ((mats['ffwd_y'], mats['ffwd_x']) if 'ffwd_y' in mats
               else None)
        TANGENT_LAUNCHES['K1'] += 1
        return multislice_tangent(t, dt, torch.view_as_complex(rec.float()),
                                  dwave, mats['kernel'], far)

    @staticmethod
    def backward(ctx, grad_out):
        db, rec = ctx.saved_tensors
        mats = ctx.mats
        n_steps, _, n, ny, nx = db.shape
        m = rec.shape[1]
        g = grad_out.resolve_conj().contiguous()
        gdb = torch.empty_like(db)
        gw = torch.empty((m, n, ny, nx), dtype=torch.complex64,
                         device=db.device)
        k1, s = ctx.k1, ctx.s
        route = mats['route']
        K1_BWD(_dtype_code(db.dtype), STEP_ROUTES[route], ptr(db), ptr(rec),
               ptr(g), ptr(mats['bwd_y']), ptr(mats['bwd_x']),
               ptr(mats.get('fbwd_y')), ptr(mats.get('fbwd_x')),
               ptr(gdb), ptr(gw), n_steps, m, n, ny, nx,
               -k1, -s * k1, s * k1,
               ptr(workspace(route, 2, m, n, ny, nx, db.device)))
        K1_ROUTE_LAUNCHES[route] += 1
        return gdb, gw, None, None, None


class MultisliceDb(torch.autograd.Function):
    """K4 as one autograd Function: the forward kernel stores nothing
    step-sized; the backward kernel rebuilds the waves from the output.
    ``mats`` as :func:`prop_mats` builds them for ``mats['route']``: as for
    :class:`MultisliceDbStored` (on the FFT route the step slots hold the
    step's vectors), plus the far field's exact inverse ``Fy^-1,
    (Fx^-1)^T`` when there is one.  Takes contiguous CUDA operands (see
    :func:`multislice_db_packed`)."""

    @staticmethod
    def forward(ctx, db, wave, mats, k1, s):
        n_steps, _, n, ny, nx = db.shape
        m = wave.shape[0]
        out = torch.empty((m, n, ny, nx), dtype=torch.complex64,
                          device=db.device)
        route = mats['route']
        K4_FWD(_dtype_code(db.dtype), STEP_ROUTES[route], ptr(db),
               ptr(wave), ptr(mats['fwd_y']), ptr(mats['fwd_x']),
               ptr(mats.get('ffwd_y')), ptr(mats.get('ffwd_x')),
               ptr(out), n_steps, m, n, ny, nx, -k1, -s * k1,
               ptr(workspace(route, 2, m, n, ny, nx, db.device)))
        K4_ROUTE_LAUNCHES[route] += 1
        k4_blocks_per_sm(False, db.dtype, route, m, ny, nx)
        ctx.save_for_backward(db, out)
        ctx.mats = mats
        ctx.k1, ctx.s = k1, s
        return out

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(K4_NO_TANGENT)

    @staticmethod
    def backward(ctx, grad_out):
        db, out = ctx.saved_tensors
        mats = ctx.mats
        n_steps, _, n, ny, nx = db.shape
        m = out.shape[0]
        g = grad_out.resolve_conj().contiguous()
        gdb = torch.empty_like(db)
        gw = torch.empty((m, n, ny, nx), dtype=torch.complex64,
                         device=db.device)
        k1, s = ctx.k1, ctx.s
        route = mats['route']
        K4_BWD(_dtype_code(db.dtype), STEP_ROUTES[route], ptr(db), ptr(out),
               ptr(g),
               ptr(mats['bwd_y']), ptr(mats['bwd_x']),
               ptr(mats.get('fbwd_y')), ptr(mats.get('fbwd_x')),
               ptr(mats.get('finv_y')), ptr(mats.get('finv_x')),
               ptr(gdb), ptr(gw), n_steps, m, n, ny, nx,
               -k1, -s * k1, s * k1,
               ptr(workspace(route, 3, m, n, ny, nx, db.device)))
        K4_ROUTE_LAUNCHES[route] += 1
        k4_blocks_per_sm(True, db.dtype, route, m, ny, nx)
        return gdb, gw, None, None, None


def _check_cuda_operands(db, wave, kernel, planes, route='dense',
                         pair='K1'):
    if db.dim() != 5 or db.shape[1] != 2:
        raise ValueError(f'db must be [S, 2, N, ny, nx], got {tuple(db.shape)}')
    _dtype_code(db.dtype)
    n_steps, _, n, ny, nx = db.shape
    if wave.dim() != 4 or tuple(wave.shape[1:]) != (n, ny, nx):
        raise ValueError(f'wave must be [M, {n}, {ny}, {nx}], '
                         f'got {tuple(wave.shape)}')
    if wave.dtype != torch.complex64:
        raise TypeError(f'wave must be complex64, got {wave.dtype}')
    if tuple(kernel.shape) != (ny, nx):
        raise ValueError(f'kernel must be [{ny}, {nx}]')
    if not (wave.is_cuda and kernel.is_cuda):
        raise ValueError('db, wave and kernel must share a CUDA device')
    if wave.shape[0] > MAX_MODES:
        raise ValueError(f'multislice kernels take at most {MAX_MODES} probe '
                         f'modes (one cluster block each), got '
                         f'{wave.shape[0]}')
    need = smem_bytes(ny, nx, planes, route, pair)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f'multislice kernel needs {need} bytes of shared memory at '
            f'{ny}x{nx}; the limit is {MAX_SMEM_BYTES}')


def prop_mats(kernel, fay=None, fax=None, fayi=None, faxi=None,
              route='dense'):
    """The matrices :class:`MultisliceDbStored` and :class:`MultisliceDb`
    take: the folded step mats of ``kernel`` and the optional far-field
    mats (with K4 their exact inverses too), each in the orientation of the
    kernel that reads it, on ``kernel``'s device.  On the ``'fft'`` route
    the step slots hold the step's vectors (:func:`fft_step_vectors`),
    which serve both directions; the ``'global'`` route takes the dense
    route's matrices."""
    if route == 'fft':
        vy, vx = fft_step_vectors(kernel)
        mats = {'fwd_y': vy, 'fwd_x': vx, 'bwd_y': vy, 'bwd_x': vx}
    else:
        py, px = _fold_prop_mats(kernel)
        mats = {'fwd_y': py.contiguous(),
                'fwd_x': px.transpose(0, 1).contiguous(),
                'bwd_y': py.transpose(0, 1).contiguous(),
                'bwd_x': px.contiguous()}
    mats['route'] = route
    mats['kernel'] = kernel

    def dev(m):
        return m.to(device=kernel.device, dtype=torch.complex64)

    if fay is not None:
        fay, fax = dev(fay), dev(fax)
        mats.update(ffwd_y=fay.contiguous(),
                    ffwd_x=fax.transpose(0, 1).contiguous(),
                    fbwd_y=fay.transpose(0, 1).contiguous(),
                    fbwd_x=fax.contiguous())
    if fayi is not None:
        mats.update(finv_y=dev(fayi).contiguous(),
                    finv_x=dev(faxi).transpose(0, 1).contiguous())
    return mats


def multislice_db_stored_packed(db, wave, kernel, k1, s, fay=None, fax=None):
    """Exit (or, with ``fay``/``fax``, detector) wave ``[M, N, ny, nx]``
    complex64 of the packed multislice with stored intermediates (K1);
    differentiable in ``db`` and ``wave``.  CUDA tensors run the kernels,
    on the route :func:`k1_route` picks for the shape; CPU tensors the
    plain version.  ``kernel``: the per-step Fresnel transfer function
    ``[ny, nx]`` (separable); ``k1``, ``s``: wavenumber scale and sign
    convention."""
    if not db.is_cuda:
        return multislice_db_stored_plain(db, wave, kernel, k1, s, fay, fax)
    route = k1_route(*db.shape[-2:])
    _check_cuda_operands(db, wave, kernel, 2, route)
    return MultisliceDbStored.apply(db.contiguous(), wave.contiguous(),
                                    prop_mats(kernel, fay, fax, route=route),
                                    float(k1), float(s))


def multislice_db_packed(db, wave, kernel, k1, s, fay=None, fax=None,
                         fayi=None, faxi=None):
    """The same function as :func:`multislice_db_stored_packed` through
    the invertible kernel pair (K4), which stores nothing step-sized; with
    a far field, ``fayi``/``faxi`` are its exact inverses.  CUDA tensors
    run the kernels, on the route :func:`k4_route` picks for the shape;
    CPU tensors the plain version."""
    if not db.is_cuda:
        return multislice_db_plain(db, wave, kernel, k1, s, fay, fax, fayi,
                                   faxi)
    _check_far_field(fay, fax, fayi, faxi)
    route = k4_route(*db.shape[-2:])
    _check_cuda_operands(db, wave, kernel, 3, route, 'K4')
    return MultisliceDb.apply(db.contiguous(), wave.contiguous(),
                              prop_mats(kernel, fay, fax, fayi, faxi, route),
                              float(k1), float(s))


def fft2_flops(ny, nx):
    """Real floating-point operations of one complex 2-D FFT, by the usual
    ``5 n log2 n`` count."""
    return 5.0 * ny * nx * math.log2(ny * nx)


def flops(n_steps, n_modes, n, ny, nx, final=True, backward=False,
          invertible=False):
    """Least real floating-point operations of one sweep, whatever form the
    kernel computes it in: the transforms counted as FFTs.  Per
    propagation a forward and an inverse 2-D FFT and the product with H
    (``n_steps - 1`` of them), one FFT for the far field, and per step one
    complex product for the modulation (two in the backward, which also
    forms the slice's gradient).  The invertible backward (K4b) propagates
    the cotangent and the rebuilt wave, so it has twice the propagations
    and far-field transforms, and three products per step (the rebuilt
    wave, the slice's gradient, the cotangent).  The transmission's
    exponentials are not counted."""
    plane = ny * nx
    rebuild = backward and invertible
    sweeps = 2 if rebuild else 1
    ops = sweeps * (n_steps - 1) * (2 * fft2_flops(ny, nx) + 6 * plane)
    ops += sweeps * fft2_flops(ny, nx) if final else 0.0
    products = 3 if rebuild else (2 if backward else 1)
    ops += n_steps * 6 * plane * products
    return float(n_modes * n * ops)


def bytes_moved(n_steps, n_modes, n, ny, nx, itemsize, backward=False,
                records=True):
    """Least device-memory bytes of one sweep: every input read once and
    every output written once (db, records and waves).  ``records=False``
    counts K4, which has none: its backward reads the output wave
    instead."""
    plane = n * ny * nx
    db = n_steps * 2 * plane * itemsize
    rec = n_steps * n_modes * plane * 2 * itemsize if records else 0
    wave = n_modes * plane * 8
    if backward:          # db, records or out, g in; gdb, gw out
        return float(db + (rec if records else wave) + wave + db + wave)
    return float(db + wave + wave + rec)   # db, w0 in; out (records) out
