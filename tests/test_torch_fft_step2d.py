"""The FFT step route of K5 on the CPU: the plain model of its 2-D step
(``fft_step2d_plain``, on the FFT route's stages, with the step table of
``step_table``) against ``torch.fft`` for ``P`` and ``P^T`` with paraxial
and non-paraxial transfer functions; the table's row order against the
stage order of the y axis's forward half; K5's sweep on the route, built
from the model, against the JAX package's ``multislice_fused`` (Pallas,
interpret mode) and its VJP; the sweep and the dense route's DFT-matmul
form against a complex128 sweep at the real_imag chunk's depth; K5's routes
and shared memory.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
these tests fix the stages, orders and table the CUDA routine
(``csrc/multislice_common.cuh``, ``fft_propagate2d``) follows.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adorym_tpu.ops import pallas_multislice as pm
from adorym_tpu.ops import propagate as jprop
from adorym_tpu_torch.ops import cuda_multislice as cm
from adorym_tpu_torch.ops import cuda_multislice_fused as cmf
from adorym_tpu_torch.ops import propagate as tprop
from adorym_tpu_torch.ops.fourier import dft_matrix

#: Paraxial: the separable Fresnel kernel.  Non-paraxial at a wavelength
#: long enough that the square root bends the phase and the evanescent
#: corners of the spectrum are masked: H is not separable.
TRANSFER = {'paraxial': dict(lmbda=0.1, dist=20.0, approx=True),
            'non_paraxial': dict(lmbda=1.6, dist=3.0, approx=False)}


def _kernel(mod, shape, which):
    kw = TRANSFER[which]
    return mod.fresnel_kernel(shape, (1.0, 1.0, 1.0), kw['lmbda'],
                              kw['dist'], fresnel_approx=kw['approx'])


def _rel(a, b):
    """Max error relative to the largest reference magnitude."""
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _complex(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


# f32 roundoff of four two-stage transforms of at most 9-point sums: 1e-6
# of the largest value holds with 3x margin (measured 1.6e-7 to 3.1e-7).
@pytest.mark.parametrize('step', ['P', 'PT'])
@pytest.mark.parametrize('which', sorted(TRANSFER))
@pytest.mark.parametrize('shape', [(8, 8), (12, 20), (72, 72)])
def test_fft_step2d_matches_torch_fft(shape, which, step):
    """``P = IFFT2(FFT2(w) H)`` and ``P^T = FFT2(IFFT2(w) H)`` (JAX's
    transpose, H itself) from the stage model and the step table."""
    h = _kernel(tprop, shape, which)
    w = torch.from_numpy(_complex(np.random.default_rng(1), 3, *shape))
    got = cmf.fft_step2d_plain(w, cmf.step_table(h), step)
    if step == 'P':
        want = torch.fft.ifft2(torch.fft.fft2(w) * h)
    else:
        want = torch.fft.fft2(torch.fft.ifft2(w) * h)
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize('n', [72, 20, 12, 8])
def test_step_table_rows_follow_the_stage_order(n):
    """Pass B's forward half leaves the y frequency ``k1 + n1 k2`` at row
    ``n2 k1 + k2``: the two stages written out (``_radix_dfts``) against
    the FFT taken in natural order and gathered by ``_stage_order``; the
    table's row ``l`` is ``H[k(l)]``."""
    n1 = cm.fft_radix(n)
    n2 = n // n1
    x = torch.from_numpy(_complex(np.random.default_rng(n), 2, n))
    d1, d2, tw = cm._radix_dfts(n1, n2, cm._unit_roots(n))
    staged = ((d1 @ x.reshape(2, n1, n2)) * tw) @ d2.transpose(0, 1)
    order = cmf._stage_order(n)
    assert _rel(staged.reshape(2, n), torch.fft.fft(x)[:, order]) < 1e-6
    h = _kernel(tprop, (n, 16), 'non_paraxial')
    table = cmf.step_table(h)
    assert torch.equal(table, h[order].contiguous())


def test_step_table_is_built_once_per_kernel():
    """The same transfer-function tensor gives the same table object; an
    in-place change to it, or another tensor, builds a new one."""
    h = _kernel(tprop, (12, 20), 'paraxial')
    first = cmf.step_table(h)
    assert cmf.step_table(h) is first
    other = h.clone()
    assert cmf.step_table(other) is not first
    h.mul_(1.0)
    assert cmf.step_table(h) is not first


def test_propagator_keeps_one_kernel_per_geometry():
    """``multislice_propagate`` takes the step's transfer function from a
    cache keyed by the geometry, so the step table is built once."""
    args = ((16, 16), (1.0, 1.0, 1.0), 0.248, 8.0, False, 1,
            torch.device('cpu'))
    assert tprop._step_kernel(*args) is tprop._step_kernel(*args)


def _k5_fft_sweep(t, wave, table, g):
    """K5's FFT route op by op, autograd off: the forward records the wave
    entering each step and propagates with the model's ``P``; the backward
    carries JAX's unconjugated cotangent ``a = conj(g)`` (``g`` in
    PyTorch's convention) through the model's ``P^T``, sums ``a * rec``
    over the modes for each step's ``gt``, and returns PyTorch's
    conjugates of ``gt`` and of the wave's gradient."""
    n_steps = t.shape[0]
    w, recs = wave, []
    for z in range(n_steps):
        recs.append(w)
        w = w * t[z]
        if z < n_steps - 1:
            w = cmf.fft_step2d_plain(w, table, 'P')
    a = torch.conj_physical(g)
    gt = torch.empty_like(t)
    for z in range(n_steps - 1, -1, -1):
        if z < n_steps - 1:
            a = cmf.fft_step2d_plain(a, table, 'PT')
        gt[z] = (a * recs[z]).sum(0)
        a = a * t[z]
    return w, torch.conj_physical(gt), torch.conj_physical(a)


# f32 both sides, a few steps of 8..20-point transforms: 1e-5 of the
# largest value.
@pytest.mark.parametrize('which', sorted(TRANSFER))
@pytest.mark.parametrize('M', [1, 2])
@pytest.mark.parametrize('S,ny,nx', [(4, 16, 16), (3, 12, 20)])
def test_k5_fft_sweep_matches_pallas(S, ny, nx, M, which):
    """The sweep K5's kernels run on the FFT route, against the JAX
    package's Pallas pair (interpret mode) and its VJP: the exit wave and
    the gradients on t and on the wave, each as a real pair."""
    rng = np.random.default_rng(ny + M)
    tpair = (rng.normal(size=(S, 3, ny, nx, 2)) * 0.1).astype(np.float32)
    tpair[..., 0] += 1.0
    wpair = (rng.normal(size=(M, 3, ny, nx, 2)) * 0.5).astype(np.float32)
    cot = rng.normal(size=(M, 3, ny, nx, 2)).astype(np.float32)
    h_j = _kernel(jprop, (ny, nx), which)

    def f(tp, wp):
        t = (tp[..., 0] + 1j * tp[..., 1]).astype(jnp.complex64)
        wave = (wp[..., 0] + 1j * wp[..., 1]).astype(jnp.complex64)
        out = pm.multislice_fused(t, wave, h_j, True)
        return jnp.sum(jnp.real(out) * cot[..., 0]
                       + jnp.imag(out) * cot[..., 1]), out

    (_, o_j), (gt_j, gw_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(tpair),
                                         jnp.asarray(wpair))
    table = cmf.step_table(_kernel(tprop, (ny, nx), which))
    out, gt, gw = _k5_fft_sweep(
        torch.view_as_complex(torch.from_numpy(tpair)),
        torch.view_as_complex(torch.from_numpy(wpair)), table,
        torch.view_as_complex(torch.from_numpy(cot)))
    assert _rel(out.numpy(), np.asarray(o_j)) < 1e-5
    assert _rel(torch.view_as_real(gt).numpy(), np.asarray(gt_j)) < 1e-5
    assert _rel(torch.view_as_real(gw).numpy(), np.asarray(gw_j)) < 1e-5


# -- The sweep against a complex128 truth -----------------------------------

def _dense_step(w, fy, fx, h, transpose):
    """The dense route's step in f32, as its four matmul passes take it:
    ``G_y (H o (F_y w F_x)) G_x`` with ``G = conj(F) / n`` applied from F
    (``P^T``: ``F_y (H o (G_y w G_x)) F_x``)."""
    ny, nx = h.shape
    if transpose:
        x = (fy.conj() @ (w @ fx.conj() / nx) / ny) * h
        return fy @ (x @ fx)
    x = (fy @ (w @ fx)) * h
    return fy.conj() @ (x @ fx.conj() / nx) / ny


def _sweep(step, t, wave, g):
    """Forward and the JAX-convention backward of the sweep through ``t``
    with ``step(w, transpose)``, returning the exit wave and PyTorch's
    gradients on t and the wave."""
    n_steps = t.shape[0]
    w, recs = wave, []
    for z in range(n_steps):
        recs.append(w)
        w = w * t[z]
        if z < n_steps - 1:
            w = step(w, False)
    a = torch.conj_physical(g)
    gt = torch.empty_like(t)
    for z in range(n_steps - 1, -1, -1):
        if z < n_steps - 1:
            a = step(a, True)
        gt[z] = (a * recs[z]).sum(0)
        a = a * t[z]
    return w, torch.conj_physical(gt), torch.conj_physical(a)


def test_k5_fft_route_against_float64_truth():
    """At the real_imag chunk's depth, 32 steps (31 propagations) of 8 nm
    with the non-paraxial transfer function at 5 keV, 72^2: the f32 stage
    model of the FFT route and the f32 DFT-matmul form of the dense route,
    each against the same sweep in complex128 (the f32 H and t upcast),
    forward and both gradients.  Measured on the CPU: the FFT model 1.7e-6,
    1.5e-6 and 1.4e-6 of the largest values (forward, gt, gw; with the
    1/(ny nx) in the table, 2.0e-6, 2.1e-6 and 1.8e-6), the DFT-matmul
    form (summed by the CPU's BLAS) 2.2e-6, 1.9e-6 and 1.8e-6.  The FFT
    route is held no farther from the truth than the dense form, within
    20%."""
    n, S = 72, 32
    lmbda = 1240.0 / 5000.0
    h = tprop.fresnel_kernel((n, n), (1.0, 1.0, 1.0), lmbda, 8.0,
                             fresnel_approx=False)
    rng = np.random.default_rng(3)
    k1 = 2 * np.pi / lmbda
    d = rng.uniform(0, 1e-2, (S, 2, n, n))
    b = rng.uniform(0, 1e-3, (S, 2, n, n))
    t64 = torch.from_numpy(np.exp(-k1 * b) * np.exp(-1j * k1 * d))
    w64 = torch.from_numpy(rng.normal(size=(1, 2, n, n))
                           + 1j * rng.normal(size=(1, 2, n, n)))
    g64 = torch.from_numpy(rng.normal(size=(1, 2, n, n))
                           + 1j * rng.normal(size=(1, 2, n, n)))
    t32, w32, g32 = (x.to(torch.complex64) for x in (t64, w64, g64))
    h64 = h.to(torch.complex128)
    truth = _sweep(lambda x, tr: (torch.fft.fft2(torch.fft.ifft2(x) * h64)
                                  if tr else
                                  torch.fft.ifft2(torch.fft.fft2(x) * h64)),
                   t32.to(torch.complex128), w32.to(torch.complex128),
                   g32.to(torch.complex128))
    table = cmf.step_table(h)
    fft = _sweep(lambda x, tr: cmf.fft_step2d_plain(x, table,
                                                    'PT' if tr else 'P'),
                 t32, w32, g32)
    f = torch.from_numpy(dft_matrix(n))
    dense = _sweep(lambda x, tr: _dense_step(x, f, f, h, tr), t32, w32, g32)
    e_fft = [_rel(a.numpy(), b.numpy()) for a, b in zip(fft, truth)]
    e_dense = [_rel(a.numpy(), b.numpy()) for a, b in zip(dense, truth)]
    print('K5 at 31 non-paraxial steps of 8 nm, of the largest values '
          '(fwd, gt, gw): FFT stage model '
          + ' '.join(f'{e:.3e}' for e in e_fft) + '; DFT-matmul form '
          + ' '.join(f'{e:.3e}' for e in e_dense))
    assert max(e_fft) < 1e-5 and max(e_dense) < 1e-5
    assert all(a < 1.2 * b for a, b in zip(e_fft, e_dense))


def _truth_inputs(seed, n=72, S=32):
    """The real_imag chunk's sweep operands (two patches, one mode) from
    ``seed``, as in :func:`test_k5_fft_route_against_float64_truth`, with
    the complex128 truth of the sweep."""
    lmbda = 1240.0 / 5000.0
    h = tprop.fresnel_kernel((n, n), (1.0, 1.0, 1.0), lmbda, 8.0,
                             fresnel_approx=False)
    rng = np.random.default_rng(seed)
    k1 = 2 * np.pi / lmbda
    d = rng.uniform(0, 1e-2, (S, 2, n, n))
    b = rng.uniform(0, 1e-3, (S, 2, n, n))
    t64 = torch.from_numpy(np.exp(-k1 * b) * np.exp(-1j * k1 * d))
    w64 = torch.from_numpy(rng.normal(size=(1, 2, n, n))
                           + 1j * rng.normal(size=(1, 2, n, n)))
    g64 = torch.from_numpy(rng.normal(size=(1, 2, n, n))
                           + 1j * rng.normal(size=(1, 2, n, n)))
    t32, w32, g32 = (x.to(torch.complex64) for x in (t64, w64, g64))
    h64 = h.to(torch.complex128)
    truth = _sweep(lambda x, tr: (torch.fft.fft2(torch.fft.ifft2(x) * h64)
                                  if tr else
                                  torch.fft.ifft2(torch.fft.fft2(x) * h64)),
                   t32.to(torch.complex128), w32.to(torch.complex128),
                   g32.to(torch.complex128))
    return h, (t32, w32, g32), truth


def _scaled_step(h, where):
    """The FFT route's step with the ``1 / (ny nx)`` of its two transforms
    back taken where C.2's suspect (a) puts it: ``'table'``, the former
    form, folded into the table (``H / (ny nx)`` rounded to f32); ``'after'``,
    one f32 ``1 / (ny nx)`` after both transforms back; ``'per_axis'``,
    the kernels' form (:func:`cmf.fft_step2d_plain`), ``1 / nx`` after the
    x transform back and ``1 / ny`` after the y one."""
    ny, nx = h.shape
    ry, rx = cm.fft_radix(ny), cm.fft_radix(nx)
    hh = h.to(torch.complex64)
    if where == 'table':
        hh = hh / (ny * nx)

    def step(w, transpose):
        inv = transpose
        x = cm.fft_stages_plain(w.transpose(-1, -2), ry, ny // ry,
                                inv).transpose(-1, -2)
        x = cm.fft_stages_plain(x, rx, nx // rx, inv) * hh
        x = cm.fft_stages_back_plain(x, rx, nx // rx, not inv)
        if where == 'per_axis':
            x = x * np.float32(1.0 / nx)
        x = cm.fft_stages_back_plain(x.transpose(-1, -2), ry, ny // ry,
                                     not inv).transpose(-1, -2)
        if where == 'table':
            return x
        return x * np.float32(1.0 / ny if where == 'per_axis'
                              else 1.0 / (ny * nx))
    return step


def _mirrored(step):
    """Suspect (b) of C.2: the step whose ``P^T`` is the transposes of
    ``step``'s ``P`` passes in reverse order, which is what autograd runs
    for its ``P`` (JAX's unconjugated transpose: ``conj(vjp(conj(a)))``)."""
    def mirrored(a, transpose):
        if not transpose:
            return step(a, False)
        x = torch.zeros_like(a, requires_grad=True)
        g, = torch.autograd.grad(step(x, False), x, torch.conj_physical(a))
        return torch.conj_physical(g)
    return mirrored


#: The seeds of C.2's measurement over draws (its largest error is one
#: element of one draw).
C2_SEEDS = (100, 101, 102, 103, 104)


def test_k5_fft_route_against_float64_truth_over_seeds():
    """C.2 on the CPU model: the sweep of
    :func:`test_k5_fft_route_against_float64_truth` over five draws, for
    the FFT route's stage model with the ``1 / (ny nx)`` where suspect (a)
    puts it (in the table as before, after the transforms back, or per
    axis as the kernels take it now), for suspect (b) (the table form's
    ``P^T`` as the mirror of its ``P``'s passes) and for the dense route's
    DFT-matmul form; each error of the largest value and of the rms value
    (``-s`` prints them).  Measured: the table form's median gt is 1.12x
    the dense form's largest error (rms 1.03x); after 1.08x (0.99x); per
    axis 0.88x (0.86x); (b) is the table form's ``P^T`` bit for bit, so it
    changes nothing.  Every form is within 1e-5 of the truth, and the
    kernels' form's median gt within 1.2x of the dense form's."""
    out = {k: [] for k in ('table', 'after', 'per_axis', 'mirror',
                           'dense')}
    for seed in C2_SEEDS:
        h, (t32, w32, g32), truth = _truth_inputs(seed)
        table = cmf.step_table(h)
        f = torch.from_numpy(dft_matrix(h.shape[0]))
        forms = {
            'table': _scaled_step(h, 'table'),
            'after': _scaled_step(h, 'after'),
            'per_axis': lambda x, tr: cmf.fft_step2d_plain(
                x, table, 'PT' if tr else 'P'),
            'mirror': _mirrored(_scaled_step(h, 'table')),
            'dense': lambda x, tr: _dense_step(x, f, f, h, tr)}
        sweeps = {name: _sweep(step, t32, w32, g32)
                  for name, step in forms.items()}
        for name, got in sweeps.items():
            out[name].append(
                [_rel(a.numpy(), b.numpy()) for a, b in zip(got, truth)]
                + [float((a.to(b.dtype) - b).norm() / b.norm())
                   for a, b in zip(got, truth)])
        assert all(torch.equal(a, b) for a, b in zip(sweeps['table'],
                                                     sweeps['mirror']))
        assert all(torch.equal(a, b) for a, b in zip(
            sweeps['per_axis'],
            _sweep(_scaled_step(h, 'per_axis'), t32, w32, g32)))
    errs = {k: np.array(v) for k, v in out.items()}
    for k, e in errs.items():
        ratio = np.median(e / errs['dense'], axis=0)
        print(f'C.2 {k}: per seed (fwd, gt, gw max; fwd, gt, gw rms) '
              + '; '.join(' '.join(f'{x:.3e}' for x in row) for row in e)
              + '; median ratio to dense ' + ' '.join(f'{x:.3f}'
                                                      for x in ratio))
        assert e.max() < 1e-5
    gt_ratio = np.median(errs['per_axis'][:, 1] / errs['dense'][:, 1])
    assert gt_ratio < 1.2


def test_k5_fft_step_gain_bias():
    """Why the FFT route's error differs from the dense route's: one step
    of each f32 form against the complex128 step on 64 random planes, as a
    gain bias (the error's part along the exact result, ``<P x, P~ x> /
    |P x|^2 - 1``, which adds up step after step) and an rms error (the
    rest, which adds up as a random walk).  The stage model's rounded roots
    give it a bias of about -3e-8 a step (-4.2e-8 with the 1/(ny nx) in
    the table; the dense form's is under 1e-8) and a smaller rms error
    (1.9e-7 against 3.1e-7): after 31 steps the bias is worth about 1e-6
    of the FFT route's 1.6e-6 rms error."""
    n = 72
    h = tprop.fresnel_kernel((n, n), (1.0, 1.0, 1.0), 1240.0 / 5000.0, 8.0,
                             fresnel_approx=False).to(torch.complex64)
    table = cmf.step_table(h)
    f = torch.from_numpy(dft_matrix(n))
    x = torch.from_numpy(_complex(np.random.default_rng(7), 64, n, n))
    h64 = h.to(torch.complex128)
    x64 = x.to(torch.complex128)
    for transpose in (False, True):
        ref = (torch.fft.fft2(torch.fft.ifft2(x64) * h64) if transpose else
               torch.fft.ifft2(torch.fft.fft2(x64) * h64))
        stats = {}
        for name, y in (
                ('fft', cmf.fft_step2d_plain(x, table,
                                             'PT' if transpose else 'P')),
                ('dense', _dense_step(x, f, f, h, transpose))):
            y = y.to(torch.complex128)
            gain = (ref.conj() * y).sum() / (ref.abs() ** 2).sum() - 1
            stats[name] = (float(gain.real),
                           float((y - ref).norm() / ref.norm()))
        print(f"C.2 one step {'P^T' if transpose else 'P'}: gain bias, rms "
              f"error: FFT model {stats['fft'][0]:+.3e} {stats['fft'][1]:.3e}"
              f"; dense form {stats['dense'][0]:+.3e} "
              f"{stats['dense'][1]:.3e}")
        assert stats['fft'][0] < -2e-8 and abs(stats['dense'][0]) < 1e-8
        assert stats['fft'][1] < stats['dense'][1] < 5e-7


# -- Routes and shared memory ----------------------------------------------

@pytest.mark.parametrize('ny,nx,route', [(72, 72, 'fft'), (16, 16, 'fft'),
                                         (12, 20, 'fft'), (8, 8, 'fft'),
                                         (81, 81, 'fft'), (70, 70, 'dense'),
                                         (13, 17, 'dense'), (72, 13, 'dense'),
                                         (88, 88, 'dense')])
def test_k5_route(ny, nx, route):
    """FFT where both sides split (81^2 takes it with the step table
    through L2), dense elsewhere (70 = 7 x 10 and 88 = 8 x 11 do not
    split with both radices at most 9)."""
    assert cmf.k5_route(ny, nx) == route


def test_k5_fft_route_shared_memory():
    """K5's FFT-route blocks at 72^2: two planes of 72 rows of 73, the
    staged t plane (and in the backward the staged record plane), the step
    table and both axes' roots; at 81^2 the backward's table does not fit
    and is read through L2.  The dense route's block holds M + 1 planes
    and the DFT matrix: 3 modes at most at 72^2."""
    fwd = 8 * (2 * 72 * 73 + 2 * 72 * 72 + 2 * 72)
    assert cmf.smem_bytes(1, 72, 72, 'fft') == fwd == 168192
    assert cmf.smem_bytes(1, 72, 72, 'fft', backward=True) == (
        fwd + 8 * 72 * 72) == 209664
    assert cmf.smem_bytes(8, 72, 72, 'fft', backward=True) == 209664
    assert cmf.smem_bytes(1, 81, 81, 'fft', backward=True) == 8 * (
        2 * 81 * 81 + 2 * 81 * 81 + 2 * 81)
    assert cmf.smem_bytes(1, 81, 81, 'fft') == 8 * (
        2 * 81 * 81 + 2 * 81 * 81 + 2 * 81)
    for m in (1, 3, 8):
        assert cmf.smem_bytes(m, 72, 72, 'fft', backward=True) <= (
            cm.MAX_SMEM_BYTES)
    assert cmf.smem_bytes(3, 72, 72) == 207360
    assert cmf.smem_bytes(4, 72, 72) > cm.MAX_SMEM_BYTES
    assert cmf.smem_bytes(4, 70, 70) > cm.MAX_SMEM_BYTES
    assert cmf.smem_bytes(3, 70, 70) <= cm.MAX_SMEM_BYTES
