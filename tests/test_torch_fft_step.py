"""The FFT step route of K1 and K4 on the CPU: the plain model of the
kernels' two-stage transforms (``fft_stages_plain`` and
``fft_stages_back_plain``) against ``torch.fft``; the three step variants
it builds from ``fft_step_vectors`` against the folded step matrices, the
port's and the JAX package's (``_fold_prop_mats``); both f32 forms of the
step against a float64 truth over the flagships' depths; the routes and
shared memory of each kernel; and K1's sweep on the route, built from the
stage model, against the JAX package's ``multislice_db_stored_packed``.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
these tests fix the stages, roots, output order and step vectors the CUDA
routine (``csrc/multislice_common.cuh``, ``fft_propagate``) follows.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adorym_tpu.ops import pallas_multislice as pm
from adorym_tpu.ops import propagate as jprop
from adorym_tpu_torch.ops import cuda_multislice as cm
from adorym_tpu_torch.ops import propagate as tprop
from adorym_tpu_torch.ops.fourier import dft_matrix

#: The step transfer functions: the multi-mode flagship's (72^2, a 1 nm
#: step at 5 keV) and the card tests' (12x20, 20 nm at 0.1 nm).
KERNELS = {'flagship': ((72, 72), 1240.0 / 5000.0, 1.0),
           'card': ((12, 20), 0.1, 20.0)}


def _rel(a, b):
    """Max error relative to the largest reference magnitude."""
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _complex(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


# f32 roundoff of two stages of at most 9-point sums: 1e-5 of the largest
# value holds with 50x margin.
@pytest.mark.parametrize('back', [False, True])
@pytest.mark.parametrize('inverse', [False, True])
@pytest.mark.parametrize('n1,n2', [(8, 9), (8, 8), (3, 8), (4, 5), (4, 4),
                                   (3, 4)])
def test_fft_stages_plain_matches_torch_fft(n1, n2, inverse, back):
    """The kernel's stages (``back``: their transpose, which the route
    takes back to the plane) in both directions, unnormalised: the inverse
    is ``n * ifft``."""
    rng = np.random.default_rng(n1 * 16 + n2)
    x = torch.from_numpy(_complex(rng, 6, n1 * n2))
    fn = cm.fft_stages_back_plain if back else cm.fft_stages_plain
    got = fn(x, n1, n2, inverse)
    want = torch.fft.ifft(x, norm='forward') if inverse else torch.fft.fft(x)
    assert _rel(got, want) < 1e-5


def _dense(py, px, step, w):
    """``V_y w V_x^T`` with the per-axis variant of the folded mats:
    ``P``, ``P^T`` or ``P^-1 = conj(P^T)``."""
    if step == 'P':
        vy, vx = py, px
    elif step == 'PT':
        vy, vx = py.T, px.T
    else:
        vy, vx = py.T.conj(), px.T.conj()
    return vy @ w @ vx.T


# Both sides f32 (the FFT model) or complex64 mats applied in f64: the
# transforms' roundoff, 1e-5 of the largest value.
@pytest.mark.parametrize('step', ['P', 'PT', 'Pinv'])
@pytest.mark.parametrize('which', sorted(KERNELS))
def test_fft_step_matches_port_folded_mats(which, step):
    shape, lmbda, dist = KERNELS[which]
    h = tprop.fresnel_kernel(shape, (1.0, 1.0, 1.0), lmbda, dist)
    py, px = (m.numpy().astype(np.complex128) for m in cm._fold_prop_mats(h))
    w = _complex(np.random.default_rng(7), 3, *shape)
    vy, vx = cm.fft_step_vectors(h)
    got = cm.fft_step_plain(torch.from_numpy(w), vy, vx, step)
    assert _rel(got.numpy(), _dense(py, px, step, w)) < 1e-5


@pytest.mark.parametrize('step', ['P', 'PT', 'Pinv'])
@pytest.mark.parametrize('which', sorted(KERNELS))
def test_fft_step_matches_jax_folded_mats(which, step):
    """The JAX package's transfer function and folded mats, its step
    vectors built by the port from the same H."""
    shape, lmbda, dist = KERNELS[which]
    h = jprop.fresnel_kernel(shape, (1.0, 1.0, 1.0), lmbda, dist)
    py, px = (np.asarray(m).astype(np.complex128) for m in
              pm._fold_prop_mats(jnp.real(h), jnp.imag(h), *shape))
    w = _complex(np.random.default_rng(8), 3, *shape)
    vy, vx = cm.fft_step_vectors(torch.from_numpy(np.array(h)))
    got = cm.fft_step_plain(torch.from_numpy(w), vy, vx, step)
    assert _rel(got.numpy(), _dense(py, px, step, w)) < 1e-5


@pytest.mark.parametrize('n,n1', [(72, 8), (64, 8), (81, 9), (24, 4),
                                  (20, 4), (16, 4), (12, 3), (4, 2), (13, 0),
                                  (17, 0), (80, 0), (2, 0)])
def test_fft_radix(n, n1):
    """The largest n1 <= n2 <= 9 of n = n1 n2, 0 for the dense route."""
    assert cm.fft_radix(n) == n1


@pytest.mark.parametrize('ny,nx,route', [(72, 72, 'fft'), (16, 16, 'fft'),
                                         (12, 20, 'fft'), (13, 17, 'dense'),
                                         (72, 13, 'dense'), (81, 81, 'global')])
def test_k4_route(ny, nx, route):
    """FFT where both sides split and the backward block fits; 81^2 splits
    as 9 x 9, but three planes of it fit neither the FFT route's block nor
    the dense one's, so it takes the global route (planes in device
    memory)."""
    assert cm.k4_route(ny, nx) == route


def test_fft_route_shared_memory():
    """K4's blocks at 72^2 on the FFT route: planes of 72 rows of 73 and
    the table (hy, hx, two root tables).  The forward holds its plane and
    a scratch plane (it reads the step's db planes through L2); the
    backward's mat slots' region holds the rebuilt wave's scratch plane and
    the next step's f32 db planes (72 x 73 + 72 x 72 elements) during the
    steps."""
    assert cm.smem_bytes(72, 72, 2, 'fft', 'K4') == 8 * (
        2 * 72 * 73 + 4 * 72) == 86400
    assert cm.smem_bytes(72, 72, 3, 'fft', 'K4') == 8 * (
        3 * 72 * 73 + 72 * 73 + 72 * 72 + 4 * 72) == 211968
    assert cm.smem_bytes(72, 72, 3, 'fft', 'K4') <= cm.MAX_SMEM_BYTES
    assert cm.smem_bytes(72, 72, 3, kernel='K4') == 207360
    with pytest.raises(ValueError, match='kernel'):
        cm.smem_bytes(72, 72, 2, 'fft', 'K5')


def test_k4_forward_fits_two_blocks_an_sm():
    """At 72^2 two K4f blocks (each with the 1 KB the card reserves a
    block) share an SM's 233,472 bytes of shared memory; K1f's block of the
    same route, and K4b's, fit once.  Two fit at every shape of K4's FFT
    route."""
    def fit(b):
        return 233472 // (b + 1024)
    assert fit(cm.smem_bytes(72, 72, 2, 'fft', 'K4')) == 2
    assert fit(cm.smem_bytes(72, 72, 2, 'fft', 'K1')) == 1
    assert fit(cm.smem_bytes(72, 72, 3, 'fft', 'K4')) == 1
    shapes = [(ny, nx) for ny in range(4, 97) for nx in range(4, 97)
              if cm.k4_route(ny, nx) == 'fft']
    assert (72, 72) in shapes and (12, 20) in shapes
    for ny, nx in shapes:
        assert fit(cm.smem_bytes(ny, nx, 2, 'fft', 'K4')) >= 2


def test_fft_step_vectors_fold_the_step():
    """``n * vy[y] * n * vx[x]`` is the separable H itself (H[0, 0] = 1)."""
    shape, lmbda, dist = KERNELS['card']
    h = tprop.fresnel_kernel(shape, (1.0, 1.0, 1.0), lmbda, dist)
    vy, vx = cm.fft_step_vectors(h)
    outer = (12 * vy)[:, None] * (20 * vx)[None, :]
    assert _rel(outer.numpy(), h.numpy()) < 1e-6


def test_prop_mats_fft_route_holds_vectors():
    """On the FFT route the step slots carry the vectors, the far field
    its dense mats as on the dense route."""
    shape, lmbda, dist = KERNELS['card']
    h = tprop.fresnel_kernel(shape, (1.0, 1.0, 1.0), lmbda, dist)
    fm = tprop.final_prop_mats(shape, (1.0, 1.0), lmbda, 'inf')
    fft = cm.prop_mats(h, *fm, route='fft')
    dense = cm.prop_mats(h, *fm)
    assert fft['route'] == 'fft' and dense['route'] == 'dense'
    assert tuple(fft['fwd_y'].shape) == (12,)
    assert tuple(fft['bwd_x'].shape) == (20,)
    for key in ('ffwd_y', 'ffwd_x', 'fbwd_y', 'fbwd_x', 'finv_y', 'finv_x'):
        assert torch.equal(fft[key], dense[key])


# -- The step against a float64 truth ----------------------------------------

#: The flagships' steps at full depth: the multi-mode flagship's 255
#: propagations of 1 nm, and the binned flagship's 31 of 8 nm followed by
#: the Fraunhofer far field (at 5 keV, 72^2, 1 nm voxels).
DEPTHS = {'multimode': (1.0, 255, False), 'binned': (8.0, 31, True)}


def _truth_step_mats(h):
    """The folded step ``P = G diag(h) F`` of each axis in complex128, from
    the f32 transfer function upcast: the same operator both f32 forms
    apply, without their roundoff."""
    h = h.numpy().astype(np.complex128)

    def fold(n, v):
        f = dft_matrix(n, dtype=np.complex128)
        g = dft_matrix(n, inverse=True, dtype=np.complex128)
        return (g * v[None, :]) @ f

    return fold(h.shape[0], h[:, 0] / h[0, 0]), fold(h.shape[1], h[0, :])


def _truth_far_mats(n):
    """The Fraunhofer pair (fftshift after the unnormalised DFT) of one
    axis and its exact inverse, in complex128."""
    shift = np.fft.fftshift(np.eye(n), axes=0)
    return (shift @ dft_matrix(n, dtype=np.complex128),
            dft_matrix(n, inverse=True, dtype=np.complex128) @ shift.T)


def _far(fy, fx, step, w):
    """The far field as each sweep meets it: after the steps of ``P``
    (``Fy w Fx^T``), before those of ``P^T`` (the cotangent, ``Fy^T w
    Fx``) and of ``P^-1`` (the rebuilt wave, the exact inverse)."""
    if step == 'P':
        return fy[0] @ w @ fx[0].T
    if step == 'PT':
        return fy[0].T @ w @ fx[0]
    return fy[1] @ w @ fx[1].T


def _sweep(step_fn, step, n_steps, far, w):
    if far is not None and step != 'P':
        w = _far(*far, step, w)
    for _ in range(n_steps):
        w = step_fn(w)
    if far is not None and step == 'P':
        w = _far(*far, step, w)
    return w


# Measured on the CPU: at 255 steps the folded mats 2.8e-5 to 3.0e-5 of the
# largest value, the stage model 1.2e-5 to 1.3e-5; at 31 steps and the far
# field about 4.5e-6 and 2e-6.  Both forms' error grows with depth as the
# f32 rounding of the step's factors does (the step vectors alone, with
# f64 arithmetic, give 1.4e-5 at 255 steps).
@pytest.mark.parametrize('step', ['P', 'PT', 'Pinv'])
@pytest.mark.parametrize('depth', sorted(DEPTHS))
def test_fft_step_nearer_float64_truth_than_folded_mats(depth, step):
    """The f32 folded mats (K1's dense route and JAX's kernel) and the f32
    stage model of the FFT route, each against complex128 over the
    flagship's depth; the stage model is the nearer."""
    dist, n_steps, with_far = DEPTHS[depth]
    shape = (72, 72)
    lmbda = 1240.0 / 5000.0
    h = tprop.fresnel_kernel(shape, (1.0, 1.0, 1.0), lmbda, dist)
    rng = np.random.default_rng(9)
    w = rng.normal(size=(4,) + shape) + 1j * rng.normal(size=(4,) + shape)
    far32 = far64 = None
    if with_far:
        fm = tprop.final_prop_mats(shape, (1.0, 1.0), lmbda, 'inf')
        far32 = ((fm[0], fm[2]), (fm[1], fm[3]))
        far64 = (_truth_far_mats(72), _truth_far_mats(72))
    py, px = _truth_step_mats(h)
    truth = _sweep(lambda x: _dense(py, px, step, x), step, n_steps, far64,
                   w)
    py32, px32 = cm._fold_prop_mats(h)
    w32 = torch.from_numpy(w.astype(np.complex64))
    folded = _sweep(lambda x: _dense(py32, px32, step, x), step, n_steps,
                    far32, w32)
    vy, vx = cm.fft_step_vectors(h)
    fft = _sweep(lambda x: cm.fft_step_plain(x, vy, vx, step), step,
                 n_steps, far32, w32)
    e_folded, e_fft = _rel(folded, truth), _rel(fft, truth)
    print(f'{depth} {step}: folded mats {e_folded:.3e}, FFT stage model '
          f'{e_fft:.3e} of the largest value')
    bound = 5e-5 if n_steps > 100 else 1e-5
    assert e_folded < bound and e_fft < bound
    assert e_fft < e_folded


# -- K1 on the FFT route ----------------------------------------------------

@pytest.mark.parametrize('ny,nx,route', [(72, 72, 'fft'), (16, 16, 'fft'),
                                         (12, 20, 'fft'), (13, 17, 'dense'),
                                         (81, 81, 'fft'), (88, 88, 'global')])
def test_k1_route(ny, nx, route):
    """FFT where both sides split and K1's two-plane block fits: 81^2
    takes it (K4 does not); 88 = 8 x 11 does not split, and the dense
    route's block does not fit at 88^2, so it takes the global route."""
    assert cm.k1_route(ny, nx) == route


def test_k1_fft_route_shared_memory():
    """K1's FFT-route block, 169,344 bytes at 72^2: two planes of 72 rows
    of 73, the slot region and the table.  At every shape the
    route takes, the slot region holds the step's f32 db pair and its f32
    record plane (2 ny nx <= ny^2 + nx^2) for the backward."""
    assert cm.smem_bytes(72, 72, 2, 'fft') == 169344
    assert cm.fft_slot_elems(2, 72, 72) == 2 * 72 * 72
    sides = range(4, 97)
    shapes = [(ny, nx) for ny in sides for nx in sides
              if cm.k1_route(ny, nx) == 'fft']
    assert (72, 72) in shapes and (12, 20) in shapes
    for ny, nx in shapes:
        assert cm.fft_slot_elems(2, ny, nx) >= 2 * ny * nx
        assert cm.smem_bytes(ny, nx, 2, 'fft') <= cm.MAX_SMEM_BYTES


def _k1_fft_sweep(db, wave, h, k1, s, fay, fax, g):
    """K1's FFT route op by op, autograd off: the forward records the wave
    entering each step and propagates with the stage model's ``P``; the
    backward carries JAX's unconjugated cotangent ``a = conj(g)`` (``g`` in
    PyTorch's convention) through ``F^T`` and the stage model's ``P^T``,
    sums ``a * rec`` over the modes for each step's ``gdb``, and returns
    PyTorch's ``conj(a)`` as the wave's gradient."""
    vy, vx = cm.fft_step_vectors(h)
    n_steps = db.shape[0]
    w, recs = wave, []
    for z in range(n_steps):
        recs.append(w)
        w = w * cm._modulator(db[z], k1, s)
        if z < n_steps - 1:
            w = cm.fft_step_plain(w, vy, vx, 'P')
        elif fay is not None:
            w = fay @ w @ fax.T
    a = torch.conj_physical(g)
    if fay is not None:
        a = fay.T @ a @ fax
    gdb = torch.empty_like(db)
    for z in range(n_steps - 1, -1, -1):
        if z < n_steps - 1:
            a = cm.fft_step_plain(a, vy, vx, 'PT')
        t = cm._modulator(db[z], k1, s)
        cu = (a * recs[z]).sum(0) * t
        gdb[z, 0] = s * k1 * cu.imag
        gdb[z, 1] = -k1 * cu.real
        a = a * t
    return w, gdb, torch.conj_physical(a)


# f32 both sides, a few steps of 12..20-point transforms: 1e-5 of the
# largest value.
@pytest.mark.parametrize('final', [False, True])
@pytest.mark.parametrize('M', [1, 3])
@pytest.mark.parametrize('S,ny,nx', [(4, 16, 16), (5, 12, 20)])
def test_k1_fft_sweep_matches_pallas(S, ny, nx, M, final):
    """The sweep K1's kernels run on the FFT route, against the JAX
    package's Pallas pair (interpret mode) and its VJP: the exit wave and
    the gradients on db and on the wave as a real pair."""
    k1, sign, lmbda = 25.0, 1.0, 0.1
    rng = np.random.default_rng(ny + M)
    db = np.stack([rng.uniform(0, 1e-2, (S, 3, ny, nx)),
                   rng.uniform(0, 1e-3, (S, 3, ny, nx))], 1).astype(
                       np.float32)
    wpair = (rng.normal(size=(M, 3, ny, nx, 2)) * 0.5).astype(np.float32)
    cot = rng.normal(size=(M, 3, ny, nx, 2)).astype(np.float32)

    h_j = jprop.fresnel_kernel((ny, nx), (1.0, 1.0, 1.0), lmbda, 20.0)
    fm_j = (jprop.final_prop_mats((ny, nx), (1.0, 1.0), lmbda, 'inf')[:2]
            if final else (None, None))

    def f(d, wp):
        wave = (wp[..., 0] + 1j * wp[..., 1]).astype(jnp.complex64)
        out = pm.multislice_db_stored_packed(d, wave, h_j, k1, sign, True,
                                             False, *fm_j)
        return jnp.sum(jnp.real(out) * cot[..., 0]
                       + jnp.imag(out) * cot[..., 1]), out

    (_, o_j), (gdb_j, gw_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(db), jnp.asarray(wpair))

    h = tprop.fresnel_kernel((ny, nx), (1.0, 1.0, 1.0), lmbda, 20.0)
    fay, fax = (tprop.final_prop_mats((ny, nx), (1.0, 1.0), lmbda,
                                      'inf')[:2] if final else (None, None))
    g = torch.view_as_complex(torch.from_numpy(cot))
    wave = torch.view_as_complex(torch.from_numpy(wpair))
    out, gdb, gw = _k1_fft_sweep(torch.from_numpy(db), wave, h, k1, sign,
                                 fay, fax, g)
    assert _rel(out.numpy(), np.asarray(o_j)) < 1e-5
    assert _rel(gdb.numpy(), np.asarray(gdb_j)) < 1e-5
    assert _rel(torch.view_as_real(gw).numpy(), np.asarray(gw_j)) < 1e-5
