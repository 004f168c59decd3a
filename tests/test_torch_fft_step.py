"""K4's FFT route on the CPU: the plain model of the kernels' two-stage
transforms (``fft_stages_plain`` and ``fft_stages_back_plain``) against
``torch.fft``, and the three step variants it builds from
``fft_step_vectors`` against the folded step matrices, the port's and the
JAX package's (``_fold_prop_mats``).

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
these tests fix the stages, roots, output order and step vectors the CUDA
routine (``csrc/multislice_common.cuh``, ``fft_propagate``) follows.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adorym_tpu.ops import pallas_multislice as pm
from adorym_tpu.ops import propagate as jprop
from adorym_tpu_torch.ops import cuda_multislice as cm
from adorym_tpu_torch.ops import propagate as tprop

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
                                         (72, 13, 'dense'), (81, 81, 'dense')])
def test_k4_route(ny, nx, route):
    """FFT where both sides split and the backward block fits (81^2 splits
    as 9 x 9 but three planes of it do not fit)."""
    assert cm.k4_route(ny, nx) == route


def test_fft_route_shared_memory():
    """K4's blocks at 72^2 on the FFT route: planes of 72 rows of 73, the
    table (hy, hx, two root tables), and the mat slots' region, which in
    the backward holds the rebuilt wave's scratch plane and the next
    step's f32 db planes (72 x 73 + 72 x 72 elements) during the steps."""
    assert cm.smem_bytes(72, 72, 2, 'fft') == 8 * (2 * 72 * 73 + 2 * 72 * 72
                                                  + 4 * 72) == 169344
    assert cm.smem_bytes(72, 72, 3, 'fft') == 8 * (3 * 72 * 73 + 72 * 73
                                                  + 72 * 72 + 4 * 72) == 211968
    assert cm.smem_bytes(72, 72, 3, 'fft') <= cm.MAX_SMEM_BYTES
    assert cm.smem_bytes(72, 72, 3) == 207360


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
