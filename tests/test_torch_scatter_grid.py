"""The port's grid-scatter (K2) and grid-gather (K3) plain versions against
the JAX package's Pallas band kernels (``grid2d_tile``,
``scatter_grid2d_add_pallas``, ``grid2d_extract`` and
``extract_grid2d_pallas``, interpret mode) and its XLA scatter."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adorym_tpu.ops import pallas_scatter_grid as psg
from adorym_tpu.ops import patches as jpatches
from adorym_tpu_torch.ops import cuda_scatter_grid as csg
from adorym_tpu_torch.ops import patches as tpatches

CASES = [(3, 4, 16, 16, 8, (4, 2)), (2, 3, 16, 8, 8, (8, 2)),
         (4, 2, 8, 8, 4, (8, 4))]


def _cot(rows, cols, py, px, trail, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(rows * cols, py, px) + trail).astype(np.float32)


@pytest.mark.parametrize('rows,cols,py,px,s,trail', CASES)
def test_tile_matches_pallas(rows, cols, py, px, s, trail):
    cot = _cot(rows, cols, py, px, trail)
    want = np.asarray(psg.grid2d_tile(jnp.asarray(cot), s, rows,
                                      interpret=True))
    got = csg.grid2d_tile_plain(torch.from_numpy(cot), s, rows).numpy()
    # Same f32 values summed in another order (<= ky*kx terms).
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize('rows,cols,py,px,s,trail', CASES)
def test_scatter_matches_pallas_and_xla(rows, cols, py, px, s, trail):
    cot = _cot(rows, cols, py, px, trail)
    ty, tx = csg.tile_shape(cot.shape, s, rows)
    acc = np.random.default_rng(2).normal(
        size=(ty + 6, tx + 3) + trail).astype(np.float32)
    y0, x0 = 4, 2
    want_p = np.asarray(psg.scatter_grid2d_add_pallas(
        jnp.asarray(acc), jnp.asarray(cot), y0, x0, s, rows,
        interpret=True))
    want_x = np.asarray(jpatches.scatter_grid2d_add(
        jnp.asarray(acc), jnp.asarray(cot), y0, x0, s, rows))
    for fn in (tpatches.scatter_grid2d_add_best, tpatches.scatter_grid2d_add):
        acc_t = torch.from_numpy(acc.copy())
        got = fn(acc_t, torch.from_numpy(cot), y0, x0, s, rows)
        assert got.data_ptr() == acc_t.data_ptr(), 'must update in place'
        np.testing.assert_allclose(got.numpy(), want_p, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_x, rtol=1e-6, atol=1e-5)


def test_bf16_cotangent_f32_accumulation():
    """bf16 cotangents accumulate in f32, as in the Pallas kernel."""
    cot = _cot(3, 4, 16, 16, (4, 2), seed=3)
    cot_b = jnp.asarray(cot, jnp.bfloat16)
    acc = np.zeros((40, 48, 4, 2), np.float32)
    want = np.asarray(psg.scatter_grid2d_add_pallas(
        jnp.asarray(acc), cot_b, 0, 0, 8, 3, interpret=True))
    cot_t = torch.from_numpy(np.array(cot_b.astype(jnp.float32))).to(
        torch.bfloat16)
    got = csg.scatter_grid2d_add(torch.from_numpy(acc), cot_t, 0, 0, 8, 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_channel_major_layout_detected():
    """The kernel reads a z-major gradient ``[zb, 2, N, py, px]`` viewed as
    ``[N, py, px, zb, 2]`` in place; other views are copied first."""
    zm = torch.zeros((4, 2, 12, 8, 8))
    assert csg._channel_major(zm.permute(2, 3, 4, 0, 1))
    assert not csg._channel_major(zm.permute(2, 3, 4, 0, 1).contiguous())
    assert not csg._channel_major(zm.permute(2, 4, 3, 0, 1))
    assert not csg._channel_major(torch.zeros((12, 8, 8)))
    # The plain version takes the view as it is.
    cot = _cot(3, 4, 8, 8, (4, 2), seed=5)
    cot_zm = torch.from_numpy(np.moveaxis(cot, (3, 4), (0, 1)).copy())
    view = cot_zm.permute(2, 3, 4, 0, 1)
    acc = torch.zeros((24, 32, 4, 2))
    np.testing.assert_array_equal(
        csg.scatter_grid2d_add(acc.clone(), view, 0, 0, 4, 3).numpy(),
        csg.scatter_grid2d_add(acc.clone(), torch.from_numpy(cot), 0, 0, 4,
                               3).numpy())


@pytest.mark.parametrize('dtype', [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize('trail,zmajor', [((32, 2), True),
                                          ((256, 2), False)])
def test_scatter_flagship_widths_match_pallas(trail, zmajor, dtype):
    """The plain version at the flagship chunks' trailing shapes, cut to
    2x3 patches of 24^2 at stride 8: the delta_beta chunk's z-major
    gradient ``[32, 2, N, py, px]`` viewed as ``[N, py, px, 32, 2]`` and
    the real_imag chunk's patch-major ``[N, py, px, 256, 2]``, f32 and bf16
    cotangents into an f32 accumulator, against
    ``scatter_grid2d_add_pallas`` (interpret mode)."""
    rows, cols, py, px, s = 2, 3, 24, 24, 8
    cot = np.array(jnp.asarray(_cot(rows, cols, py, px, trail, seed=10))
                   .astype(dtype).astype(jnp.float32))
    ty, tx = csg.tile_shape(cot.shape, s, rows)
    acc = np.random.default_rng(11).normal(
        size=(ty + 3, tx + 2) + trail).astype(np.float32)
    want = np.asarray(psg.scatter_grid2d_add_pallas(
        jnp.asarray(acc), jnp.asarray(cot).astype(dtype), 2, 1, s, rows,
        interpret=True))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    cot_t = torch.from_numpy(cot).to(tdtype)
    if zmajor:
        cot_t = cot_t.permute(3, 4, 0, 1, 2).contiguous().permute(
            2, 3, 4, 0, 1)
        assert csg._channel_major(cot_t)
    got = csg.scatter_grid2d_add(torch.from_numpy(acc.copy()), cot_t, 2, 1,
                                 s, rows)
    assert got.dtype == torch.float32
    # The same f32 values (bf16 upcast exactly), <= 9 terms, other orders.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize('itemsize,channels,stride,channel_major,ptrs,want', [
    (4, 64, 8, True, (0, 4096), 4),      # delta_beta: along x, stride 8
    (2, 64, 8, True, (0, 4096), 8),
    (4, 512, 8, False, (256, 512), 4),   # real_imag: along c
    (2, 512, 8, False, (256, 512), 8),
    (4, 64, 4, True, (0, 0), 4),         # stride 4 takes 4 f32 ...
    (2, 64, 4, True, (0, 0), 1),         # ... but not 8 bf16
    (2, 4, 8, False, (0, 0), 1),         # 4 bf16 channels: not 8
    (4, 6, 8, True, (0, 0), 1),          # C % 4: the accumulator's words
    (4, 33, 8, False, (0, 0), 1),        # an odd site
    (4, 64, 8, True, (4, 0), 1),         # a cotangent pointer off 16 bytes
    (4, 512, 8, False, (0, 8), 1)])      # an accumulator pointer likewise
def test_vector_width(itemsize, channels, stride, channel_major, ptrs,
                      want):
    """K2's instantiation: 16 bytes a thread where the vector divides the
    stride (channel-major, whose block's bulk copies must fit in shared
    memory: 105 KB at the flagship, 227 KB at most) or the site
    (patch-major), the site is a whole number of the accumulator's 16-byte
    words and both pointers are 16-byte aligned; one element otherwise."""
    flagship = csg.bulk_copy_smem_bytes(itemsize, 23, 72, stride)
    assert flagship == 2 * itemsize * 23 * (32 // itemsize * 72 + 8)
    assert csg.vector_width(itemsize, channels, stride, channel_major,
                            *ptrs, smem_bytes=flagship) == want
    # Patch rows too long for the buffers take the scalar instantiation.
    big = csg.bulk_copy_smem_bytes(itemsize, 60, 256, stride)
    assert big > 232448
    assert csg.vector_width(itemsize, channels, stride, channel_major,
                            *ptrs, smem_bytes=big) == (
                                1 if channel_major else want)


@pytest.mark.parametrize('n,py,px,s,trail', [(5, 16, 16, 8, (4, 2)),
                                             (3, 8, 16, 4, (3,))])
def test_rowgrid_scatter_matches_pallas_and_xla(n, py, px, s, trail):
    """K6's plain version and its wrapper (the plain version on the CPU)
    against ``scatter_rowgrid_add_pallas`` (interpret mode) and the JAX
    package's ``scatter_rowgrid_add``: one grid row at ``(y0, x0 +
    s*j)``."""
    cot = _cot(1, n, py, px, trail, seed=8)
    acc = np.random.default_rng(9).normal(
        size=(py + 5, (n - 1) * s + px + 7) + trail).astype(np.float32)
    y0, x0 = 3, 5
    want_p = np.asarray(psg.scatter_rowgrid_add_pallas(
        jnp.asarray(acc), jnp.asarray(cot), y0, x0, s, interpret=True))
    want_x = np.asarray(jpatches.scatter_rowgrid_add(
        jnp.asarray(acc), jnp.asarray(cot), y0, x0, s))
    for fn in (csg.scatter_rowgrid_add, csg.scatter_rowgrid_add_kernel,
               tpatches.scatter_rowgrid_add):
        acc_t = torch.from_numpy(acc.copy())
        got = fn(acc_t, torch.from_numpy(cot), y0, x0, s)
        assert got.data_ptr() == acc_t.data_ptr(), 'must update in place'
        np.testing.assert_allclose(got.numpy(), want_p, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_x, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize('shape,stride,rows', [
    ((12, 16, 16, 2), 6, 3), ((12, 16, 16, 2), 8, 5)])
def test_unsupported_shapes_raise(shape, stride, rows):
    with pytest.raises(ValueError):
        csg.check_supported(shape, stride, rows)


def test_bytes_moved_flagship():
    """0.70 GB of f32 cotangents plus the 248x248x64 tile read and written."""
    assert csg.bytes_moved((529, 72, 72, 32, 2), 8, 23, 4) == pytest.approx(
        0.7335e9, rel=1e-3)


# -- K3: the grid gather ------------------------------------------------------

EXTRACT_CASES = [(4, 4, 16, 16, 8, (8, 2)), (3, 5, 24, 16, 8, (16, 2)),
                 (2, 2, 8, 8, 8, (16, 2)), (5, 3, 16, 24, 8, (4, 2))]


def _obj(rows, cols, py, px, s, trail, dtype, seed=4):
    rng = np.random.default_rng(seed)
    shape = ((rows - 1) * s + py + 24, (cols - 1) * s + px + 16) + trail
    return jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize('dtype', [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize('rows,cols,py,px,s,trail', EXTRACT_CASES)
def test_extract_matches_pallas(rows, cols, py, px, s, trail, dtype):
    """K3's plain version, from a tile and from the object at an origin,
    against ``grid2d_extract`` and ``extract_grid2d_pallas``: a pure copy,
    so exact, in f32 and bf16 with a trailing ``(z, 2)`` axis."""
    obj = _obj(rows, cols, py, px, s, trail, dtype)
    y0, x0 = 8, 5
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    obj_t = torch.from_numpy(_np(obj)).to(tdtype)
    want = psg.extract_grid2d_pallas(obj, y0, x0, s, rows, cols, (py, px),
                                     interpret=True)
    got = csg.extract_grid2d(obj_t, y0, x0, s, rows, cols, (py, px))
    assert got.dtype == tdtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    ty, tx = csg.tile_shape(want.shape, s, rows)
    tile = obj[y0:y0 + ty, x0:x0 + tx]
    want_t = psg.grid2d_extract(tile, s, rows, cols, (py, px),
                                interpret=True)
    got_t = csg.grid2d_extract_plain(obj_t[y0:y0 + ty, x0:x0 + tx], s, rows,
                                     cols, (py, px))
    np.testing.assert_array_equal(got_t.float().numpy(), _np(want_t))


@pytest.mark.parametrize('y0,x0', [(4, 12), (0, 0), (16, 24)])
def test_extract_best_matches_jax(y0, x0):
    """The router against the JAX package's (whose CPU fallback is
    ``extract_patches`` at the grid's positions), the footprint inside the
    object as the Reconstructor's padding makes it."""
    rng = np.random.default_rng(6)
    rows, cols, py, px, s = 4, 3, 16, 16, 8
    obj = rng.normal(size=(72, 64, 8, 2)).astype(np.float32)
    want = jpatches.extract_grid2d_best(jnp.asarray(obj), jnp.asarray(y0),
                                        jnp.asarray(x0), s, rows, cols,
                                        (py, px))
    got = tpatches.extract_grid2d_best(torch.from_numpy(obj), y0, x0, s,
                                       rows, cols, (py, px))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_extract_is_the_scatter_transpose():
    """<scatter(c), o> == <c, extract(o)> on the same grid."""
    rng = np.random.default_rng(7)
    rows, cols, py, px, s = 3, 4, 16, 16, 8
    obj = torch.from_numpy(rng.normal(size=(48, 56, 4, 2)).astype(np.float64))
    cot = torch.from_numpy(rng.normal(size=(rows * cols, py, px, 4, 2)))
    acc = csg.scatter_grid2d_add_plain(torch.zeros_like(obj), cot, 5, 3, s,
                                       rows)
    patches = csg.extract_grid2d(obj, 5, 3, s, rows, cols, (py, px))
    assert float((acc * obj).sum()) == pytest.approx(
        float((cot * patches).sum()), rel=1e-12)


def test_extract_rejects_footprint_outside():
    obj = torch.zeros((20, 20, 2))
    with pytest.raises(ValueError, match='leaves the object'):
        csg.extract_grid2d(obj, 0, 2, 4, 3, 3, (12, 12))
    with pytest.raises(ValueError):
        csg.extract_grid2d(obj, 0, 0, 5, 2, 2, (8, 8))


def test_extract_bytes_moved_real_imag_flagship():
    """5.62 GB of f32 patches written plus the 248x248x512 footprint read."""
    assert csg.extract_bytes_moved((529, 72, 72, 256, 2), 8, 23,
                                   4) == pytest.approx(5.7426e9, rel=1e-3)
