"""The port's grid-scatter plain version against the JAX package's Pallas
band kernel (``grid2d_tile`` and ``scatter_grid2d_add_pallas``, interpret
mode) and its XLA scatter."""

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


@pytest.mark.parametrize('shape,stride,rows', [
    ((12, 16, 16, 2), 6, 3), ((12, 16, 16, 2), 8, 5)])
def test_unsupported_shapes_raise(shape, stride, rows):
    with pytest.raises(ValueError):
        csg.check_supported(shape, stride, rows)


def test_bytes_moved_flagship():
    """0.70 GB of f32 cotangents plus the 248x248x64 tile read and written."""
    assert csg.bytes_moved((529, 72, 72, 32, 2), 8, 23, 4) == pytest.approx(
        0.7335e9, rel=1e-3)
