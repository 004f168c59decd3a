"""K6, one grid row's scatter-add (``ops/cuda_scatter_grid.py``,
``csrc/rowgrid_scatter.cu``), against the JAX package on the same numpy
inputs, and K6's launch plan.

On the CPU ``scatter_rowgrid_add_kernel`` runs its plain version; both are
held to ``scatter_rowgrid_add_pallas`` (interpret mode) and the JAX
package's ``patches.scatter_rowgrid_add`` at the layouts the band step
gives K6: sparse slices' patch-major rows and the immediate delta_beta
step's z-major gradient, f32 and bf16 into an f32 accumulator.  The plan
(its key, the instantiation and layout it picks, its reuse) is plain
Python and is tested here; the kernel itself is tested on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adorym_tpu.ops import pallas_scatter_grid as psg
from adorym_tpu.ops import patches as jpatches
from adorym_tpu_torch.ops import cuda_scatter_grid as csg


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors (several test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: (name, patch-major shape of one row, stride, z-major, dtype): 8e's
#: layout cut to 5 patches of 16^2 (C = 4), and the immediate step's
#: z-major gradient [8, 2, 7, 24, 24] viewed as [7, 24, 24, 8, 2].
ROWS = [('sparse', (5, 16, 16, 2, 2), 8, False, jnp.float32),
        ('zmajor-f32', (7, 24, 24, 8, 2), 8, True, jnp.float32),
        ('zmajor-bf16', (7, 24, 24, 8, 2), 8, True, jnp.bfloat16)]


def _row(shape, zmajor, dtype, seed=21):
    """The row's cotangents as numpy f32 (rounded to ``dtype``) and as the
    torch tensor the band step would pass (z-major: a view of contiguous
    ``[*tr, N, py, px]`` memory)."""
    rng = np.random.default_rng(seed)
    cot = np.array(jnp.asarray(rng.normal(size=shape).astype(np.float32))
                   .astype(dtype).astype(jnp.float32))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    cot_t = torch.from_numpy(cot).to(tdtype)
    if zmajor:
        cot_t = cot_t.permute(3, 4, 0, 1, 2).contiguous().permute(
            2, 3, 4, 0, 1)
        assert csg._channel_major(cot_t)
    return cot, cot_t


@pytest.mark.parametrize('y0,x0', [(0, 0), (3, 5)])
@pytest.mark.parametrize('name,shape,s,zmajor,dtype', ROWS,
                         ids=[r[0] for r in ROWS])
def test_rowgrid_matches_pallas_and_xla(name, shape, s, zmajor, dtype, y0,
                                        x0):
    """K6's wrapper (its plain version on the CPU) and the plain version
    against ``scatter_rowgrid_add_pallas`` (interpret mode) and the JAX
    package's ``scatter_rowgrid_add``, in place, at the origin and off
    it."""
    cot, cot_t = _row(shape, zmajor, dtype)
    n, py, px = shape[:3]
    trail = shape[3:]
    acc = np.random.default_rng(22).normal(
        size=(py + 4, (n - 1) * s + px + 9) + trail).astype(np.float32)
    cot_j = jnp.asarray(cot).astype(dtype)
    want_p = np.asarray(psg.scatter_rowgrid_add_pallas(
        jnp.asarray(acc), cot_j, y0, x0, s, interpret=True))
    want_x = np.asarray(jpatches.scatter_rowgrid_add(
        jnp.asarray(acc), cot_j, y0, x0, s))
    for fn in (csg.scatter_rowgrid_add_kernel, csg.scatter_rowgrid_add):
        acc_t = torch.from_numpy(acc.copy())
        got = fn(acc_t, cot_t, y0, x0, s)
        assert got.data_ptr() == acc_t.data_ptr(), 'must update in place'
        assert got.dtype == torch.float32
        # The same f32 values (bf16 widened exactly), <= px/s terms, other
        # orders.
        np.testing.assert_allclose(got.numpy(), want_p, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_x, rtol=1e-6, atol=1e-5)


def _zmajor(dtype=torch.float32):
    return torch.zeros((8, 2, 7, 24, 24), dtype=dtype).permute(2, 3, 4, 0, 1)


def _misaligned_acc(shape):
    """A contiguous f32 accumulator 4 bytes off a 16-byte boundary."""
    flat = torch.zeros(int(np.prod(shape)) + 1)
    acc = flat[1:].view(shape)
    assert acc.data_ptr() % 16 == 4
    return acc


#: (case, cot, acc, stride, vec asked for, (layout, vec, route, kind)).
PLAN_CASES = [
    ('zmajor-f32', _zmajor(), torch.zeros((24, 80, 8, 2)), 8, None,
     ('channel', 4, 'vec', 6)),
    ('zmajor-bf16', _zmajor(torch.bfloat16), torch.zeros((24, 80, 8, 2)), 8,
     None, ('channel', 8, 'vec', 7)),
    # 8 bf16 X a vector do not divide stride 4.
    ('zmajor-bf16-stride4', _zmajor(torch.bfloat16),
     torch.zeros((24, 60, 8, 2)), 4, None, ('channel', 1, 'scalar', 3)),
    ('zmajor-f32-scalar', _zmajor(), torch.zeros((24, 80, 8, 2)), 8, 1,
     ('channel', 1, 'scalar', 2)),
    ('sparse', torch.zeros((5, 16, 16, 2, 2)), torch.zeros((16, 50, 2, 2)),
     8, None, ('patch', 4, 'vec', 4)),
    # 4 bf16 channels: not the 8 of a vector.
    ('sparse-bf16', torch.zeros((5, 16, 16, 2, 2), dtype=torch.bfloat16),
     torch.zeros((16, 50, 2, 2)), 8, None, ('patch', 1, 'scalar', 1)),
    ('real_imag', torch.zeros((3, 16, 16, 256, 2)),
     torch.zeros((16, 40, 256, 2)), 8, None, ('patch', 4, 'vec', 4)),
    ('odd-site', torch.zeros((3, 16, 16, 3)), torch.zeros((16, 40, 3)), 8,
     None, ('patch', 1, 'scalar', 0)),
    ('misaligned-acc', torch.zeros((5, 16, 16, 2, 2)),
     _misaligned_acc((16, 50, 2, 2)), 8, None, ('patch', 1, 'scalar', 0)),
    ('other-view', torch.zeros((5, 16, 16, 2, 2)).transpose(1, 2), torch.zeros(
        (16, 50, 2, 2)), 8, None, ('copy', 4, 'vec', 4)),
]


@pytest.mark.parametrize('case,cot,acc,s,vec,want', PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_rowgrid_plan_instantiation(case, cot, acc, s, vec, want):
    """The plan's layout and instantiation by layout, dtype, channel count,
    stride and alignment: the vector one (16 bytes a thread) where the
    vector divides the stride (channel-major) or the site (patch-major),
    the site is a whole number of the accumulator's 16-byte words and both
    pointers are 16-byte aligned; the scalar one otherwise, or when asked
    for."""
    plan = csg.rowgrid_plan(acc, cot, s, vec)
    assert (plan.layout, plan.vec, plan.route, plan.kind) == want
    n, py, px = cot.shape[:3]
    row = plan.row
    assert (row.N, row.py, row.px, row.stride, row.Xa) == (
        n, py, px, s, acc.shape[1])
    assert row.C == int(np.prod(cot.shape[3:]))
    assert (plan.y_max, plan.x_max) == (acc.shape[0] - py,
                                        acc.shape[1] - (n - 1) * s - px)


def test_rowgrid_plan_is_reused():
    """A second call with other tensors of the same key reuses the plan;
    another alignment, stride or instantiation is another key."""
    acc, cot = torch.zeros((24, 80, 8, 2)), _zmajor()
    key = csg.rowgrid_key(acc, cot, 8)
    assert key == (cot.shape, cot.stride(), torch.float32, acc.shape,
                   acc.stride(), torch.float32, 8, True, None)
    plan = csg.rowgrid_plan(acc, cot, 8)
    assert csg.rowgrid_plan(acc.clone(), _zmajor(), 8) is plan
    assert csg._ROWGRID_PLANS[key] is plan
    assert csg.rowgrid_plan(acc, cot, 8, 1) is not plan
    assert csg.rowgrid_plan(torch.zeros((24, 60, 8, 2)), cot, 4) is not plan
    off = _misaligned_acc((24, 80, 8, 2))
    assert csg.rowgrid_key(off, cot, 8)[7] is False
    assert csg.rowgrid_plan(off, cot, 8).route == 'scalar'
    assert csg.K6.source == 'rowgrid_scatter.cu'


@pytest.mark.parametrize('cot,acc,s,vec,err', [
    (torch.zeros((5, 16, 16, 4)), torch.zeros((16, 50, 4),
                                              dtype=torch.bfloat16), 8, None,
     ValueError),
    (torch.zeros((5, 16, 16, 4), dtype=torch.float64),
     torch.zeros((16, 50, 4)), 8, None, TypeError),
    (torch.zeros((5, 16, 16, 4)), torch.zeros((16, 50, 2, 2)), 8, None,
     ValueError),
    (torch.zeros((5, 16, 16, 4)), torch.zeros((16, 40, 4)), 8, None,
     ValueError),
    (torch.zeros((5, 16, 16, 4)), torch.zeros((16, 60, 4)), 6, None,
     ValueError),
    (torch.zeros((5, 16, 16, 4)), torch.zeros((16, 50, 4)), 8, 2,
     ValueError)], ids=['acc-bf16', 'cot-f64', 'trailing', 'tile-leaves',
                        'stride', 'width'])
def test_rowgrid_plan_rejects(cot, acc, s, vec, err):
    """What K6 does not take raises when its plan is made: an accumulator
    that is not contiguous f32, cotangents that are not f32 or bf16,
    trailing dims that differ, a tile larger than the accumulator, a
    stride that does not divide the patch, a vector width other than the
    widest or 1."""
    with pytest.raises(err):
        csg.rowgrid_plan(acc, cot, s, vec)
