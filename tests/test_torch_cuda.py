"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it runs on a machine with the card alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from adorym_tpu_torch.ops import cuda_multislice as cm
from adorym_tpu_torch.ops import cuda_multislice_fused as cmf
from adorym_tpu_torch.ops import cuda_scatter_grid as csg
from adorym_tpu_torch.ops import propagate as prop

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _multislice_inputs(S, M, N, ny, nx, dtype, final, dev, seed=0):
    rng = np.random.default_rng(seed)
    db = torch.from_numpy(rng.uniform(0, 0.02, (S, 2, N, ny, nx))
                          .astype(np.float32)).to(dev, dtype)
    w = (rng.normal(size=(M, N, ny, nx, 2)) * 0.5).astype(np.float32)
    wave = torch.view_as_complex(torch.from_numpy(w)).to(dev)
    h = prop.fresnel_kernel((ny, nx), (1.0, 1.0, 1.0), 0.1, 20.0,
                            device=dev)
    fmats = (prop.final_prop_mats((ny, nx), (1.0, 1.0), 0.1, 'inf',
                                  device=dev)[:2] if final else (None, None))
    g = torch.view_as_complex(torch.from_numpy(
        rng.normal(size=(M, N, ny, nx, 2)).astype(np.float32))).to(dev)
    return db, wave, h, fmats, g


def _run(fn, db, wave, h, fmats, g, k1=25.0, s=1.0):
    db = db.detach().requires_grad_()
    wave = wave.detach().requires_grad_()
    out = fn(db, wave, h, k1, s, *fmats)
    gdb, gw = torch.autograd.grad(out, (db, wave), g)
    return out.detach(), gdb, gw


def _rel(a, b):
    a = torch.view_as_real(a) if a.is_complex() else a.float()
    b = torch.view_as_real(b) if b.is_complex() else b.float()
    return float((a - b).abs().max() / b.abs().max())


#: The route K1 takes at each shape of its card test: the FFT route where
#: both sides split as n1 n2 with 2 <= n1 <= n2 <= 9 (the flagship's 72 =
#: 8 x 9), the dense route elsewhere.
K1_ROUTE = {(16, 16): 'fft', (12, 20): 'fft', (72, 72): 'fft',
            (13, 17): 'dense'}


def _stored_dense(db, wave, h, k1, s, fay=None, fax=None):
    """K1 forced onto its dense route (the folded step mats)."""
    return cm.MultisliceDbStored.apply(
        db, wave, cm.prop_mats(h, fay, fax, route='dense'), k1, s)


# f32: the kernel and cuBLAS sum the 16..72-deep products (or the FFT
# route's transforms) in other orders over up to 32 steps; 1e-4 of the
# largest value holds with 10x margin.  bf16: db is the same bf16 values
# for both, but the kernel's records (and so gdb) round to bf16 where
# autograd keeps f32; gdb is itself bf16.
MULTISLICE_TOLS = [(torch.float32, 1e-4, 1e-4), (torch.bfloat16, 1e-4, 3e-2)]


@pytest.mark.parametrize('dtype,tol_fwd,tol_grad', MULTISLICE_TOLS)
@pytest.mark.parametrize('M', [1, 2, 3, 4, 5])
@pytest.mark.parametrize('final', [False, True])
@pytest.mark.parametrize('shape', [(4, 5, 16, 16), (3, 7, 12, 20),
                                   (3, 4, 72, 72), (3, 4, 13, 17)])
def test_multislice_kernel_matches_plain(cuda, dtype, tol_fwd, tol_grad, M,
                                         final, shape):
    """K1 at one block per (patch, mode), on the route its shape takes;
    from two modes on, the backward's blocks of a patch form a cluster and
    sum the modes in shared memory."""
    S, N, ny, nx = shape
    route = K1_ROUTE[(ny, nx)]
    assert cm.k1_route(ny, nx) == route
    args = _multislice_inputs(S, M, N, ny, nx, dtype, final, cuda)
    r0 = dict(cm.K1_ROUTE_LAUNCHES)
    out_k, gdb_k, gw_k = _run(cm.multislice_db_stored_packed, *args)
    assert {r: cm.K1_ROUTE_LAUNCHES[r] - r0[r] for r in r0} == {
        r: 2 if r == route else 0 for r in r0}
    out_p, gdb_p, gw_p = _run(cm.multislice_db_stored_plain, *args)
    torch.cuda.synchronize()
    assert gdb_k.dtype == dtype
    assert _rel(out_k, out_p) < tol_fwd
    assert _rel(gdb_k, gdb_p) < tol_grad
    assert _rel(gw_k, gw_p) < tol_grad


@pytest.mark.parametrize('dtype,tol_fwd,tol_grad', MULTISLICE_TOLS)
@pytest.mark.parametrize('M', [1, 3])
@pytest.mark.parametrize('final', [False, True])
def test_multislice_dense_route_matches_plain(cuda, dtype, tol_fwd, tol_grad,
                                              M, final):
    """K1's dense route, forced at 72^2 where the shape takes the FFT
    route, to the same tolerances."""
    args = _multislice_inputs(3, M, 4, 72, 72, dtype, final, cuda)
    r0 = dict(cm.K1_ROUTE_LAUNCHES)
    out_k, gdb_k, gw_k = _run(_stored_dense, *args)
    assert {r: cm.K1_ROUTE_LAUNCHES[r] - r0[r] for r in r0} == {
        'dense': 2, 'fft': 0, 'global': 0}
    out_p, gdb_p, gw_p = _run(cm.multislice_db_stored_plain, *args)
    torch.cuda.synchronize()
    assert _rel(out_k, out_p) < tol_fwd
    assert _rel(gdb_k, gdb_p) < tol_grad
    assert _rel(gw_k, gw_p) < tol_grad


def test_multislice_counts_launches(cuda):
    args = _multislice_inputs(3, 1, 4, 16, 16, torch.float32, True, cuda)
    f0, b0 = cm.K1_FWD.launches, cm.K1_BWD.launches
    _run(cm.multislice_db_stored_packed, *args)
    assert (cm.K1_FWD.launches - f0, cm.K1_BWD.launches - b0) == (1, 1)


@pytest.mark.parametrize('fn', [cm.multislice_db_stored_packed,
                                cm.multislice_db_packed])
def test_multislice_rejects_too_many_modes(cuda, fn):
    """Nine modes: more blocks than a portable cluster holds."""
    db, wave, h, _, _ = _multislice_inputs(2, 9, 2, 16, 16, torch.float32,
                                           False, cuda)
    with pytest.raises(ValueError, match='probe modes'):
        fn(db, wave, h, 25.0, 1.0)


@pytest.mark.parametrize('pair,side,M', [('K1', 88, 1), ('K1', 96, 3),
                                         ('K4', 80, 1), ('K4', 96, 3)])
@pytest.mark.parametrize('final', [False, True])
def test_multislice_global_route_matches_plain(cuda, pair, side, M, final):
    """Beyond shared memory (K1's block of two planes and the mats passes
    232,448 bytes from 88x88, K4's backward block of three from 80x80) the
    pairs take the global route, the block's planes in device memory; from
    two modes on the backward's cluster sums the modes from there."""
    fn, plain, routes = {
        'K1': (cm.multislice_db_stored_packed, cm.multislice_db_stored_plain,
               cm.K1_ROUTE_LAUNCHES),
        'K4': (cm.multislice_db_packed, cm.multislice_db_plain,
               cm.K4_ROUTE_LAUNCHES)}[pair]
    assert (cm.k1_route if pair == 'K1' else cm.k4_route)(side, side) == \
        'global'
    db, wave, h, fm, g = _multislice_inputs(3, M, 3, side, side,
                                            torch.float32, final, cuda)
    if pair == 'K4':
        db = db * 0.1   # physical absorption for the rebuilt waves
        fm = (prop.final_prop_mats((side, side), (1.0, 1.0), 0.1, 'inf',
                                   device=cuda) if final
              else (None,) * 4)
    r0 = dict(routes)
    got = _run(fn, db, wave, h, fm, g)
    assert {r: routes[r] - r0[r] for r in r0} == {
        r: 2 if r == 'global' else 0 for r in r0}
    ref = _run(plain, db, wave, h, fm, g)
    torch.cuda.synchronize()
    assert _rel(got[0], ref[0]) < 1e-4
    for a, b in zip(got[1:], ref[1:]):
        assert _rel(a, b) < 1e-3


def test_stored_fft_route_needs_the_split(cuda):
    """13 and 17 are prime: K1's entry point refuses the FFT route there."""
    db, wave, h, _, _ = _multislice_inputs(2, 1, 1, 13, 17, torch.float32,
                                           False, cuda)
    mats = cm.prop_mats(h, route='fft')
    with pytest.raises(RuntimeError, match='k1_fwd launch failed'):
        cm.MultisliceDbStored.apply(db, wave, mats, 25.0, 1.0)


def test_invertible_fft_route_needs_the_split(cuda):
    """13 and 17 are prime: K4's entry point refuses the FFT route there."""
    db, wave, h, _, _ = _multislice_inputs(2, 1, 1, 13, 17, torch.float32,
                                           False, cuda)
    mats = cm.prop_mats(h, route='fft')
    with pytest.raises(RuntimeError, match='k4_fwd launch failed'):
        cm.MultisliceDb.apply(db, wave, mats, 25.0, 1.0)


def _bf16_ulps(a, b):
    """Max error in bf16 ulps of the largest reference magnitude."""
    ref = b.float().abs().max()
    ulp = 2.0 ** (torch.floor(torch.log2(ref)) - 7)
    return float((a.float() - b.float()).abs().max() / ulp)


#: The route K4 takes at each shape of its card test: the FFT route where
#: both sides split as n1 n2 with 2 <= n1 <= n2 <= 9 (the flagship's 72 =
#: 8 x 9), the dense route elsewhere.
K4_ROUTE = {(16, 16): 'fft', (12, 20): 'fft', (72, 72): 'fft',
            (13, 17): 'dense'}


# f32: as for K1.  bf16: db is the same bf16 values for both and neither
# keeps records; each rounds gdb once to bf16 from f32 values that differ
# by the summation order only.
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('M', [1, 2, 3, 5])
@pytest.mark.parametrize('final', [False, True])
@pytest.mark.parametrize('shape', [(4, 5, 16, 16), (3, 7, 12, 20),
                                   (3, 4, 72, 72), (3, 4, 13, 17)])
def test_invertible_kernel_matches_plain(cuda, dtype, M, final, shape):
    """K4 (no records; the backward rebuilds the waves) against its plain
    version, which rebuilds them op by op, and against autograd through
    K1's plain version, on the route its shape takes."""
    S, N, ny, nx = shape
    db, wave, h, fmats, g = _multislice_inputs(S, M, N, ny, nx, dtype, True,
                                               cuda)
    inv = (prop.final_prop_mats((ny, nx), (1.0, 1.0), 0.1, 'inf',
                                device=cuda) if final else (None,) * 4)
    route = K4_ROUTE[(ny, nx)]
    assert cm.k4_route(ny, nx) == route
    f0, b0 = cm.K4_FWD.launches, cm.K4_BWD.launches
    r0 = dict(cm.K4_ROUTE_LAUNCHES)
    out_k, gdb_k, gw_k = _run(cm.multislice_db_packed, db, wave, h, inv, g)
    assert (cm.K4_FWD.launches - f0, cm.K4_BWD.launches - b0) == (1, 1)
    assert {r: cm.K4_ROUTE_LAUNCHES[r] - r0[r] for r in r0} == {
        r: 2 if r == route else 0 for r in r0}
    out_p, gdb_p, gw_p = _run(cm.multislice_db_plain, db, wave, h, inv, g)
    out_s, gdb_s, gw_s = _run(cm.multislice_db_stored_plain, db, wave, h,
                              inv[:2], g)
    torch.cuda.synchronize()
    assert gdb_k.dtype == dtype
    assert _rel(out_k, out_p) < 1e-4
    assert _rel(gw_k, gw_p) < 1e-4
    if dtype == torch.float32:
        assert _rel(gdb_k, gdb_p) < 1e-4
        assert _rel(gdb_k, gdb_s) < 1e-4
    else:
        assert _bf16_ulps(gdb_k, gdb_p) <= 2
    assert _rel(gw_k, gw_s) < 1e-4


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('M', [1, 5])
def test_invertible_fft_route_two_forward_blocks_an_sm(cuda, dtype, M):
    """K4 on its FFT route at 72^2 over more blocks than the card holds at
    once (61 patches) and 24 steps, against its plain version at
    test_invertible_kernel_matches_plain's tolerances: the forward runs two
    blocks an SM, each stepping its plane through a scratch plane, and the
    backward one (at M = 5 in clusters of five), as the resident-blocks
    counter reads."""
    S, N, n = 24, 61, 72
    db, wave, h, _, g = _multislice_inputs(S, M, N, n, n, dtype, True, cuda,
                                           seed=7)
    db = db * 0.1   # physical absorption for the rebuilt waves
    inv = prop.final_prop_mats((n, n), (1.0, 1.0), 0.1, 'inf', device=cuda)
    assert cm.k4_route(n, n) == 'fft'
    out_k, gdb_k, gw_k = _run(cm.multislice_db_packed, db, wave, h, inv, g)
    out_p, gdb_p, gw_p = _run(cm.multislice_db_plain, db, wave, h, inv, g)
    torch.cuda.synchronize()
    assert _rel(out_k, out_p) < 1e-4
    assert _rel(gw_k, gw_p) < 1e-4
    if dtype == torch.float32:
        assert _rel(gdb_k, gdb_p) < 1e-4
    else:
        assert _bf16_ulps(gdb_k, gdb_p) <= 2
    tag = str(dtype).rsplit('.', 1)[-1]
    assert cm.K4_BLOCKS_PER_SM[f'K4f.fft.{tag}.M{M}.72x72'] == 2
    assert 0 < cm.K4_BLOCKS_PER_SM[f'K4b.fft.{tag}.M{M}.72x72'] <= 1


@pytest.mark.parametrize('channel_major', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rows,cols,py,px,s,trail', [
    (3, 4, 8, 8, 4, (3, 2)), (5, 2, 12, 8, 4, (2,)), (4, 4, 16, 16, 8, ()),
    (2, 3, 8, 40, 8, (33,))])
def test_grid_scatter_kernel_matches_plain(cuda, dtype, rows, cols, py, px,
                                           s, trail, channel_major):
    """Both memory layouts the kernel reads in place: contiguous
    ``[N, py, px, *tr]`` and a view of ``[*tr, N, py, px]``; the last case
    spans two 32-wide blocks in X and in channels."""
    rng = np.random.default_rng(1)
    cot = rng.normal(size=(rows * cols, py, px) + trail).astype(np.float32)
    if channel_major:
        lead = tuple(range(3, cot.ndim))
        cot = torch.from_numpy(np.moveaxis(cot, lead, range(len(lead))).copy())
        cot = cot.to(cuda, dtype).movedim(tuple(range(len(lead))), lead)
        assert csg._channel_major(cot) == bool(trail)
    else:
        cot = torch.from_numpy(cot).to(cuda, dtype)
    ty, tx = csg.tile_shape(cot.shape, s, rows)
    acc0 = torch.from_numpy(rng.normal(size=(ty + 5, tx + 3) + trail)
                            .astype(np.float32)).to(cuda)
    n0 = csg.K2.launches
    got = csg.scatter_grid2d_add(acc0.clone(), cot, 2, 1, s, rows)
    assert csg.K2.launches == n0 + 1
    ref = csg.scatter_grid2d_add_plain(acc0.clone(), cot, 2, 1, s, rows)
    torch.cuda.synchronize()
    # Both sum the same f32 values (bf16 upcast exactly) in other orders.
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def _grid_cot(rows, cols, py, px, trail, dtype, channel_major, dev,
              seed=1):
    rng = np.random.default_rng(seed)
    cot = rng.normal(size=(rows * cols, py, px) + trail).astype(np.float32)
    if not channel_major:
        return torch.from_numpy(cot).to(dev, dtype)
    lead = tuple(range(3, cot.ndim))
    cot = torch.from_numpy(np.moveaxis(cot, lead, range(len(lead))).copy())
    return cot.to(dev, dtype).movedim(tuple(range(len(lead))), lead)


#: K2's vector instantiation at small shapes: (rows, cols, py, px, stride,
#: trail, the elements a thread owns f32 / bf16 channel-major, and
#: patch-major).  Tx = 48 and 40 end inside a block's X values; C = 40 and
#: 72 end inside a block of channels; stride 4 takes 4 f32 along x but not
#: 8 bf16 (C = 8 takes both); Tx = 328 spans two 256-wide windows, and the
#: patches that straddle them.
K2_VEC_CASES = [(3, 5, 16, 16, 8, (20, 2), (4, 8), (4, 8)),
                (2, 3, 24, 24, 8, (36, 2), (4, 8), (4, 8)),
                (3, 4, 8, 8, 4, (4, 2), (4, 1), (4, 8)),
                (2, 40, 16, 16, 8, (4, 2), (4, 8), (4, 8))]


@pytest.mark.parametrize('channel_major', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rows,cols,py,px,s,trail,v_cm,v_pm', K2_VEC_CASES)
def test_grid_scatter_vec_and_scalar_are_bit_equal(cuda, dtype, rows, cols,
                                                   py, px, s, trail, v_cm,
                                                   v_pm, channel_major):
    """The wrapper's instantiation (16 bytes a thread where the shape and
    pointers allow it) and the scalar one, forced, sum the same values in
    the same order: equal bit for bit, and both within 1e-5 of the plain
    version; the launch is counted by instantiation."""
    cot = _grid_cot(rows, cols, py, px, trail, dtype, channel_major, cuda)
    assert csg._channel_major(cot) == channel_major
    ty, tx = csg.tile_shape(cot.shape, s, rows)
    acc0 = torch.from_numpy(np.random.default_rng(2).normal(
        size=(ty + 5, tx + 3) + trail).astype(np.float32)).to(cuda)
    v = (v_cm if channel_major else v_pm)[dtype == torch.bfloat16]
    routes = csg.K2_ROUTE_LAUNCHES
    r0 = dict(routes)
    got = csg.scatter_grid2d_add(acc0.clone(), cot, 2, 1, s, rows)
    got_s = csg._launch_scatter(acc0.clone(), cot, 2, 1, s, rows, vec=1)
    want = {'vec': 1 if v > 1 else 0, 'scalar': 1 if v > 1 else 2}
    assert {r: routes[r] - r0[r] for r in routes} == want
    ref = csg.scatter_grid2d_add_plain(acc0.clone(), cot, 2, 1, s, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, got_s)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_grid_scatter_misaligned_takes_scalar(cuda):
    """A contiguous cotangent that starts 4 bytes off a 16-byte boundary
    takes the scalar instantiation; the vector one, asked for, raises."""
    rows, cols, py, px, s, trail = 2, 3, 16, 16, 8, (4, 2)
    n = rows * cols * py * px * 8
    flat = torch.randn(n + 1, device=cuda)
    cot = flat[1:].view((rows * cols, py, px) + trail)
    acc0 = torch.randn((40, 40) + trail, device=cuda)
    assert csg.vector_width(4, 8, s, False, cot.data_ptr()) == 1
    n0 = csg.K2_ROUTE_LAUNCHES['scalar']
    got = csg.scatter_grid2d_add(acc0.clone(), cot, 0, 0, s, rows)
    assert csg.K2_ROUTE_LAUNCHES['scalar'] == n0 + 1
    ref = csg.scatter_grid2d_add_plain(acc0.clone(), cot, 0, 0, s, rows)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='elements a thread'):
        csg._launch_scatter(acc0.clone(), cot, 0, 0, s, rows, vec=4)


@pytest.mark.parametrize('unknown_type,fresnel_approx,free_prop_cm,bf16', [
    ('delta_beta', True, 'inf', False), ('delta_beta', True, 'inf', True),
    ('real_imag', True, 'inf', False), ('delta_beta', False, 1e-5, False)])
def test_reconstructor_cuda_matches_cpu(cuda, unknown_type, fresnel_approx,
                                        free_prop_cm, bf16):
    """A small per-angle run through the kernels on the card against the
    plain path on the CPU: losses to 1e-4 (f32 noise of DFT matmuls vs
    FFTs; bf16 records round in the kernel only).  Paraxial delta_beta
    runs K1; real_imag (K3) and the non-paraxial transfer function run the
    general K5, once per angle and epoch."""
    import adorym_tpu_torch as pt
    rng = np.random.default_rng(0)
    xs = np.arange(4) * 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    data = rng.random((3, 16, 16, 16)).astype(np.float32)
    obj0 = (rng.random((24, 24, 24, 2)) * 1e-3).astype(np.float32)
    if unknown_type == 'real_imag':
        obj0[..., 0] += 1.0
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(24, 24, 24), probe_size=(16, 16),
                             free_prop_cm=free_prop_cm, binning=2,
                             fresnel_approx=fresnel_approx),
        train=pt.TrainConfig(minibatch_size=4, learning_rate=1e-3,
                             optimizer='gd', update_scheme='per angle',
                             rotate_out_of_loop=True, run_bfloat16=bf16,
                             fused_multislice='on', zmajor_extract='on',
                             unknown_type=unknown_type))
    general = unknown_type == 'real_imag' or not fresnel_approx
    losses = {}
    n0 = cmf.K5_FWD.launches
    for dev in ('cuda', 'cpu'):
        rec = pt.Reconstructor(cfg, data=data, probe_pos=pos,
                               theta_ls=np.linspace(0, np.pi, 3),
                               obj_init=obj0.copy(), device=dev)
        losses[dev] = [rec.run_epoch(e) for e in range(2)]
    assert cmf.K5_FWD.launches - n0 == (6 if general else 0)
    np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=1e-4)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_grid_scatter_wide_zmajor_matches_plain(cuda, dtype):
    """K2 at the multi-mode flagship's width, C = 256 x 2: the z-major
    gradient ``[zb, 2, N, py, px]`` read in place (cut to 3x4 patches of
    16^2)."""
    rng = np.random.default_rng(5)
    zm = torch.from_numpy(rng.normal(size=(256, 2, 12, 16, 16))
                          .astype(np.float32)).to(cuda, dtype)
    cot = zm.permute(2, 3, 4, 0, 1)
    assert csg._channel_major(cot)
    acc0 = torch.from_numpy(rng.normal(size=(40, 48, 256, 2))
                            .astype(np.float32)).to(cuda)
    got = csg.scatter_grid2d_add(acc0.clone(), cot, 4, 2, 8, 3)
    ref = csg.scatter_grid2d_add_plain(acc0.clone(), cot, 4, 2, 8, 3)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_rowgrid_scatter_kernel_matches_plain(cuda):
    """K6: one grid row through its own kernel, counted apart from K2."""
    rng = np.random.default_rng(6)
    cot = torch.from_numpy(rng.normal(size=(5, 16, 16, 4, 2))
                           .astype(np.float32)).to(cuda)
    acc0 = torch.from_numpy(rng.normal(size=(20, 60, 4, 2))
                            .astype(np.float32)).to(cuda)
    n6, n2 = csg.K6.launches, csg.K2.launches
    got = csg.scatter_rowgrid_add_kernel(acc0.clone(), cot, 3, 2, 8)
    assert (csg.K6.launches - n6, csg.K2.launches - n2) == (1, 0)
    ref = csg.scatter_rowgrid_add(acc0.clone(), cot, 3, 2, 8)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dtype,tol_fwd,tol_grad', MULTISLICE_TOLS)
def test_multislice_one_grid_row_matches_plain(cuda, dtype, tol_fwd,
                                               tol_grad):
    """K1 at the immediate flagship's shape, one grid row a launch: N = 23
    patches of 72^2 over 32 binned steps with the far field, on its FFT
    route (23 blocks on 132 SMs)."""
    args = _multislice_inputs(32, 1, 23, 72, 72, dtype, True, cuda)
    r0 = dict(cm.K1_ROUTE_LAUNCHES)
    out_k, gdb_k, gw_k = _run(cm.multislice_db_stored_packed, *args)
    assert {r: cm.K1_ROUTE_LAUNCHES[r] - r0[r] for r in r0} == {
        'fft': 2, 'dense': 0, 'global': 0}
    out_p, gdb_p, gw_p = _run(cm.multislice_db_stored_plain, *args)
    torch.cuda.synchronize()
    assert _rel(out_k, out_p) < tol_fwd
    assert _rel(gdb_k, gdb_p) < tol_grad
    assert _rel(gw_k, gw_p) < tol_grad


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_rowgrid_scatter_zmajor_matches_plain(cuda, dtype):
    """K6 at the immediate path's layout: one grid row's z-major gradient
    ``[zb, 2, N, py, px]`` read in place into a band accumulator ``[py,
    X + pad, zb, 2]`` (cut to 7 patches of 24^2 at stride 8, zb = 8).  Its
    vector instantiation equals its scalar one bit for bit, and both the
    plain version to 1e-5."""
    rng = np.random.default_rng(8)
    zm = torch.from_numpy(rng.normal(size=(8, 2, 7, 24, 24))
                          .astype(np.float32)).to(cuda, dtype)
    cot = zm.permute(2, 3, 4, 0, 1)
    assert csg._channel_major(cot)
    acc0 = torch.from_numpy(rng.normal(size=(24, 90, 8, 2))
                            .astype(np.float32)).to(cuda)
    routes = csg.K6_ROUTE_LAUNCHES
    r0 = dict(routes)
    got = csg.scatter_rowgrid_add_kernel(acc0.clone(), cot, 0, 5, 8)
    got_s = csg._launch_rowgrid(acc0.clone(), cot, 0, 5, 8, vec=1)
    assert {r: routes[r] - r0[r] for r in routes} == {'vec': 1, 'scalar': 1}
    ref = csg.scatter_rowgrid_add(acc0.clone(), cot, 0, 5, 8)
    torch.cuda.synchronize()
    assert torch.equal(got, got_s)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('jitter,unknown_type', [
    (False, 'delta_beta'), (False, 'real_imag'), (True, 'delta_beta')])
def test_immediate_epoch_cuda_matches_cpu(cuda, jitter, unknown_type):
    """A small immediate run on the card against the CPU: the band step
    (K1, or K5 for real_imag, and K6 once per batch) on a row-grid table,
    the generic step (the whole object's rotation through autograd) on a
    jittered one.  Losses to 1e-4."""
    import adorym_tpu_torch as pt
    rng = np.random.default_rng(0)
    xs = np.arange(4) * 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    if jitter:
        pos += rng.integers(-2, 3, pos.shape)
    data = rng.random((3, 16, 16, 16)).astype(np.float32)
    obj0 = (rng.random((24, 24, 24, 2)) * 1e-3).astype(np.float32)
    if unknown_type == 'real_imag':
        obj0[..., 0] += 1.0
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(24, 24, 24), probe_size=(16, 16),
                             free_prop_cm='inf', binning=2),
        train=pt.TrainConfig(minibatch_size=4, learning_rate=1e-3,
                             optimizer='gd', unknown_type=unknown_type))
    losses = {}
    k6 = csg.K6.launches
    for dev in ('cuda', 'cpu'):
        rec = pt.Reconstructor(cfg, data=data, probe_pos=pos,
                               theta_ls=np.linspace(0, np.pi, 3),
                               obj_init=obj0.copy(), device=dev)
        losses[dev] = [rec.run_epoch(e) for e in range(2)]
    assert csg.K6.launches - k6 == (0 if jitter else 24)
    np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=1e-4)


#: K6 at small rows: (patches N, py, px, stride, trail, the elements a
#: thread owns f32 / bf16 channel-major, and patch-major).  Tx = 48 and 72
#: end inside a warp's X values; C = 4 is sparse slices' site (8 bf16
#: channels do not fit it) and C = 36 ends inside a block's 8 channels;
#: C = 6 is not a whole number of 16-byte words (scalar everywhere);
#: Tx = 328 spans three f32 warps' X values; the last case is the
#: flagship's patch at 9 patches.
K6_CASES = [(5, 16, 16, 8, (2, 2), (4, 8), (4, 1)),
            (7, 24, 24, 8, (8, 2), (4, 8), (4, 8)),
            (3, 8, 8, 4, (3, 2), (1, 1), (1, 1)),
            (40, 16, 16, 8, (4, 2), (4, 8), (4, 8)),
            (9, 72, 72, 8, (18, 2), (4, 8), (4, 1))]


def _off16(t):
    """A contiguous copy of ``t`` that starts 4 bytes off a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize('misaligned', [False, True])
@pytest.mark.parametrize('channel_major', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n,py,px,s,trail,v_cm,v_pm', K6_CASES)
def test_rowgrid_kernel_matches_plain_k2_and_scalar(cuda, dtype, n, py, px,
                                                    s, trail, v_cm, v_pm,
                                                    channel_major,
                                                    misaligned):
    """K6 (``csrc/rowgrid_scatter.cu``) in both layouts and dtypes: within
    1e-5 of the plain version, equal bit for bit to K2's kernel at
    ``rows=1`` (K6's route before it had its own; the same sums in the
    same order) and to its own scalar instantiation, forced; an
    accumulator 4 bytes off a 16-byte boundary takes the scalar one."""
    cot = _grid_cot(1, n, py, px, trail, dtype, channel_major, cuda)
    assert csg._channel_major(cot) == channel_major
    acc0 = torch.from_numpy(np.random.default_rng(3).normal(
        size=(py + 4, (n - 1) * s + px + 5) + trail).astype(np.float32)).to(
            cuda)

    def fresh():
        return _off16(acc0) if misaligned else acc0.clone()

    v = 1 if misaligned else (v_cm if channel_major else v_pm)[
        dtype == torch.bfloat16]
    routes = csg.K6_ROUTE_LAUNCHES
    r0, k2 = dict(routes), csg.K2.launches
    got = csg.scatter_rowgrid_add_kernel(fresh(), cot, 2, 3, s)
    got_s = csg._launch_rowgrid(fresh(), cot, 2, 3, s, vec=1)
    assert {r: routes[r] - r0[r] for r in routes} == {
        'vec': 1 if v > 1 else 0, 'scalar': 1 if v > 1 else 2}
    assert csg.rowgrid_plan(fresh(), cot, s).vec == v
    assert csg.K2.launches == k2
    got_k2 = csg.scatter_grid2d_add(fresh(), cot, 2, 3, s, 1)
    ref = csg.scatter_rowgrid_add(acc0.clone(), cot, 2, 3, s)
    torch.cuda.synchronize()
    assert torch.equal(got, got_s)
    assert torch.equal(got, got_k2)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rows,n,py,px,s,zb', [(4, 7, 24, 24, 8, 8),
                                               (3, 5, 16, 16, 8, 4)])
def test_rowgrid_reads_chunk_rows_in_place(cuda, dtype, rows, n, py, px, s,
                                           zb):
    """K6 on the per-angle path's layout: each grid row of a chunk's z-major
    gradient ``[zb, 2, rows*n, py, px]``, sliced along the patches (a
    channel stride of rows*n patches), read in place.  Bit for bit equal
    to the copy route (the row made contiguous, then the patch-major
    kernel) and to K2 at ``rows=1``, its vector instantiation to its
    scalar one, and within 1e-5 of the plain version; no row is copied."""
    rng = np.random.default_rng(12)
    zm = torch.from_numpy(rng.normal(size=(zb, 2, rows * n, py, px))
                          .astype(np.float32)).to(cuda, dtype)
    chunk = zm.permute(2, 3, 4, 0, 1)
    acc0 = torch.from_numpy(rng.normal(
        size=((rows - 1) * s + py + 3, (n - 1) * s + px + 6, zb, 2)).astype(
            np.float32)).to(cuda)
    row_cots = [chunk[r * n:(r + 1) * n] for r in range(rows)]
    assert all(csg.channel_stride(c) == rows * n * py * px for c in row_cots)
    assert not any(csg._channel_major(c) for c in row_cots)

    def by_rows(fn):
        acc = acc0.clone()
        for r, c in enumerate(row_cots):
            fn(acc, c, r * s + 1, 4)
        return acc
    layouts = csg.K6_LAYOUT_LAUNCHES
    l0 = dict(layouts)
    got = by_rows(lambda a, c, y0, x0: csg.scatter_rowgrid_add_kernel(
        a, c, y0, x0, s))
    assert {k: layouts[k] - l0[k] for k in layouts} == {
        'channel': rows, 'patch': 0, 'copy': 0}
    assert csg.rowgrid_plan(acc0, row_cots[1], s).vec > 1
    got_s = by_rows(lambda a, c, y0, x0: csg._launch_rowgrid(
        a, c, y0, x0, s, vec=1))
    copied = by_rows(lambda a, c, y0, x0: csg.scatter_rowgrid_add_kernel(
        a, c.contiguous(), y0, x0, s))
    k2 = by_rows(lambda a, c, y0, x0: csg.scatter_grid2d_add(
        a, c, y0, x0, s, 1))
    ref = by_rows(lambda a, c, y0, x0: csg.scatter_rowgrid_add(
        a, c, y0, x0, s))
    torch.cuda.synchronize()
    assert torch.equal(got, copied)
    assert torch.equal(got, k2)
    assert torch.equal(got, got_s)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_scatter_patches_add_cuda_matches_cpu(cuda, dtype):
    """The any-table scatter on the card (``index_add_``, by atomics)
    against the CPU, overlapping windows and clamped starts included, to
    1e-5 of the largest value: the sums' order differs."""
    from adorym_tpu_torch.ops import patches as patch_ops
    rng = np.random.default_rng(13)
    acc = rng.normal(size=(40, 36, 8, 2)).astype(np.float32)
    pos = np.concatenate([rng.integers(-3, 28, (60, 2)),
                          [[0, 0], [35, 30], [-40, 2]]])
    pat = torch.from_numpy(rng.normal(size=(len(pos), 12, 12, 8, 2)).astype(
        np.float32)).to(dtype)
    want = patch_ops.scatter_patches_add(torch.from_numpy(acc.copy()), pat,
                                         pos)
    got = patch_ops.scatter_patches_add(torch.from_numpy(acc).to(cuda),
                                        pat.to(cuda), pos)
    assert _rel(got.cpu(), want) < 1e-5


def test_per_angle_tables_cuda_match_cpu(cuda):
    """Small per-angle runs on the card against the CPU, GD, losses to
    1e-4: staggered rows (K6 on every chunk row, read in place), a
    jittered table through the whole-object branch and through
    ``patch_grad``, and per-angle tables; K1 one pair a chunk."""
    import adorym_tpu_torch as pt
    rng = np.random.default_rng(1)
    xs = np.arange(4) * 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    grid = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    stag = grid.copy()
    stag[4:8, 1] += 2
    stag[12:16, 1] += 2
    jit = grid + rng.integers(-2, 3, grid.shape)
    per_angle = np.stack([grid + rng.integers(-2, 3, grid.shape)
                          for _ in range(3)])
    data = rng.random((3, 16, 16, 16)).astype(np.float32)
    obj0 = (rng.random((24, 24, 24, 2)) * 1e-3).astype(np.float32)
    for table, kw, k6 in ((stag, {}, 24), (jit, {}, 0),
                          (jit, dict(patch_grad=True), 0),
                          (per_angle, {}, 0)):
        cfg = pt.ReconConfig(
            geometry=pt.Geometry(obj_size=(24, 24, 24), probe_size=(16, 16),
                                 free_prop_cm='inf', binning=2),
            train=pt.TrainConfig(minibatch_size=4, learning_rate=1e-3,
                                 optimizer='gd', update_scheme='per angle',
                                 rotate_out_of_loop=True, **kw))
        losses = {}
        n6, n1 = csg.K6.launches, cm.K1_FWD.launches
        copies = csg.K6_LAYOUT_LAUNCHES['copy']
        for dev in ('cuda', 'cpu'):
            rec = pt.Reconstructor(cfg, data=data, probe_pos=table,
                                   theta_ls=np.linspace(0, np.pi, 3),
                                   obj_init=obj0.copy(), device=dev)
            losses[dev] = [rec.run_epoch(e) for e in range(2)]
        assert csg.K6.launches - n6 == k6
        assert csg.K6_LAYOUT_LAUNCHES['copy'] == copies
        assert cm.K1_FWD.launches - n1 == 6
        np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=1e-4)


def test_rowgrid_rejects_row_outside(cuda):
    """The origin is checked at every call, the shapes once by the plan."""
    cot = torch.zeros((3, 8, 8, 4), device=cuda)
    acc = torch.zeros((10, 30, 4), device=cuda)
    csg.scatter_rowgrid_add_kernel(acc, cot, 2, 6, 4)
    with pytest.raises(ValueError, match='leaves the accumulator'):
        csg.scatter_rowgrid_add_kernel(acc, cot, 3, 0, 4)
    with pytest.raises(ValueError, match='leaves the accumulator'):
        csg.scatter_rowgrid_add_kernel(acc, cot, 0, 15, 4)
    with pytest.raises(ValueError, match='share a CUDA device'):
        csg.scatter_rowgrid_add_kernel(acc, cot.cpu(), 0, 0, 4)


def test_grid_scatter_rejects_tile_outside(cuda):
    cot = torch.zeros((4, 8, 8, 2), device=cuda)
    acc = torch.zeros((10, 10, 2), device=cuda)
    with pytest.raises(ValueError, match='leaves the accumulator'):
        csg.scatter_grid2d_add(acc, cot, 0, 0, 4, 2)


# -- K3 and K5 ---------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rows,cols,py,px,s,trail', [
    (3, 4, 16, 16, 8, (8, 2)), (5, 2, 12, 8, 4, (3, 2)),
    (2, 3, 8, 8, 8, (1, 2)), (4, 4, 16, 16, 4, (33, 2))])
def test_grid_extract_kernel_matches_plain(cuda, dtype, rows, cols, py, px,
                                           s, trail):
    """A pure copy, so exact; the object sites ``(z, 2)`` take 16-, 8- and
    4-byte words."""
    rng = np.random.default_rng(2)
    shape = ((rows - 1) * s + py + 7, (cols - 1) * s + px + 5) + trail
    obj = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        cuda, dtype)
    n0 = csg.K3.launches
    got = csg.extract_grid2d(obj, 3, 2, s, rows, cols, (py, px))
    assert csg.K3.launches == n0 + 1
    ref = csg.extract_grid2d(obj.cpu(), 3, 2, s, rows, cols, (py, px))
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got.cpu(), ref)


def test_grid_extract_rejects_odd_sites(cuda):
    """A bf16 site of 3 values is 6 bytes: no 4-byte word divides it."""
    obj = torch.zeros((24, 24, 3), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match='4-byte words'):
        csg.extract_grid2d(obj, 0, 0, 8, 2, 2, (8, 8))


def _fused_inputs(S, M, N, ny, nx, which, dev, seed=0):
    rng = np.random.default_rng(seed)

    def c(*shape):
        return torch.view_as_complex(torch.from_numpy(
            rng.normal(size=shape + (2,)).astype(np.float32))).to(dev)

    t = 1.0 + 0.1 * c(S, N, ny, nx)
    wave = 0.5 * c(M, N, ny, nx)
    g = c(M, N, ny, nx)
    if which == 'paraxial':
        h = prop.fresnel_kernel((ny, nx), (1.0, 1.0, 1.0), 0.1, 20.0,
                                device=dev)
    else:
        h = prop.fresnel_kernel((ny, nx), (1.0, 1.0, 1.0), 1.6, 3.0,
                                fresnel_approx=False, device=dev)
    return t, wave, h, g


#: The route K5 takes at each shape of its card test: the FFT route where
#: both sides split as n1 n2 with 2 <= n1 <= n2 <= 9 (the real_imag
#: flagship's 72 = 8 x 9; at 81^2 the backward reads its step table through
#: L2), the dense route elsewhere.
K5_ROUTE = {(16, 16): 'fft', (12, 20): 'fft', (8, 8): 'fft', (72, 72): 'fft',
            (81, 81): 'fft', (13, 17): 'dense'}


def _fused_run(fn, t, wave, h, g):
    tt = t.detach().requires_grad_()
    ww = wave.detach().requires_grad_()
    out = fn(tt, ww, h)
    return (out.detach(),) + torch.autograd.grad(out, (tt, ww), g)


# f32 both sides: the kernel's transforms (FFT route) or DFT matmuls
# (dense route) against cuFFT over up to 4 steps of 8..81-point
# transforms; 1e-4 of the largest value.
@pytest.mark.parametrize('which', ['paraxial', 'non_paraxial'])
@pytest.mark.parametrize('M', [1, 2, 3])
@pytest.mark.parametrize('shape', [(4, 5, 16, 16), (3, 7, 12, 20),
                                   (1, 3, 8, 8), (3, 4, 72, 72),
                                   (2, 3, 81, 81), (3, 4, 13, 17)])
def test_fused_kernel_matches_plain(cuda, which, M, shape):
    """Forward and both gradients (t is complex: its gradient is
    conjugated on store) against autograd through the plain version, on
    the route the shape takes; from two modes on, the FFT route's backward
    blocks of a patch form a cluster and sum gt in shared memory."""
    S, N, ny, nx = shape
    route = K5_ROUTE[(ny, nx)]
    assert cmf.k5_route(ny, nx) == route
    t, wave, h, g = _fused_inputs(S, M, N, ny, nx, which, cuda)
    f0, b0 = cmf.K5_FWD.launches, cmf.K5_BWD.launches
    r0 = dict(cmf.K5_ROUTE_LAUNCHES)
    got = _fused_run(cmf.multislice_fused, t, wave, h, g)
    assert (cmf.K5_FWD.launches - f0, cmf.K5_BWD.launches - b0) == (1, 1)
    assert {r: cmf.K5_ROUTE_LAUNCHES[r] - r0[r] for r in r0} == {
        r: 2 if r == route else 0 for r in r0}
    ref = _fused_run(cmf.multislice_fused_plain, t, wave, h, g)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert _rel(a, b) < 1e-4


@pytest.mark.parametrize('M', [1, 3])
def test_fused_dense_route_matches_plain(cuda, M):
    """K5's dense route, forced at 72^2 where the shape takes the FFT
    route, with the non-paraxial transfer function."""
    t, wave, h, g = _fused_inputs(3, M, 4, 72, 72, 'non_paraxial', cuda)
    mats = cmf.step_mats(h, 'dense')
    r0 = dict(cmf.K5_ROUTE_LAUNCHES)
    got = _fused_run(lambda tt, ww, _: cmf.MultisliceFused.apply(tt, ww, mats),
                     t, wave, h, g)
    assert {r: cmf.K5_ROUTE_LAUNCHES[r] - r0[r] for r in r0} == {
        'dense': 2, 'fft': 0, 'global': 0}
    ref = _fused_run(cmf.multislice_fused_plain, t, wave, h, g)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert _rel(a, b) < 1e-4


def test_fused_rejects_too_many_modes(cuda):
    """The FFT route runs one block per mode and sums the modes across a
    cluster: 9 modes pass a portable cluster."""
    t, wave, h, _ = _fused_inputs(2, 9, 2, 72, 72, 'paraxial', cuda)
    with pytest.raises(ValueError, match='probe modes'):
        cmf.multislice_fused(t, wave, h)


@pytest.mark.parametrize('M,side', [(4, 70), (1, 128), (3, 96)])
def test_fused_global_route_matches_plain(cuda, M, side):
    """The dense route holds a patch's M waves in one block: 4 modes at
    70^2 (which does not split), one at 128^2 and three at 96^2 pass its
    shared memory, and the kernels take the global route, the block's
    planes in device memory."""
    assert cmf.k5_route(side, side, M) == 'global'
    t, wave, h, g = _fused_inputs(2, M, 2, side, side, 'non_paraxial', cuda)
    r0 = dict(cmf.K5_ROUTE_LAUNCHES)
    got = _fused_run(cmf.multislice_fused, t, wave, h, g)
    assert {r: cmf.K5_ROUTE_LAUNCHES[r] - r0[r] for r in r0} == {
        'dense': 0, 'fft': 0, 'global': 2}
    ref = _fused_run(cmf.multislice_fused_plain, t, wave, h, g)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert _rel(a, b) < 1e-4


def test_fused_fft_route_needs_the_split(cuda):
    """13 and 17 are prime: K5's entry point refuses the FFT route there."""
    t, wave, h, _ = _fused_inputs(2, 1, 1, 13, 17, 'paraxial', cuda)
    mats = {'route': 'fft', 'fy': None, 'fx': None, 'h': h}
    with pytest.raises(RuntimeError, match='k5_fwd launch failed'):
        cmf.MultisliceFused.apply(t, wave, mats)


@pytest.mark.parametrize('dtype,tol_fwd,tol_grad', MULTISLICE_TOLS)
def test_multislice_one_patch_unfolded_matches_plain(cuda, dtype, tol_fwd,
                                                     tol_grad):
    """K1 at the adhesin configuration's shape: one patch (minibatch 1) of
    64^2 through 64 steps with no far field folded in (``free_prop_cm=0``),
    on its FFT route (64 = 8 x 8): one block on one SM."""
    args = _multislice_inputs(64, 1, 1, 64, 64, dtype, False, cuda, seed=3)
    assert cm.k1_route(64, 64) == 'fft'
    r0 = dict(cm.K1_ROUTE_LAUNCHES)
    out_k, gdb_k, gw_k = _run(cm.multislice_db_stored_packed, *args)
    assert {r: cm.K1_ROUTE_LAUNCHES[r] - r0[r] for r in r0} == {
        'fft': 2, 'dense': 0, 'global': 0}
    out_p, gdb_p, gw_p = _run(cm.multislice_db_stored_plain, *args)
    torch.cuda.synchronize()
    assert _rel(out_k, out_p) < tol_fwd
    assert _rel(gdb_k, gdb_p) < tol_grad
    assert _rel(gw_k, gw_p) < tol_grad


@pytest.mark.parametrize('scheme', ['immediate', 'per angle'])
def test_run_with_regularizers_and_resume_cuda_matches_cpu(cuda, tmp_path,
                                                           scheme):
    """``run()`` with TV and reweighted L1, a cylindrical support with
    shrink-wrap and checkpoints, on the card and on the CPU: losses to
    1e-4.  Then the card's run killed right after its mid-epoch checkpoint
    of epoch 1 and resumed from the folder ends where the uninterrupted
    card run ends (the object to 1e-5 of its largest entry)."""
    import adorym_tpu_torch as pt
    rng = np.random.default_rng(4)
    xs = np.arange(4) * 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    data = rng.random((5, 16, 16, 16)).astype(np.float32)
    obj0 = (rng.random((24, 24, 24, 2)) * 1e-3).astype(np.float32)
    xx, zz = np.meshgrid(np.arange(24) - 11.5, np.arange(24) - 11.5,
                         indexing='ij')
    mask = np.broadcast_to((xx ** 2 + zz ** 2 <= 81)[None],
                           (24, 24, 24)).astype(np.float32)
    per_angle = scheme == 'per angle'
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(24, 24, 24), probe_size=(16, 16),
                             free_prop_cm='inf', binning=2),
        loss=pt.LossConfig(gamma=1e-2, alpha_d=1e-2, alpha_b=1e-3,
                           reweighted_l1=True),
        train=pt.TrainConfig(n_epochs=3, minibatch_size=4,
                             learning_rate=2e-5, optimizer='gd',
                             shrink_cycle=4, shrink_threshold=3e-4,
                             update_scheme=scheme,
                             rotate_out_of_loop=per_angle),
        io=pt.IOConfig(n_batch_per_checkpoint=4 if per_angle else 10))
    kill_at = (1, 8) if per_angle else (1, 10)

    class Killed(Exception):
        pass

    def run(dev, folder, kill=False):
        rec = pt.Reconstructor(cfg, data=data, probe_pos=pos,
                               theta_ls=np.linspace(0, np.pi, 5),
                               obj_init=obj0.copy(), finite_support_mask=mask,
                               output_folder=str(folder), device=dev)
        if kill:
            save = rec.save_checkpoint

            def save_then_die(i_epoch, i_batch):
                save(i_epoch, i_batch)
                if (i_epoch, i_batch) == kill_at:
                    raise Killed
            rec.save_checkpoint = save_then_die
        rec.run()
        return rec

    gpu = run('cuda', tmp_path / 'cuda')
    cpu = run('cpu', tmp_path / 'cpu')
    assert len(gpu.loss_history) == 3
    np.testing.assert_allclose(gpu.loss_history, cpu.loss_history, rtol=1e-4)
    with pytest.raises(Killed):
        run('cuda', tmp_path / 'b', kill=True)
    resumed = run('cuda', tmp_path / 'b')
    ref = gpu.obj
    assert (np.max(np.abs(resumed.obj - ref))
            <= 1e-5 * np.max(np.abs(ref)))
    assert resumed.finite_support_mask.sum() < mask.sum()


@pytest.mark.parametrize('N,folded', [(23, True), (64, False)])
def test_multislice_per_spot_waves_match_plain(cuda, N, folded):
    """K1f/K1b with distinct per-spot waves made by
    ``models.ptychography.shifted_probes`` (each spot's phase ramp on the
    probe's spectrum), with the far field folded in or left out: the
    kernel against the plain version on the real leaves (db, the probe's
    pairs, the shifts), at K1's f32 tolerances."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.models import ptychography as pm
    rng = np.random.default_rng(N)
    S, n = 8, 16
    db = torch.tensor(rng.uniform(0, 0.02, (S, 2, N, n, n)).astype(
        np.float32), device=cuda)
    probe = torch.tensor(rng.normal(size=(1, n, n, 2)).astype(np.float32),
                         device=cuda)
    shifts = torch.tensor(rng.uniform(-1.5, 1.5, (1, N, 2)).astype(
        np.float32), device=cuda)
    g = torch.view_as_complex(torch.tensor(rng.normal(
        size=(1, N, n, n, 2)).astype(np.float32), device=cuda))
    h = prop.fresnel_kernel((n, n), (1.0, 1.0, 1.0), 0.1, 20.0, device=cuda)
    far = (prop.final_prop_mats((n, n), (1.0, 1.0), 0.1, 'inf',
                                device=cuda)[:2] if folded else ())
    cfg = pt.ReconConfig(geometry=pt.Geometry(obj_size=(n, n, S),
                                              probe_size=(n, n)),
                         refine=pt.RefineConfig(optimize_all_probe_pos=True))
    batch = {'i_theta': 0, 'ind_batch': np.arange(N)}

    def run(fn):
        leaves = [t.detach().requires_grad_() for t in (db, probe, shifts)]
        wave = pm.shifted_probes(pm.complex_probe(leaves[1]),
                                 {'probe_pos_correction': leaves[2]}, batch,
                                 cfg).transpose(0, 1)
        out = fn(leaves[0], wave, h, 25.0, 1.0, *far)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, g))

    r0 = dict(cm.K1_ROUTE_LAUNCHES)
    got = run(cm.multislice_db_stored_packed)
    assert cm.K1_ROUTE_LAUNCHES['fft'] - r0['fft'] == 2
    want = run(cm.multislice_db_stored_plain)
    assert _rel(got[0], want[0]) < 1e-4
    for a, b in zip(got[1:], want[1:]):
        assert _rel(a, b) < 1e-3


def test_large_plane_auto_runs_the_global_route(cuda):
    """A 3-D delta_beta multislice on 96^2 planes, which no shared-memory
    route of K1 takes, under ``fused='auto'`` and ``True`` runs K1's global
    route and equals the plain FFT scan within 1e-5."""
    rng = np.random.default_rng(96)
    delta = torch.tensor(rng.random((3, 96, 96, 8)).astype(np.float32)
                         * 1e-3, device=cuda)
    beta = torch.tensor(rng.random((3, 96, 96, 8)).astype(np.float32)
                        * 1e-5, device=cuda)
    wave = torch.ones((1, 3, 96, 96), dtype=torch.complex64, device=cuda)
    kw = dict(energy_ev=5000.0, psize_cm=1e-7, binning=2,
              final_prop={'free_prop_cm': 'inf', 'normalize_fft': False})
    n0 = cm.K1_ROUTE_LAUNCHES['global']
    a = prop.multislice_propagate(delta, beta, wave, fused='auto', **kw)
    on = prop.multislice_propagate(delta, beta, wave, fused=True, **kw)
    assert cm.K1_ROUTE_LAUNCHES['global'] - n0 == 2
    b = prop.multislice_propagate(delta, beta, wave, fused=False, **kw)
    assert _rel(a, b) < 1e-5
    assert torch.equal(a, on)


def test_position_correction_and_multidist_cuda_match_cpu(cuda):
    """A 2-D position-correction run (two refined probe modes) and a
    multi-distance run (distances, affines and shifts refined) on the
    card and on the CPU: 2 GD epochs' losses to 1e-4."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.models import multidist
    rng = np.random.default_rng(11)
    xs = np.arange(4) * 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1) + rng.uniform(-1, 1, (16, 2))
    spot = np.exp(-((np.mgrid[:16, :16] - 7.5) ** 2).sum(0) / 32)
    probe = np.stack([np.stack([w * spot, 0.1 * spot], -1)
                      for w in (1.0, 0.3)]).astype(np.float32)
    obj = np.stack([1 + 1e-2 * rng.random((32, 32, 1)),
                    1e-2 * rng.random((32, 32, 1))], -1).astype(np.float32)
    cases = [
        (pt.ReconConfig(
            geometry=pt.Geometry(obj_size=(32, 32, 1), probe_size=(16, 16),
                                 two_d_mode=True),
            train=pt.TrainConfig(minibatch_size=5, learning_rate=1e-3,
                                 optimizer='gd', unknown_type='real_imag',
                                 n_probe_modes=2),
            refine=pt.RefineConfig(optimize_all_probe_pos=True,
                                   all_probe_pos_optimizer='gd',
                                   all_probe_pos_learning_rate=1.0,
                                   optimize_probe=True, probe_optimizer='gd',
                                   probe_learning_rate=1e-3)),
         dict(data=rng.random((1, 16, 16, 16)).astype(np.float32),
              probe_pos=pos, probe_init=probe, obj_init=obj)),
        (pt.ReconConfig(
            geometry=pt.Geometry(obj_size=(32, 32, 1), probe_size=(32, 32),
                                 energy_ev=17500., psize_cm=1e-5,
                                 free_prop_cm=(0.05, 0.12, 0.3),
                                 n_dists=3, two_d_mode=True,
                                 safe_zone_width=0),
            train=pt.TrainConfig(minibatch_size=1, learning_rate=1e-2,
                                 optimizer='gd', unknown_type='real_imag'),
            refine=pt.RefineConfig(
                optimize_free_prop=True, free_prop_optimizer='gd',
                free_prop_learning_rate=1e-3, optimize_prj_affine=True,
                prj_affine_optimizer='gd', prj_affine_learning_rate=1e-1,
                optimize_all_probe_pos=True, all_probe_pos_optimizer='gd',
                all_probe_pos_learning_rate=1e3)),
         dict(data=1 + 0.1 * rng.random((1, 3, 32, 32)).astype(np.float32),
              probe_pos=np.zeros((1, 2)), obj_init=obj, model=multidist,
              aux_init={'free_prop_cm': np.array([0.053, 0.127, 0.318])}))]
    for cfg, kw in cases:
        losses = {}
        for dev in ('cuda', 'cpu'):
            rec = pt.Reconstructor(cfg, device=dev, **kw)
            losses[dev] = [rec.run_epoch(e) for e in range(2)]
        np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=1e-4)


def _kappa_backprop_inputs(dev, seed=5):
    rng = np.random.default_rng(seed)
    delta = rng.uniform(0, 2e-3, (23, 72, 72, 16)).astype(np.float32)
    beta = rng.uniform(0, 5e-5, delta.shape).astype(np.float32)
    w = rng.normal(size=(1, 23, 72, 72, 2)).astype(np.float32)
    g = rng.normal(size=(1, 23, 72, 72, 2)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (delta, beta)] + [
        torch.view_as_complex(torch.from_numpy(a)).to(dev) for a in (w, g)]


@pytest.mark.parametrize('branch', ['kappa', 'backprop'])
def test_multislice_kappa_and_backprop_kernel_matches_plain(cuda, branch):
    """K1 (FFT route at 72^2, one grid row of 23 patches, binning 2) under
    ``beta = kappa delta`` with a tensor kappa and the far field folded in,
    and under the propagation in -z (the -z step and the flipped modulator
    sign), through ``multislice_propagate``: CUDA against its plain
    version on the CPU; the forward at 1e-4, the gradients in delta,
    beta and kappa at 1e-3."""
    outs = []
    for dev in (cuda, torch.device('cpu')):
        delta, beta, wave, g = _kappa_backprop_inputs(dev)
        delta.requires_grad_()
        beta.requires_grad_()
        kappa = torch.tensor(0.03, device=dev, requires_grad=True)
        kw = dict(binning=2, fused=True)
        if branch == 'kappa':
            kw.update(kappa=kappa,
                      final_prop={'free_prop_cm': 'inf',
                                  'normalize_fft': False})
        else:
            kw.update(backprop=True)
        before = cm.K1_FWD.launches
        out = prop.multislice_propagate(delta, beta, wave, 5000.0, 1e-7,
                                        **kw)
        if dev.type == 'cuda':
            assert cm.K1_FWD.launches == before + 1
        leaves = [delta, kappa] if branch == 'kappa' else [delta, beta]
        grads = torch.autograd.grad(out, leaves, g)
        outs.append([out.detach().cpu()] + [x.cpu() for x in grads])
    assert _rel(outs[0][0], outs[1][0]) < 1e-4
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert _rel(a, b) < 1e-3


@pytest.mark.parametrize('axis', [1, 2])
def test_rotate_other_axes_cuda_matches_cpu(cuda, axis):
    """Rotation about axes 1 and 2 of a non-cubic volume on the card
    against the CPU, with the gradient in the angle (the tilt path)."""
    rng = np.random.default_rng(axis)
    vol = rng.normal(size=(40, 56, 24, 2)).astype(np.float32)
    g = rng.normal(size=vol.shape).astype(np.float32)
    res = []
    for dev in (cuda, torch.device('cpu')):
        from adorym_tpu_torch.ops.rotate import rotate
        th = torch.tensor(0.23, device=dev, requires_grad=True)
        v = torch.from_numpy(vol).to(dev)
        out = rotate(v, th, axis=axis)
        gth, = torch.autograd.grad(out, th, torch.from_numpy(g).to(dev))
        res.append((out.detach().cpu(), float(gth)))
    assert _rel(res[0][0], res[1][0]) < 1e-6
    assert abs(res[0][1] - res[1][1]) <= 1e-4 * abs(res[1][1])


def _dual_tangent(fn, primals, tangents):
    import torch.autograd.forward_ad as fwAD
    with torch.no_grad(), fwAD.dual_level():
        out = fn(*[fwAD.make_dual(p, t) for p, t in zip(primals, tangents)])
        return fwAD.unpack_dual(out).tangent


@pytest.mark.parametrize('final', [False, True])
@pytest.mark.parametrize('shape', [(16, 16), (13, 17)])
def test_k1_jvp_matches_plain_forward_mode(cuda, final, shape):
    """K1's forward-mode rule (the multislice tangent from the kernel's
    records) against forward mode through the plain FFT scan, f32, within
    1e-5 of the largest value, on the FFT and the dense route."""
    from adorym_tpu_torch.ops.fourier import fft2_and_shift
    db, wave, h, fmats, _ = _multislice_inputs(6, 2, 3, *shape,
                                               torch.float32, final, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    ddb = torch.randn(db.shape, generator=gen, device=cuda)
    dwave = torch.complex(torch.randn(wave.shape, generator=gen,
                                      device=cuda),
                          torch.randn(wave.shape, generator=gen,
                                      device=cuda))
    n0 = cm.TANGENT_LAUNCHES['K1']
    got = _dual_tangent(
        lambda d, w: cm.multislice_db_stored_packed(d, w, h, 25.0, 1.0,
                                                    *fmats),
        (db, wave), (ddb, dwave))
    assert cm.TANGENT_LAUNCHES['K1'] == n0 + 1

    def plain(d, w):
        out = cmf.multislice_fused_plain(cm._modulator(d.transpose(0, 1),
                                                       25.0, 1.0), w, h)
        return fft2_and_shift(out) if final else out

    ref = _dual_tangent(plain, (db, wave), (ddb, dwave))
    assert _rel(got, ref) < 1e-5


def test_k5_jvp_matches_plain_forward_mode(cuda):
    """K5's forward-mode rule against forward mode through the plain FFT
    scan (a non-paraxial transfer function), f32, within 1e-5 of the
    largest value."""
    gen = torch.Generator(device=cuda).manual_seed(2)

    def cplx(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device=cuda),
                             torch.randn(shape, generator=gen, device=cuda))

    t = torch.exp(0.1j * torch.randn((6, 3, 16, 16), generator=gen,
                                     device=cuda)).to(torch.complex64)
    dt, wave, dwave = cplx(6, 3, 16, 16), cplx(2, 3, 16, 16), cplx(
        2, 3, 16, 16)
    h = prop.fresnel_kernel((16, 16), (1.0, 1.0, 1.0), 0.1, 20.0,
                            fresnel_approx=False, device=cuda)
    n0 = cm.TANGENT_LAUNCHES['K5']
    got = _dual_tangent(lambda a, w: cmf.multislice_fused(a, w, h),
                        (t, wave), (dt, dwave))
    assert cm.TANGENT_LAUNCHES['K5'] == n0 + 1
    ref = _dual_tangent(lambda a, w: cmf.multislice_fused_plain(a, w, h),
                        (t, wave), (dt, dwave))
    assert _rel(got, ref) < 1e-5


def test_k4_jvp_raises_on_the_card(cuda):
    import torch.autograd.forward_ad as fwAD
    db, wave, h, _, _ = _multislice_inputs(4, 1, 2, 16, 16, torch.float32,
                                           False, cuda)
    with pytest.raises(NotImplementedError, match='B.16'):
        with fwAD.dual_level():
            cm.multislice_db_packed(fwAD.make_dual(db, torch.ones_like(db)),
                                    wave, h, 25.0, 1.0)


def test_epie_cuda_matches_cpu(cuda):
    """ePIE, 3 epochs, on the card against the CPU: object and probe
    within 1e-4 of the largest value."""
    from adorym_tpu_torch import conventional as conv
    rng = np.random.default_rng(3)
    n, p = 40, 16
    obj = np.exp(0.5j * rng.random((n, n))).astype(np.complex64)
    yy, xx = np.mgrid[:p, :p] - (p - 1) / 2
    probe = (np.exp(-(yy ** 2 + xx ** 2) / 30)
             * np.exp(1j * rng.random((p, p)))).astype(np.complex64)
    xs = np.arange(0, n - p + 1, 6)
    gy, gx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([gy.ravel(), gx.ravel()], -1)
    data = np.stack([np.abs(np.fft.fftshift(np.fft.fft2(
        probe * obj[y:y + p, x:x + p]))) for y, x in pos]).astype(np.float32)
    probe0 = (np.exp(-(yy ** 2 + xx ** 2) / 40)
              * np.exp(1j * rng.random((p, p)))).astype(np.complex64)
    res = [conv.epie_reconstruct(data, probe0, pos,
                                 np.ones((n, n), np.complex64), n_epochs=3,
                                 device=d) for d in (cuda, 'cpu')]
    assert res[0][0].is_cuda
    assert _rel(res[0][0].cpu(), res[1][0]) < 1e-4
    assert _rel(res[0][1].cpu(), res[1][1]) < 1e-4


def _second_order_problem(optimizer):
    """The small 3-D delta_beta problem of the second-order card test: a
    24^3 smooth phantom (delta up to 1e-3, beta 3e-5), a 16^2 Gaussian
    probe on a 4x4 grid at stride 4, two angles, binning 2 (K1 on its FFT
    route), minibatch 4 (the immediate scheme); the data simulated by the
    port on the CPU from the phantom, the object starting at half of it."""
    import adorym_tpu_torch as pt
    from scipy.ndimage import gaussian_filter
    from adorym_tpu_torch.utils.initialize import initialize_probe
    rng = np.random.default_rng(0)
    vol = gaussian_filter(rng.random((24, 24, 24)), 3)
    vol = (vol - vol.min()) / np.ptp(vol)
    obj_true = np.stack([vol * 1e-3, vol * 3e-5], -1).astype(np.float32)
    probe = initialize_probe((16, 16), 'gaussian', energy_ev=5000.0,
                             psize_cm=1e-7, probe_mag_sigma=4,
                             probe_phase_sigma=4, probe_phase_max=0.3)
    xs = np.arange(4) * 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    theta = np.linspace(0, np.pi, 2)
    geo = pt.Geometry(obj_size=(24, 24, 24), probe_size=(16, 16),
                      free_prop_cm='inf', binning=2)
    data = pt.simulate(pt.ReconConfig(geometry=geo), obj_true, probe, pos,
                       theta, device='cpu')
    cfg = pt.ReconConfig(geometry=geo, train=pt.TrainConfig(
        minibatch_size=4, optimizer=optimizer))
    return cfg, dict(data=np.asarray(data), probe_pos=pos, theta_ls=theta,
                     probe_init=probe, obj_init=obj_true * 0.5)


@pytest.mark.parametrize('optimizer', ['cg', 'curveball'])
def test_second_order_cuda_matches_cpu(cuda, optimizer):
    """CG and Curveball on a small 3-D delta_beta run (the immediate
    scheme, K1 on its FFT route) on data simulated from a phantom
    (:func:`_second_order_problem`): the per-epoch losses on the card
    within 1e-4 of the CPU's; Curveball's batches run the tangent.  The
    CPU half runs on one intra-op thread, so its reductions repeat bit
    for bit."""
    import adorym_tpu_torch as pt
    cfg, kw = _second_order_problem(optimizer)
    losses = {}
    n0 = cm.TANGENT_LAUNCHES['K1']
    threads = torch.get_num_threads()
    for dev in ('cuda', 'cpu'):
        if dev == 'cpu':
            torch.set_num_threads(1)
        try:
            rec = pt.Reconstructor(cfg, device=dev,
                                   **dict(kw, obj_init=kw['obj_init'].copy()))
            losses[dev] = [rec.run_epoch(e) for e in range(2)]
        finally:
            torch.set_num_threads(threads)
    assert cm.TANGENT_LAUNCHES['K1'] - n0 == (32 if optimizer == 'curveball'
                                              else 0)
    assert np.all(np.isfinite(losses['cpu'])), losses
    np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=1e-4)


def test_curveball_at_k4_sizes_runs_with_fused_off(cuda, monkeypatch):
    """Curveball where K1's records would pass the card's budget (the
    stored/invertible switch forced, as ``tests/test_torch_multimode.py``
    forces it): under ``fused_multislice='auto'`` the batch reaches K4,
    which has no forward mode, and raises naming
    ``fused_multislice='off'``; under ``'off'`` the plain FFT scan takes
    forward mode on the card, launches no multislice kernel and no
    tangent, and its epoch's loss is the CPU's within 1e-4."""
    import adorym_tpu_torch as pt
    cfg, kw = _second_order_problem('curveball')
    monkeypatch.setattr(prop, '_db_stored_max_bytes', lambda device: 0)
    rec = pt.Reconstructor(cfg, device='cuda', **dict(
        kw, obj_init=kw['obj_init'].copy()))
    with pytest.raises(NotImplementedError, match="fused_multislice='off'"):
        rec.run_epoch(0)
    off = cfg.replace(train=dataclasses.replace(cfg.train,
                                                fused_multislice='off'))
    launches = (cm.K4_FWD.launches, cm.K1_FWD.launches,
                dict(cm.TANGENT_LAUNCHES))
    losses = {}
    threads = torch.get_num_threads()
    for dev in ('cuda', 'cpu'):
        if dev == 'cpu':
            torch.set_num_threads(1)
        try:
            rec = pt.Reconstructor(off, device=dev, **dict(
                kw, obj_init=kw['obj_init'].copy()))
            losses[dev] = rec.run_epoch(0)
        finally:
            torch.set_num_threads(threads)
    assert (cm.K4_FWD.launches, cm.K1_FWD.launches,
            dict(cm.TANGENT_LAUNCHES)) == launches
    assert np.isfinite(losses['cuda'])
    np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=1e-4)


def _offload_problem(n=32, nz=16, pn=8, seed=0):
    """``tests/test_torch_offload_object.py``'s problem on the port alone:
    a 32 x 32 x 16 object, an 8^2 Gaussian probe on a 4x4 grid at stride
    8 (one grid row a minibatch), 3 angles, binning 4, data simulated by
    the port on the CPU."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.utils.initialize import initialize_probe
    rng = np.random.default_rng(seed)
    obj_true = np.stack([rng.random((n, n, nz)) * 1e-3,
                         rng.random((n, n, nz)) * 3e-5], -1).astype(np.float32)
    probe = initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                             psize_cm=1e-7, probe_mag_sigma=2,
                             probe_phase_sigma=2, probe_phase_max=0.3)
    xs = np.arange(0, n - pn + 1, 8)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    theta = np.linspace(0, np.pi, 3, endpoint=False)
    geo = pt.Geometry(obj_size=(n, n, nz), probe_size=(pn, pn),
                      energy_ev=5000.0, psize_cm=1e-7, free_prop_cm='inf',
                      binning=4)
    data = pt.simulate(pt.ReconConfig(geometry=geo), obj_true, probe, pos,
                       theta, device='cpu')
    cfg = pt.ReconConfig(geometry=geo, train=pt.TrainConfig(
        minibatch_size=4, learning_rate=1e-6, optimizer='momentum',
        update_scheme='per angle', rotate_out_of_loop=True))
    return cfg, dict(data=np.asarray(data), probe_pos=pos,
                     probe_init=probe, theta_ls=theta,
                     obj_init=obj_true * 0.5)


def test_stager_pins_its_buffers_and_rows_equal_the_cpu(cuda, tmp_path):
    """The host-staged rows: the staging buffers are page-locked, the rows
    reach the card equal to the CPU's bit for bit, from the array and
    through a FastLoader (its gather and its prefetch feed)."""
    from adorym_tpu_torch.io.fastloader import FastLoader
    from adorym_tpu_torch.offload import DataStager, HostArena
    rng = np.random.default_rng(0)
    data = rng.random((3, 20, 8, 8)).astype(np.float32)
    raw = str(tmp_path / 'data.raw')
    data.tofile(raw)
    ld = FastLoader(raw, data.shape, max_batch=8)
    inds = np.array([[3, 17], [0, 9]])
    rows = [(1, np.array([3, 4, 19])), (0, np.arange(5)), (2, np.array([7]))]
    for src, loader in ((data, None), (None, ld)):
        st = DataStager(src, loader, cuda, False, HostArena(cuda))
        got = st.rows(2, inds)
        assert got.is_cuda
        assert all(s.host.is_pinned() for s in st._slots if s.host is not None)
        np.testing.assert_array_equal(got.cpu().numpy(), data[2][inds])
        feed = st.feed(rows)
        for i in range(len(rows)):
            out = feed.take(i)
            feed.ahead(i + 1)
            np.testing.assert_array_equal(out.cpu().numpy(),
                                          data[rows[i][0]][rows[i][1]])
    ld.close()


@pytest.mark.parametrize('offload_object', [False, True])
def test_offload_cuda_matches_cpu(cuda, offload_object):
    """Moments offloaded in 4 slabs, and the object too: 2 epochs on the
    card against the CPU (K1, K2 on the card), losses at rtol 1e-5 and the
    object at 1e-5 of its largest value; the host blocks are page-locked
    and the object's slabs are never on the card."""
    import adorym_tpu_torch as pt
    cfg, kw = _offload_problem()
    cfg = cfg.replace(parallel=pt.ParallelConfig(
        offload_optimizer_state=True, offload_slabs=4,
        offload_object=offload_object))
    out = {}
    for dev in ('cuda', 'cpu'):
        rec = pt.Reconstructor(cfg, device=dev, **kw)
        assert rec._off_slabbed and rec._obj_offloaded == offload_object
        out[dev] = ([rec.run_epoch(e) for e in range(2)], rec.obj, rec)
    rec = out['cuda'][2]
    host = [v for leaf in rec.opt_state['obj'].values() for v in leaf.values()]
    if offload_object:
        host += list(rec.params['obj'].values())
    assert all(t.device.type == 'cpu' and t.is_pinned() for t in host)
    np.testing.assert_allclose(out['cuda'][0], out['cpu'][0], rtol=1e-5)
    ref = out['cpu'][1]
    np.testing.assert_allclose(out['cuda'][1], ref,
                               atol=1e-5 * np.abs(ref).max())


def test_fastloader_batches_reach_the_card(cuda, tmp_path):
    """A FastLoader-backed run on the card (the immediate scheme, each
    batch through the loader's prefetch; the per-angle path, each angle
    through its gather) against the in-memory run on the CPU: losses at
    rtol 1e-5."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.io.fastloader import FastLoader
    cfg, kw = _offload_problem()
    data = kw.pop('data')
    raw = str(tmp_path / 'data.raw')
    data.tofile(raw)
    for scheme in ('immediate', 'per angle'):
        c = cfg.replace(train=dataclasses.replace(
            cfg.train, update_scheme=scheme,
            rotate_out_of_loop=scheme == 'per angle'))
        ld = FastLoader(raw, data.shape, max_batch=16)
        rec = pt.Reconstructor(c, data=ld, device='cuda', **kw)
        got = [rec.run_epoch(e) for e in range(2)]
        assert not rec.stager().resident and rec.stager().staged_rows
        ref = pt.Reconstructor(c, data=data, device='cpu', **kw)
        np.testing.assert_allclose(got, [ref.run_epoch(e) for e in range(2)],
                                   rtol=1e-5)
        ld.close()


def test_run_epochs_cuda_equals_run_epoch(cuda):
    """The pipelined ``run_epochs(3)`` on the card gives three
    ``run_epoch`` calls' losses and object."""
    import adorym_tpu_torch as pt
    cfg, kw = _offload_problem()
    a = pt.Reconstructor(cfg, device='cuda', **kw)
    want = [a.run_epoch(e) for e in range(3)]
    b = pt.Reconstructor(cfg, device='cuda', **kw)
    assert b.run_epochs(3) == want
    np.testing.assert_array_equal(b.obj, a.obj)
