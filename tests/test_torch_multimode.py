"""The multi-mode-probe slice: the invertible delta/beta multislice (K4),
K1 past two probe modes, the stored/invertible switch, and the per-angle
epoch with three refined probe modes, each against the JAX package on the
same numpy inputs.

The JAX package's Pallas kernels run in interpret mode; the port runs the
kernels' plain versions on the CPU.  Gradients are compared on real
parameters (db, and the wave as a real pair), where PyTorch's and JAX's
complex conventions agree.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import adorym_tpu.config as jcfg
import adorym_tpu.utils.profiling as jprof
from adorym_tpu.ops import pallas_multislice as pm
from adorym_tpu.ops import propagate as jprop
from adorym_tpu.recon import Reconstructor as JaxReconstructor
import adorym_tpu_torch as pt
from adorym_tpu_torch.ops import cuda_multislice as cm
from adorym_tpu_torch.ops import propagate as tprop
import adorym_tpu_torch.utils.profiling as tprof

K1, S_SIGN, LMBDA = 25.0, 1.0, 0.1

#: Far fields folded into the last step: none, Fraunhofer unnormalised and
#: 'ortho', and a finite Fresnel distance (1e-4 cm at 1 nm voxels).
FAR = {'none': None, 'fraunhofer': ('inf', False), 'ortho': ('inf', True),
       'fresnel': (1e-4, False)}


def _inputs(S, M, N, ny, nx, seed=0):
    """Physical absorption: k1 b up to 0.025 per step."""
    rng = np.random.default_rng(seed)
    db = np.stack([rng.uniform(0, 1e-2, (S, N, ny, nx)),
                   rng.uniform(0, 1e-3, (S, N, ny, nx))], 1).astype(np.float32)
    wpair = (rng.normal(size=(M, N, ny, nx, 2)) * 0.5).astype(np.float32)
    cot = rng.normal(size=(M, N, ny, nx, 2)).astype(np.float32)
    return db, wpair, cot


def _far_mats(mod, far, ny, nx):
    if FAR[far] is None:
        return (None,) * 4
    fp, norm = FAR[far]
    return tuple(mod.final_prop_mats((ny, nx), (1.0, 1.0), LMBDA, fp,
                                     normalize_fft=norm))


def _jax(fn, db, wpair, cot, far, dtype, invertible):
    ny, nx = db.shape[-2:]
    h = jprop.fresnel_kernel((ny, nx), (1.0, 1.0, 1.0), LMBDA, 20.0)
    fm = _far_mats(jprop, far, ny, nx)
    fm = fm if invertible else fm[:2]

    def f(db, wp):
        wave = (wp[..., 0] + 1j * wp[..., 1]).astype(jnp.complex64)
        out = fn(db, wave, h, K1, S_SIGN, True, False, *fm)
        return jnp.sum(jnp.real(out) * cot[..., 0]
                       + jnp.imag(out) * cot[..., 1]), out

    (_, out), (gdb, gw) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(db, dtype), jnp.asarray(wpair))
    return (np.asarray(out), np.asarray(gdb.astype(jnp.float32)),
            np.asarray(gw))


def _torch(fn, db, wpair, cot, far, dtype, invertible):
    ny, nx = db.shape[-2:]
    h = tprop.fresnel_kernel((ny, nx), (1.0, 1.0, 1.0), LMBDA, 20.0)
    fm = _far_mats(tprop, far, ny, nx)
    fm = fm if invertible else fm[:2]
    db_t = torch.from_numpy(db).to(dtype).requires_grad_()
    wp = torch.from_numpy(wpair).requires_grad_()
    out = fn(db_t, torch.view_as_complex(wp), h, K1, S_SIGN, *fm)
    c = torch.from_numpy(cot)
    gdb, gw = torch.autograd.grad(
        (out.real * c[..., 0] + out.imag * c[..., 1]).sum(), (db_t, wp))
    assert gdb.dtype == dtype
    return out.detach().numpy(), gdb.float().numpy(), gw.numpy()


def _rel(a, b):
    """Max error relative to the largest reference magnitude."""
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _bf16_ulps(a, b):
    """Max error in bf16 ulps of the largest reference magnitude."""
    ulp = 2.0 ** (np.floor(np.log2(np.max(np.abs(b)))) - 7)
    return float(np.max(np.abs(a - b)) / ulp)


# -- K4: the invertible multislice ------------------------------------------

# Each probe-mode count, step count, plane shape, far field and storage
# type appears; the interpret-mode Pallas kernel costs seconds a case.
K4_CASES = [
    (1, 4, (16, 16), 'none', torch.float32),
    (2, 6, (12, 20), 'fraunhofer', torch.float32),
    (3, 4, (16, 16), 'ortho', torch.float32),
    (3, 6, (12, 20), 'fresnel', torch.float32),
    (2, 4, (16, 16), 'fresnel', torch.bfloat16),
    (3, 6, (12, 20), 'fraunhofer', torch.bfloat16),
    (1, 6, (12, 20), 'ortho', torch.bfloat16),
    (2, 4, (16, 16), 'none', torch.bfloat16),
]


@pytest.mark.parametrize('M,S,plane,far,dtype', K4_CASES)
def test_k4_plain_matches_pallas(M, S, plane, far, dtype):
    """The forward and both gradients to 1e-5 of the largest value; in
    bf16 the gradient on db, rounded once to bf16 by each, to 2 bf16 ulps
    of the largest value."""
    db, wpair, cot = _inputs(S, M, 3, *plane, seed=M + S)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    o_j, gdb_j, gw_j = _jax(pm.multislice_db_packed, db, wpair, cot, far,
                            jdt, True)
    o_t, gdb_t, gw_t = _torch(cm.multislice_db_packed, db, wpair, cot, far,
                              dtype, True)
    assert _rel(o_t, o_j) < 1e-5
    assert _rel(gw_t, gw_j) < 1e-5
    if dtype == torch.float32:
        assert _rel(gdb_t, gdb_j) < 1e-5
    else:
        assert _bf16_ulps(gdb_t, gdb_j) <= 2


@pytest.mark.parametrize('far', sorted(FAR))
@pytest.mark.parametrize('M', [1, 3])
def test_k4_plain_backward_matches_autograd(M, far):
    """The rebuilt-wave backward against autograd through the stored
    version's op-by-op steps, at 1e-5 of the largest value: the
    rebuilding loses nothing at physical absorption."""
    db, wpair, cot = _inputs(6, M, 4, 12, 20, seed=7)
    o_i, gdb_i, gw_i = _torch(cm.multislice_db_packed, db, wpair, cot, far,
                              torch.float32, True)
    o_s, gdb_s, gw_s = _torch(cm.multislice_db_stored_plain, db, wpair, cot,
                              far, torch.float32, False)
    np.testing.assert_array_equal(o_i, o_s)
    assert _rel(gdb_i, gdb_s) < 1e-5
    assert _rel(gw_i, gw_s) < 1e-5


def test_k4_needs_the_inverse_far_field():
    db, wpair, _ = _inputs(2, 1, 2, 8, 8)
    h = tprop.fresnel_kernel((8, 8), (1.0, 1.0, 1.0), LMBDA, 20.0)
    fay, fax = _far_mats(tprop, 'fraunhofer', 8, 8)[:2]
    with pytest.raises(ValueError, match='exact inverses'):
        cm.multislice_db_packed(torch.from_numpy(db),
                                torch.view_as_complex(torch.from_numpy(wpair)),
                                h, K1, S_SIGN, fay, fax)


@pytest.mark.parametrize('M', [3, 5])
def test_k1_plain_matches_pallas_past_two_modes(M):
    """K1's plain version at the mode counts its kernel now takes, with the
    Fraunhofer far field: forward to 1e-5, gradients to 1e-4 (the bound
    of ``test_torch_multislice.py``'s M <= 2 cases)."""
    db, wpair, cot = _inputs(4, M, 3, 16, 16, seed=M)
    o_j, gdb_j, gw_j = _jax(pm.multislice_db_stored_packed, db, wpair, cot,
                            'fraunhofer', jnp.float32, False)
    o_t, gdb_t, gw_t = _torch(cm.multislice_db_stored_packed, db, wpair, cot,
                              'fraunhofer', torch.float32, False)
    assert _rel(o_t, o_j) < 1e-5
    assert _rel(gdb_t, gdb_j) < 1e-4
    assert _rel(gw_t, gw_j) < 1e-4


def test_k4_bound_counts():
    """The multi-mode chunk (S=256, M=3, N=529, 72x72, f32): K4f 285
    GFLOP against 5.75 GB, K4b 582 GFLOP against 11.4 GB; at 67 TFLOP/s
    and 3.35 TB/s both are bound by operations.  The backward block holds
    three planes and the mats, 207 KB."""
    args = (256, 3, 529, 72, 72)
    f_fwd = cm.flops(*args)
    f_bwd = cm.flops(*args, backward=True, invertible=True)
    b_fwd = cm.bytes_moved(*args, 4, records=False)
    b_bwd = cm.bytes_moved(*args, 4, backward=True, records=False)
    assert f_fwd == pytest.approx(284.7e9, rel=1e-3)
    assert f_bwd == pytest.approx(582.1e9, rel=1e-3)
    assert b_fwd == pytest.approx(5.75e9, rel=1e-3)
    assert b_bwd == pytest.approx(11.43e9, rel=1e-3)
    assert f_fwd / 67e12 > b_fwd / 3.35e12
    assert f_bwd / 67e12 > b_bwd / 3.35e12
    assert cm.smem_bytes(72, 72, 3, kernel='K4') == 207360 <= (
        cm.MAX_SMEM_BYTES)


def test_k4_slice_cotangent_from_the_modulated_wave():
    """K4b's FFT route forms the slice's cotangent at M = 5 as sum_m a_m v_m,
    from the wave v before its division by t: (sum_m a_m w_m) t with w = v
    (1/t), to f32 rounding (each side within a few f32 ulps of the float64
    product), at physical absorption and at k1 b = 1."""
    rng = np.random.default_rng(3)
    shape = (5, 7, 72, 72)

    def cplx():
        return torch.complex(*(torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)) for _ in range(2)))

    for hi in (1e-3, 4e-2):
        db = torch.from_numpy(np.stack([
            rng.uniform(0, 1e-2, shape[1:]),
            rng.uniform(0, hi, shape[1:])]).astype(np.float32))
        a, v = cplx(), cplx()
        t, t_inv = cm._modulator_and_inverse(db, K1, S_SIGN)
        new = (a * v).sum(0)
        old = (a * (v * t_inv)).sum(0) * t
        truth = (a.to(torch.complex128) * v.to(torch.complex128)).sum(0)
        top = float(truth.abs().max())
        ulp = float(np.spacing(np.float32(top)))
        assert float((new - old).abs().max()) < 8 * ulp
        assert float((new - truth).abs().max()) < 4 * ulp
        assert float((old - truth).abs().max()) < 8 * ulp


# -- the stored/invertible switch -------------------------------------------

def _propagate_both(mod, fused, delta, beta, wave, tgt, final):
    fp = {'free_prop_cm': 'inf', 'normalize_fft': False} if final else None
    if mod is jprop:
        def loss(d, b, w):
            o = jprop.multislice_propagate(d, b, w, 5000.0, 1e-7, binning=2,
                                           fused=fused, final_prop=fp)
            return jnp.mean((jnp.abs(o) - tgt) ** 2), o

        (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
            jnp.asarray(delta), jnp.asarray(beta), jnp.asarray(wave))
        return [np.asarray(o)] + [np.asarray(x) for x in g]
    d, b, w = (torch.from_numpy(x).requires_grad_()
               for x in (delta, beta, wave))
    o = tprop.multislice_propagate(d, b, w, 5000.0, 1e-7, binning=2,
                                   fused=fused, final_prop=fp)
    loss = ((o.abs() - torch.from_numpy(tgt)) ** 2).mean()
    return [o.detach().numpy()] + [
        x.numpy() for x in torch.autograd.grad(loss, (d, b, w))]


@pytest.mark.parametrize('final', [False, True])
def test_switch_branches_agree_with_jax(monkeypatch, final):
    """``multislice_propagate`` with each branch forced, in both packages:
    JAX's ``DB_STORED_MAX_BYTES`` at -1 (invertible) or 1e18 (stored), the
    port's ``_db_stored_max_bytes`` patched alike.  The port's two branches
    run K4 and K1 (a spy counts them) and agree with JAX's (outputs to
    1e-5, gradients to 1e-4 of the largest value, the bounds of
    ``test_torch_multislice.py``) and with each other (the outputs to
    1e-5, the gradients to 1e-4: f32 noise of two sweeps).  The
    wave's gradient comes back conjugated in PyTorch's convention."""
    rng = np.random.default_rng(3)
    delta = (rng.random((3, 12, 12, 6)) * 1e-3).astype(np.float32)
    beta = (rng.random((3, 12, 12, 6)) * 3e-5).astype(np.float32)
    wave = (rng.random((3, 3, 12, 12))
            + 1j * rng.random((3, 3, 12, 12))).astype(np.complex64)
    tgt = rng.random((3, 3, 12, 12)).astype(np.float32)
    calls = []
    for name in ('multislice_db_packed', 'multislice_db_stored_packed'):
        real = getattr(cm, name)
        monkeypatch.setattr(cm, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    results = {}
    for limit in (-1.0, 1e18):
        monkeypatch.setattr(jprop, 'DB_STORED_MAX_BYTES', limit)
        monkeypatch.setattr(tprop, '_db_stored_max_bytes',
                            lambda _d, _l=limit: _l)
        j = _propagate_both(jprop, True, delta, beta, wave, tgt, final)
        t = _propagate_both(tprop, True, delta, beta, wave, tgt, final)
        t[3] = np.conj(t[3])
        assert _rel(t[0], j[0]) < 1e-5
        for a, b in zip(t[1:], j[1:]):
            assert _rel(a, b) < 1e-4
        results[limit] = t
    assert calls == ['multislice_db_packed', 'multislice_db_stored_packed']
    lo, hi = results[-1.0], results[1e18]
    assert _rel(lo[0], hi[0]) < 1e-5
    for a, b in zip(lo[1:], hi[1:]):
        assert _rel(a, b) < 1e-4


# -- the slice: three refined probe modes -----------------------------------

def _probe_modes(pn=16, seed=11):
    """Three distinct modes: a Gaussian spot and two weaker perturbed
    copies, ``[3, pn, pn, 2]``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:pn, :pn] - (pn - 1) / 2
    spot = np.exp(-(yy ** 2 + xx ** 2) / (2 * 4.0 ** 2))
    modes = []
    for scale in (1.0, 0.4, 0.15):
        re = scale * spot + rng.normal(0, 0.02, spot.shape)
        im = rng.normal(0, 0.02, spot.shape)
        modes.append(np.stack([re, im], -1))
    return np.stack(modes).astype(np.float32)


def _cfg(mod, n=32, pn=16, mb=4, binning=1, fused='on', **train):
    return mod.ReconConfig(
        geometry=mod.Geometry(obj_size=(n, n, n), probe_size=(pn, pn),
                              energy_ev=5000., psize_cm=1e-7,
                              free_prop_cm='inf', binning=binning),
        train=mod.TrainConfig(minibatch_size=mb, optimizer='gd',
                              rotate_out_of_loop=True,
                              update_scheme='per angle', n_probe_modes=3,
                              fused_multislice=fused, **train),
        refine=mod.RefineConfig(optimize_probe=True, probe_optimizer='gd',
                                probe_learning_rate=1e-2))


@pytest.mark.parametrize('branch', ['invertible', 'stored'])
def test_multimode_trajectory_matches_jax(monkeypatch, branch):
    """32^3 object at binning 1 (32 steps), 3 angles, a 4x4 grid of 16^2
    patterns, three distinct probe modes refined alongside the object, GD
    over 3 epochs with ``fused_multislice='on'``.  ``invertible`` forces
    K4 in both packages; ``stored`` leaves the switch alone, which on the
    CPU takes K1 at three modes.  Losses to rtol 1e-5; the object's and
    the probe's total updates to 1e-4 of their largest entries.  The
    object's step keeps the absorption physical (k1 b up to 0.1 per
    slice): at 1e-3 beta reaches 0.023, 44% absorption per slice, where
    K4's rebuilt waves carry roundoff grown by exp(k1 b) per step and the
    object's update differs by 3e-4."""
    if branch == 'invertible':
        monkeypatch.setattr(jprop, 'DB_STORED_MAX_BYTES', -1.0)
        monkeypatch.setattr(tprop, '_db_stored_max_bytes', lambda _d: -1.0)
    calls = []
    for name in ('multislice_db_packed', 'multislice_db_stored_packed'):
        real = getattr(cm, name)
        monkeypatch.setattr(cm, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    rng = np.random.default_rng(0)
    xs = np.arange(4) * 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    data = rng.random((3, len(pos), 16, 16)).astype(np.float32)
    theta = np.linspace(0, np.pi, 3, endpoint=False)
    obj0 = (rng.random((32, 32, 32, 2)) * 1e-3).astype(np.float32)
    probe0 = _probe_modes()
    kw = dict(data=data, probe_pos=pos, theta_ls=theta, probe_init=probe0)
    jr = JaxReconstructor(_cfg(jcfg, learning_rate=1e-4),
                          obj_init=obj0.copy(), **kw)
    tr = pt.Reconstructor(_cfg(pt, learning_rate=1e-4), obj_init=obj0.copy(),
                          device='cpu', **kw)
    jl = [jr.run_epoch(e) for e in range(3)]
    tl = [tr.run_epoch(e) for e in range(3)]
    want = ('multislice_db_packed' if branch == 'invertible'
            else 'multislice_db_stored_packed')
    assert calls and set(calls) == {want}
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for name, init in (('obj', obj0), ('probe', probe0)):
        jp = np.asarray(jr.params[name])
        tp = tr.params[name].numpy()
        assert np.max(np.abs(tp - jp)) < 1e-4 * np.max(np.abs(jp - init))


def test_multimode_flagship_chunk_takes_k4(monkeypatch):
    """The flagship geometry at three probe modes and binning 1 (256
    steps, no prebin) on an 85 GB card: both packages' budgets give one
    whole angle per chunk (g = 23), and the chunk's records, 256 x 3 x 529
    x 72^2 x 8 B = 16.8 GB, pass one eighth of the card, so the dispatch
    takes K4."""
    hbm = 85.0e9
    monkeypatch.setattr(jprof, 'hbm_limit_bytes', lambda *a: hbm)
    monkeypatch.setattr(tprof, 'hbm_limit_bytes', lambda *a: hbm)
    monkeypatch.setattr(tprop, 'hbm_limit_bytes', lambda *a: hbm)
    xs = np.arange(23) * 8 - 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    data = np.zeros((1, len(pos), 72, 72), np.float32)
    obj0 = np.zeros((256, 256, 256, 2), np.float32)
    kw = dict(n=256, pn=72, mb=23, binning=1, learning_rate=1e-7)
    jr = JaxReconstructor(_cfg(jcfg, **kw), data=data, probe_pos=pos,
                          obj_init=obj0)
    tr = pt.Reconstructor(_cfg(pt, **kw), data=data, probe_pos=pos,
                          obj_init=obj0, device='cpu')
    assert not tr._prebin and not jr._prebin
    assert (tr._fuse_g, tr._grid_scatter_rows) == (jr._fuse_g,
                                                   jr._grid_scatter_rows)
    assert tr._grid_scatter_rows == 23
    records = 256 * 3 * 23 * 23 * 72 * 72 * 8
    assert records == pytest.approx(16.8e9, rel=3e-3)
    assert records > tprop._db_stored_max_bytes(torch.device('cpu'))
    assert records > jprop._db_stored_max_bytes()
