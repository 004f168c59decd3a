"""The port's second-order object optimizers and their forward mode
against the JAX package on the CPU.

- ``make_gvp`` against a dense ``J^T H J`` and against the JAX package's;
  one ``curveball_step`` against JAX's at 1e-5, also at a near-singular
  subspace system (where ``pinv``'s cut-off decides the step); CG's
  Armijo search and ``cg_step`` against JAX's (the same evaluations, the
  results at 1e-5).
- ``Reconstructor`` under ``'cg'`` and ``'curveball'`` against the JAX
  package: first-epoch losses at rtol 1e-5 on a 2-D problem of
  ``tests/test_optimizers.py``'s geometry and on small 3-D ``delta_beta``
  and ``real_imag`` ones (plane-wave probes, random data, objects started
  at a small random value: at a zero object a Gaussian probe's dark
  far-field pixels are f32 noise, see ``tests/test_torch_immediate.py``);
  later epochs loosely (a line-search accept or reject can flip on
  rounding).  ``tests/test_optimizers.py``'s own problem (simulated
  weak-object data, a zero start) only loosely: its batch loss is the
  small difference of large magnitudes, and the packages' forwards
  already part at 1.1e-4 in the first batch's loss, before any update.
- A mid-epoch CG checkpoint resumes equal to the uninterrupted run (and
  from the JAX package's checkpoint); the JAX package's second-order fit
  under ``rotate_out_of_loop`` does not see the view angle, the port's
  equals the JAX package's with the rotation in the loop.
- The forward-mode rules: ``_SafeSqrt``'s, ``BinRealImag``'s, the
  multislice tangent shared by K1 and K5 from the plain versions' records
  (against forward mode through the plain scans and ``jax.jvp`` of the
  JAX package's plain ``multislice_propagate``), and K4's, which raises.
- The scipy bridge: ``tests/test_misc_ops.py``'s Newton-CG case and
  ``hessp`` against the dense product.
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

import adorym_tpu.config as jcfg
from adorym_tpu.models import base as jbase
from adorym_tpu.ops import propagate as jprop
from adorym_tpu.optim import second_order as jso
from adorym_tpu.recon import Reconstructor as JaxReconstructor
from adorym_tpu.simulate import simulate as jsimulate
from adorym_tpu.utils.initialize import initialize_probe
import adorym_tpu_torch as pt
from adorym_tpu_torch.models import base as tbase
from adorym_tpu_torch.ops import cuda_multislice as cm
from adorym_tpu_torch.ops import cuda_multislice_fused as cmf
from adorym_tpu_torch.ops import propagate as tprop
from adorym_tpu_torch.optim import second_order as tso
from adorym_tpu_torch.optim.scipy_bridge import scipy_minimize_object


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors (several test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    """The largest difference over the largest value of ``b``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# -- a small nonlinear least-squares problem in both frameworks --------------

def _ls_problem(seed=0, m=12, n=6):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, n)).astype(np.float32)
    t = rng.random(m).astype(np.float32)
    x = (rng.normal(size=n) * 0.3).astype(np.float32)
    return a, t, x


def _fns_torch(a, t):
    at, tt = torch.from_numpy(a), torch.from_numpy(t)

    def pred_fn(x):
        return torch.tanh(at @ x)

    def loss_pred_fn(p):
        return torch.sum((p - tt) ** 2 * (1.0 + p ** 2))

    def loss_obj_fn(x):
        return loss_pred_fn(pred_fn(x)) + 0.01 * torch.sum(x ** 2)

    return pred_fn, loss_pred_fn, loss_obj_fn


def _fns_jax(a, t):
    aj, tj = jnp.asarray(a), jnp.asarray(t)

    def pred_fn(x):
        return jnp.tanh(aj @ x)

    def loss_pred_fn(p):
        return jnp.sum((p - tj) ** 2 * (1.0 + p ** 2))

    def loss_obj_fn(x):
        return loss_pred_fn(pred_fn(x)) + 0.01 * jnp.sum(x ** 2)

    return pred_fn, loss_pred_fn, loss_obj_fn


def test_make_gvp_matches_dense_and_jax():
    a, t, x = _ls_problem()
    pred_fn, loss_pred_fn, _ = _fns_torch(a, t)
    xt = torch.from_numpy(x)
    gvp, g, pred = tso.make_gvp(pred_fn, loss_pred_fn, xt)
    pred64, loss64, _ = _fns_torch(a.astype(np.float64),
                                   t.astype(np.float64))
    jac = torch.autograd.functional.jacobian(pred64, xt.double())
    hess = torch.autograd.functional.hessian(loss64, pred64(xt.double()))
    dense = jac.T @ hess @ jac
    jg, jgrad, jpred = jso.make_gvp(*_fns_jax(a, t)[:2], jnp.asarray(x))
    for v in np.random.default_rng(1).normal(size=(3, len(x))):
        v32 = v.astype(np.float32)
        got = gvp(torch.from_numpy(v32)).numpy()
        assert _rel(got, (dense @ torch.from_numpy(v)).numpy()) < 1e-5
        assert _rel(got, np.asarray(jg(jnp.asarray(v32)))) < 1e-5
    assert _rel(g.numpy(), np.asarray(jgrad)) < 1e-5
    assert _rel(pred.numpy(), np.asarray(jpred)) < 1e-6


def _near_singular_state(a, t, x, lmbda=1.0):
    """A Curveball state whose 2x2 system has singular values in the
    ratio 1e-6, between torch's default ``pinv`` cut-off (2.4e-7 here)
    and ``jnp.linalg.pinv``'s (2.4e-6): ``z`` nearly along the step
    ``dz`` it produces.  Returns ``(z, the ratio)``."""
    pred_fn, loss_pred_fn, _ = _fns_torch(a, t)
    gvp, g, _ = tso.make_gvp(pred_fn, loss_pred_fn, torch.from_numpy(x))
    g = g.double()

    def system(z):
        z = z.float()
        gz = gvp(z).double()
        z = z.double()
        dz = gz + lmbda * z + g
        gdz = gvp(dz.float()).double()
        m = torch.stack([torch.stack([dz @ gdz + lmbda * dz @ dz,
                                      z @ gdz + lmbda * z @ dz]),
                         torch.stack([z @ gdz + lmbda * z @ dz,
                                      z @ gz + lmbda * z @ z])])
        s = torch.linalg.svdvals(m)
        return float(s[-1] / s[0])

    # z = c g makes the system nearly rank one for small c; bisect c in
    # log space for a ratio of 1e-6.
    lo, hi = -8.0, 0.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if system(10 ** mid * g) < 1e-6:
            lo = mid
        else:
            hi = mid
    z = (10 ** hi * g).float()
    return z, system(z)


@pytest.mark.parametrize('state', ['first', 'second', 'near_singular'])
def test_curveball_step_matches_jax(state, monkeypatch):
    a, t, x = _ls_problem(seed=2)
    tf, jf = _fns_torch(a, t), _fns_jax(a, t)
    xt = torch.from_numpy(x)
    st = tso.curveball_init(xt)
    if state == 'second':
        _, st, _ = tso.curveball_step(*tf, xt, st)
    elif state == 'near_singular':
        z, ratio = _near_singular_state(a, t, x)
        assert 3e-7 < ratio < 2e-6
        st = {'z': z, 'lmbda': torch.ones(())}
    jst = {'z': jnp.asarray(st['z'].numpy()),
           'lmbda': jnp.asarray(st['lmbda'].numpy())}
    xo, so, lo = tso.curveball_step(*tf, xt, st)
    jxo, jso_, jlo = jso.curveball_step(*jf, jnp.asarray(x), jst)
    assert _rel(xo.numpy(), np.asarray(jxo)) < 1e-5
    assert _rel(so['z'].numpy(), np.asarray(jso_['z'])) < 1e-5
    assert float(so['lmbda']) == pytest.approx(float(jso_['lmbda']),
                                               rel=1e-6)
    assert float(lo) == pytest.approx(float(jlo), rel=1e-6)
    if state == 'near_singular':
        # torch's default cut-off keeps the small singular value and
        # takes another step.
        monkeypatch.setattr(tso, 'PINV_RTOL', None)
        xd, _, _ = tso.curveball_step(*tf, xt, st)
        assert _rel(xd.numpy(), np.asarray(jxo)) > 1e-3


def test_pinv_tolerance_matches_jax():
    m = np.diag([1.0, 5e-7]).astype(np.float32)
    got = torch.linalg.pinv(torch.from_numpy(m), rtol=tso.PINV_RTOL)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.linalg.pinv(m)))
    assert float(torch.linalg.pinv(torch.from_numpy(m))[1, 1]) > 1e6


def _rosen_torch(x):
    return torch.sum((x[1:] - x[:-1] ** 2) ** 2) + torch.sum((1 - x) ** 2)


def _rosen_jax(x):
    return jnp.sum((x[1:] - x[:-1] ** 2) ** 2) + jnp.sum((1 - x) ** 2)


def test_armijo_search_matches_jax():
    """The search's evaluations and result, from a first trial step that
    backtracks several times and from one accepted at once."""
    x = np.asarray([0.3, -0.2, 0.5, 0.1], np.float32)
    xt = torch.from_numpy(x)
    g = torch.func.grad(_rosen_torch)(xt)
    f0 = _rosen_torch(xt)
    spec = tso.CGSpec()
    for alpha0 in (40.0, 1e-3):
        a = torch.tensor(alpha0)
        n0 = tso.LINE_SEARCH_EVALS['count']
        nx, nf, al, count = tso._armijo_search(_rosen_torch, xt, -g, g, f0,
                                               a, spec)
        assert tso.LINE_SEARCH_EVALS['count'] - n0 == count
        jx, jf, jal, jcount = jso._armijo_search(
            _rosen_jax, jnp.asarray(x), -jnp.asarray(g.numpy()),
            jnp.asarray(g.numpy()), jnp.asarray(f0.numpy()),
            jnp.asarray(alpha0, jnp.float32), jso.CGSpec())
        assert count == int(jcount)
        assert _rel(nx.numpy(), np.asarray(jx)) < 1e-6
        assert float(al) == float(jal) and float(nf) == pytest.approx(
            float(jf), rel=1e-6)
    assert int(jcount) == 1


def test_cg_steps_match_jax():
    """Ten CG steps on a Rosenbrock-like loss from the same start: the
    iterates, the state and the losses at 1e-5."""
    x = np.zeros(4, np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    st, jst = tso.cg_init(xt), jso.cg_init(xj)
    for _ in range(10):
        g = torch.func.grad(_rosen_torch)(xt)
        xt, st, f = tso.cg_step(_rosen_torch, xt, g, _rosen_torch(xt), st)
        jg = jax.grad(_rosen_jax)(xj)
        xj, jst, jf = jso.cg_step(_rosen_jax, xj, jg, _rosen_jax(xj), jst)
        assert _rel(xt.numpy(), np.asarray(xj)) < 1e-5
        assert float(f) == pytest.approx(float(jf), rel=1e-5)
        for k in ('s', 'g_old'):
            assert _rel(st[k].numpy(), np.asarray(jst[k])) < 1e-5
        assert float(st['alpha_suggested']) == pytest.approx(
            float(jst['alpha_suggested']), rel=1e-5)
        assert bool(st['first']) is False and st['first'].dtype == torch.bool
    assert float(_rosen_torch(xt)) < 0.5 * float(_rosen_torch(torch.zeros(4)))


# -- Reconstructor -------------------------------------------------------------

def _cfg(mod, optimizer, n=32, pn=16, nz=1, two_d=True, binning=1, mb=8,
         randomize=True, unknown_type='delta_beta', **train):
    return mod.ReconConfig(
        geometry=mod.Geometry(obj_size=(n, n, nz), probe_size=(pn, pn),
                              energy_ev=5000.0, psize_cm=1e-7,
                              free_prop_cm='inf', two_d_mode=two_d,
                              binning=binning),
        train=mod.TrainConfig(minibatch_size=mb, learning_rate=1.0,
                              optimizer=optimizer,
                              randomize_probe_pos=randomize,
                              unknown_type=unknown_type, **train))


def _grid(hi, step):
    xs = np.arange(0, hi, step)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    return np.stack([yy.ravel(), xx.ravel()], -1).astype(float)


def _problem(kind, seed=0):
    """``(cfg kwargs, data, pos, theta, obj0)``: '2d' is
    ``tests/test_optimizers.py``'s geometry (32^2, a 16^2 probe, a 5x5
    grid at stride 4, minibatch 8, shuffled); '3d' a 16^3 object, an 8^2
    probe, a 3x3 grid at stride 4, 2 angles, minibatch 3, binning 2."""
    rng = np.random.default_rng(seed)
    if kind == '2d':
        pos = _grid(17, 4)
        data = rng.random((1, len(pos), 16, 16)).astype(np.float32)
        obj0 = (rng.random((32, 32, 1, 2)) * 1e-3).astype(np.float32)
        return {}, data, pos, None, obj0
    pos = _grid(9, 4)
    data = rng.random((2, len(pos), 8, 8)).astype(np.float32)
    obj0 = (rng.random((16, 16, 16, 2)) * 1e-3).astype(np.float32)
    if kind == '3d_real_imag':
        obj0[..., 0] += 1.0
    kw = dict(n=16, pn=8, nz=16, two_d=False, binning=2, mb=3,
              randomize=False,
              unknown_type='real_imag' if kind == '3d_real_imag'
              else 'delta_beta')
    return kw, data, pos, np.linspace(0, np.pi, 2, endpoint=False), obj0


def _both(optimizer, kind, n_epochs, **extra):
    kw, data, pos, theta, obj0 = _problem(kind)
    kw.update(extra)
    out = []
    for mod, recon, dev in ((jcfg, JaxReconstructor, {}),
                            (pt, pt.Reconstructor, {'device': 'cpu'})):
        rec = recon(_cfg(mod, optimizer, **kw), data=data, probe_pos=pos,
                    theta_ls=theta, obj_init=obj0.copy(), **dev)
        out.append((np.asarray([rec.run_epoch(e) for e in range(n_epochs)]),
                    rec))
    return out


@pytest.mark.parametrize('optimizer', ['cg', 'curveball'])
@pytest.mark.parametrize('kind', ['2d', '3d_delta_beta', '3d_real_imag'])
def test_reconstructor_matches_jax(optimizer, kind):
    """Every batch takes the second-order step (no accumulate loop, no
    band step): the first epoch's losses at rtol 1e-5, the second's at
    1e-3 (CG on the real_imag problem leaves the object's range in its
    second epoch in both packages, and both lose the loss to NaN)."""
    (jl, jr), (tl, tr) = _both(optimizer, kind, 2)
    assert tr.second_order and not (tr._band or tr._accum or tr._angles)
    assert 'obj' not in tr.specs and set(tr.opt_state['obj']) == set(
        jr.opt_state['obj'])
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl[1], jl[1], rtol=1e-3)
    assert tr.i_opt_batch == jr.i_opt_batch


def _optimizers_problem(optimizer, mod):
    """``tests/test_optimizers.py``'s ``_small_problem``: its geometry,
    configuration, phantom, Gaussian probe and simulated data."""
    from scipy.ndimage import gaussian_filter
    n, pn = 32, 16
    cfg = _cfg(mod, optimizer, seed=0)
    rng = np.random.default_rng(0)
    sm = gaussian_filter(rng.random((n, n, 1)), (3, 3, 0))
    obj_true = np.stack([sm * 2e-3, sm * 5e-5], -1).astype(np.float32)
    probe = initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                             psize_cm=1e-7, probe_mag_sigma=4,
                             probe_phase_sigma=4, probe_phase_max=0.4)
    pos = _grid(n - pn + 1, 4)
    data = jsimulate(_cfg(jcfg, optimizer, seed=0), obj_true, probe, pos)
    return cfg, obj_true, probe, pos, data


@pytest.mark.parametrize('optimizer,factor', [('cg', 0.1),
                                              ('curveball', 0.05)])
def test_optimizers_problem_converges_with_jax(optimizer, factor):
    """``tests/test_optimizers.py``'s end-to-end case in both packages: 10
    epochs from a zero object, each converging by that test's factor, the
    losses within 2e-3 of each other throughout (the first batch's loss,
    before any update, already differs by 1.1e-4)."""
    losses = []
    for mod, recon, dev in ((jcfg, JaxReconstructor, {}),
                            (pt, pt.Reconstructor, {'device': 'cpu'})):
        cfg, obj_true, probe, pos, data = _optimizers_problem(optimizer, mod)
        rec = recon(cfg, data=data, probe_pos=pos, probe_init=probe,
                    obj_init=np.zeros_like(obj_true), **dev)
        losses.append(np.asarray([rec.run_epoch(e) for e in range(10)]))
    for ls in losses:
        assert np.all(np.isfinite(ls)) and ls[-1] < ls[0] * factor
    np.testing.assert_allclose(losses[1], losses[0], rtol=2e-3)


def test_cg_resume_mid_epoch(tmp_path):
    """A checkpoint every 4 batches (6 batches an epoch) lands after batch
    4: the run resumed there ends where the uninterrupted run ends, and
    so does the port resumed from the JAX package's checkpoint (loosely:
    the packages' CG steps part by rounding); CG's boolean ``first``
    survives the file."""
    kw, data, pos, theta, obj0 = _problem('3d_delta_beta')

    def make(mod, folder):
        cfg = _cfg(mod, 'cg', **kw).replace(
            io=mod.IOConfig(n_batch_per_checkpoint=4))
        args = dict(data=data, probe_pos=pos, theta_ls=theta,
                    obj_init=obj0.copy(), output_folder=str(folder))
        if mod is pt:
            return pt.Reconstructor(cfg, device='cpu', **args)
        return JaxReconstructor(cfg, **args)

    objs = {}
    for name, mod in (('jax', jcfg), ('port', pt)):
        whole = make(mod, tmp_path / name)
        whole.run_epoch(0)
        objs[name] = np.asarray(whole.params['obj'])
    resumed = make(pt, tmp_path / 'port')
    assert (resumed._start_epoch, resumed._start_batch) == (0, 4)
    assert resumed.opt_state['obj']['first'].dtype == torch.bool
    resumed.run_epoch(0)
    assert resumed.i_opt_batch == 6
    np.testing.assert_array_equal(resumed.obj, objs['port'])
    cross = make(pt, tmp_path / 'jax')
    assert (cross._start_epoch, cross._start_batch) == (0, 4)
    cross.run_epoch(0)
    assert _rel(cross.obj - obj0, objs['jax'] - obj0) < 1e-4


def test_second_order_rotate_out_of_loop():
    """Under a second-order optimizer the JAX package never rotates the
    object under ``rotate_out_of_loop`` (3-D, no tilt): its loss is the
    same at every view angle.  The port keeps the rotation inside the
    model there: its run equals the JAX package's with the rotation in
    the loop."""
    kw, data, pos, theta, obj0 = _problem('3d_delta_beta')
    cfg = _cfg(jcfg, 'cg', rotate_out_of_loop=True, **kw)
    jr = JaxReconstructor(cfg, data=data, probe_pos=pos, theta_ls=theta,
                          obj_init=obj0.copy())
    inds = np.arange(3)

    def jloss(rec, th):
        batch = {'i_theta': jnp.asarray(0), 'theta': jnp.asarray(
            th, jnp.float32), 'pos_batch': jnp.asarray(pos[inds],
                                                        jnp.float32),
                 'ind_batch': jnp.asarray(inds)}
        return float(rec.loss_fn(rec.params, batch,
                                 jnp.asarray(data[0][inds]), None))

    assert jloss(jr, 0.0) == jloss(jr, 1.0)
    jin = JaxReconstructor(_cfg(jcfg, 'cg', **kw), data=data,
                           probe_pos=pos, theta_ls=theta,
                           obj_init=obj0.copy())
    assert jloss(jin, 0.0) != jloss(jin, 1.0)
    tr = pt.Reconstructor(_cfg(pt, 'cg', rotate_out_of_loop=True, **kw),
                          data=data, probe_pos=pos, theta_ls=theta,
                          obj_init=obj0.copy(), device='cpu')
    assert tr._model_cfg.train.rotate_out_of_loop is False
    tl = [tr.run_epoch(e) for e in range(2)]
    jl = [jin.run_epoch(e) for e in range(2)]
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl[1], jl[1], rtol=1e-3)


def test_auxiliary_leaf_second_order_raises():
    """Auxiliary leaves take first-order kinds only, in both packages."""
    kw, data, pos, theta, obj0 = _problem('2d')
    for mod, recon, dev in ((jcfg, JaxReconstructor, {}),
                            (pt, pt.Reconstructor, {'device': 'cpu'})):
        cfg = _cfg(mod, 'cg', **kw).replace(refine=mod.RefineConfig(
            optimize_probe=True, probe_optimizer='curveball'))
        with pytest.raises(ValueError, match='first-order'):
            recon(cfg, data=data, probe_pos=pos, obj_init=obj0, **dev)


# -- forward mode ---------------------------------------------------------------

def test_safe_sqrt_tangent_matches_jax():
    x = np.asarray([4.0, 1e-3, 0.0, 1e-14, 2.5], np.float32)
    dx = np.asarray([1.0, -2.0, 3.0, 0.5, 1.5], np.float32)
    with fwAD.dual_level():
        y = tbase.safe_sqrt(fwAD.make_dual(torch.from_numpy(x),
                                           torch.from_numpy(dx)))
        ty = fwAD.unpack_dual(y).tangent.numpy()
    _, jy = jax.jvp(jbase.safe_sqrt, (jnp.asarray(x),), (jnp.asarray(dx),))
    np.testing.assert_allclose(ty, np.asarray(jy), rtol=1e-6)


def test_bin_real_imag_tangent():
    """``BinRealImag``'s rule against forward mode through the plain
    padded products, with a short tail bin."""
    rng = np.random.default_rng(4)
    st = torch.from_numpy(rng.random((2, 3, 3, 5, 2)).astype(np.float32))
    dst = torch.from_numpy(rng.normal(size=st.shape).astype(np.float32))

    def plain(s):
        s = torch.cat([s, torch.ones(2, 3, 3, 1, 2)], 3)
        s = s.reshape(2, 3, 3, 3, 2, 2).prod(4)
        return torch.view_as_complex(s.permute(3, 0, 1, 2, 4).contiguous())

    with fwAD.dual_level():
        t = fwAD.unpack_dual(tprop.bin_real_imag(
            fwAD.make_dual(st, dst), 2)).tangent
    _, ref = torch.func.jvp(plain, (st,), (dst,))
    assert _rel(torch.view_as_real(t), torch.view_as_real(ref)) < 1e-6


S, M, NB, NP = 5, 2, 3, 16
K1_, SIGN = 2.5, 1.0


def _sweep_inputs(seed=0):
    rng = np.random.default_rng(seed)
    db = torch.from_numpy((rng.random((S, 2, NB, NP, NP)) * 1e-2).astype(
        np.float32))
    ddb = torch.from_numpy(rng.normal(size=db.shape).astype(np.float32))
    w = rng.normal(size=(2, M, NB, NP, NP)).astype(np.float32)
    wave = torch.complex(torch.from_numpy(w[0]), torch.from_numpy(w[1]))
    dw = rng.normal(size=(2, M, NB, NP, NP)).astype(np.float32)
    dwave = torch.complex(torch.from_numpy(dw[0]), torch.from_numpy(dw[1]))
    return db, ddb, wave, dwave


def _k1_jvp_from_records(db, ddb, wave, dwave, h, far):
    """K1's forward-mode rule on the plain version's records: the rule's
    own body (``MultisliceDbStored.jvp``) on a stand-in context."""
    import types
    fa = () if far is None else far
    _, rec = cm.multislice_db_stored_plain(db, wave, h, K1_, SIGN, *fa,
                                           records=True)
    ctx = types.SimpleNamespace(
        saved_tensors=(db, torch.view_as_real(rec).contiguous()),
        mats=cm.prop_mats(h, *fa, route='dense'), k1=K1_, s=SIGN)
    return cm.MultisliceDbStored.jvp(ctx, ddb, dwave, None, None, None)


@pytest.mark.parametrize('far', [False, True])
def test_k1_tangent_matches_forward_mode(far):
    db, ddb, wave, dwave = _sweep_inputs()
    h = tprop.fresnel_kernel((NP, NP), (1.0, 1.0, 1.0), 0.25, 8.0)
    fm = (tprop.final_prop_mats((NP, NP), (1.0, 1.0), 0.25, 'inf')[:2]
          if far else None)
    n0 = cm.TANGENT_LAUNCHES['K1']
    got = _k1_jvp_from_records(db, ddb, wave, dwave, h, fm)
    assert cm.TANGENT_LAUNCHES['K1'] == n0 + 1
    with fwAD.dual_level():
        out = cm.multislice_db_stored_plain(
            fwAD.make_dual(db, ddb), fwAD.make_dual(wave, dwave), h, K1_,
            SIGN, *(fm or ()))
        ref = fwAD.unpack_dual(out).tangent
    assert _rel(torch.view_as_real(got), torch.view_as_real(ref)) < 1e-5


def test_k5_tangent_matches_forward_mode():
    import types
    rng = np.random.default_rng(5)
    t = torch.from_numpy((1 + 0.1 * rng.normal(size=(S, NB, NP, NP))
                          + 0.1j * rng.normal(size=(S, NB, NP, NP))
                          ).astype(np.complex64))
    dt = torch.from_numpy((rng.normal(size=t.shape)
                           + 1j * rng.normal(size=t.shape)).astype(
                               np.complex64))
    _, _, wave, dwave = _sweep_inputs(6)
    h = tprop.fresnel_kernel((NP, NP), (1.0, 1.0, 1.0), 0.25, 8.0,
                             fresnel_approx=False)
    _, rec = cmf.multislice_fused_plain(t, wave, h, records=True)
    ctx = types.SimpleNamespace(saved_tensors=(t, rec),
                                mats=cmf.step_mats(h, 'dense'))
    n0 = cm.TANGENT_LAUNCHES['K5']
    got = cmf.MultisliceFused.jvp(ctx, dt, dwave, None)
    assert cm.TANGENT_LAUNCHES['K5'] == n0 + 1
    with fwAD.dual_level():
        ref = fwAD.unpack_dual(cmf.multislice_fused_plain(
            fwAD.make_dual(t, dt), fwAD.make_dual(wave, dwave), h)).tangent
    assert _rel(torch.view_as_real(got), torch.view_as_real(ref)) < 1e-5


def test_k1_tangent_matches_jax_jvp():
    """The tangent of the delta/beta sweep against ``jax.jvp`` of the JAX
    package's plain FFT scan (``fused=False``) on the same channels."""
    db, ddb, wave, _ = _sweep_inputs(7)
    energy, psize = 5000.0, 1e-7
    lmbda = jprop.wavelength_nm(energy)
    dz_nm = psize * 1e7
    k1 = 2 * np.pi * dz_nm / lmbda
    # [S, 2, N, y, x] -> delta, beta [N, y, x, S]
    d = db[:, 0].permute(1, 2, 3, 0).numpy()
    b = db[:, 1].permute(1, 2, 3, 0).numpy()
    dd = ddb[:, 0].permute(1, 2, 3, 0).numpy()
    dbt = ddb[:, 1].permute(1, 2, 3, 0).numpy()
    w0 = wave[0].numpy()

    def jfn(d_, b_):
        return jprop.multislice_propagate(d_, b_, jnp.asarray(w0), energy,
                                          psize, fused=False)

    _, jt = jax.jvp(jfn, (jnp.asarray(d), jnp.asarray(b)),
                    (jnp.asarray(dd), jnp.asarray(dbt)))
    h = tprop.fresnel_kernel((NP, NP), (dz_nm,) * 3, lmbda, dz_nm)
    t, dt = cm.modulator_tangent(db, ddb, k1, 1.0)
    _, rec = cm.multislice_db_stored_plain(db, wave[:1], h, k1, 1.0,
                                           records=True)
    got = cm.multislice_tangent(t, dt, rec, None, h)[0]
    assert _rel(torch.view_as_real(got).numpy(),
                np.stack([np.real(jt), np.imag(jt)], -1)) < 1e-5


def test_k4_tangent_raises():
    """K4 keeps no records: its forward mode (the CUDA Function's and its
    plain twin's) raises, naming ROADMAP B.16; so does Curveball on a
    configuration that takes K4."""
    db, ddb, wave, dwave = _sweep_inputs()
    h = tprop.fresnel_kernel((NP, NP), (1.0, 1.0, 1.0), 0.25, 8.0)
    with pytest.raises(NotImplementedError, match='B.16'):
        with fwAD.dual_level():
            cm.multislice_db_plain(fwAD.make_dual(db, ddb), wave, h, K1_,
                                   SIGN)
    with pytest.raises(NotImplementedError, match='B.16'):
        cm.MultisliceDb.jvp(None, ddb, dwave, None, None, None)


def test_curveball_on_k4_raises(monkeypatch):
    kw, data, pos, theta, obj0 = _problem('3d_delta_beta')
    monkeypatch.setattr(tprop, '_db_stored_max_bytes', lambda device: 0)
    rec = pt.Reconstructor(_cfg(pt, 'curveball', fused_multislice='on',
                                **kw), data=data, probe_pos=pos,
                           theta_ls=theta, obj_init=obj0, device='cpu')
    with pytest.raises(NotImplementedError, match='B.16'):
        rec.run_epoch(0)


def test_curveball_on_k4_names_fused_off(monkeypatch):
    """At K4's sizes (the stored/invertible switch forced) Curveball's
    error names ``fused_multislice='off'``, and that configuration runs:
    the plain FFT scan takes forward mode (``tests/test_torch_cuda.py::
    test_curveball_at_k4_sizes_runs_with_fused_off`` holds it on the
    card)."""
    kw, data, pos, theta, obj0 = _problem('3d_delta_beta')
    monkeypatch.setattr(tprop, '_db_stored_max_bytes', lambda device: 0)
    losses = {}
    for fused in ('on', 'off'):
        rec = pt.Reconstructor(_cfg(pt, 'curveball', fused_multislice=fused,
                                    **kw), data=data, probe_pos=pos,
                               theta_ls=theta, obj_init=obj0.copy(),
                               device='cpu')
        if fused == 'on':
            with pytest.raises(NotImplementedError,
                               match="fused_multislice='off'"):
                rec.run_epoch(0)
        else:
            losses[fused] = rec.run_epoch(0)
    assert np.isfinite(losses['off'])


# -- scipy bridge ------------------------------------------------------------

def test_scipy_bridge_newton_cg():
    """``tests/test_misc_ops.py``'s case: least squares by Newton-CG with
    the Gauss-Newton ``hessp``."""
    rng = np.random.default_rng(0)
    a = rng.random((12, 6)).astype(np.float32)
    target = rng.random(12).astype(np.float32)
    at, tt = torch.from_numpy(a), torch.from_numpy(target)

    def pred_fn(x):
        return at @ x

    def loss_pred(p):
        return torch.sum((p - tt) ** 2)

    def loss_obj(x):
        return loss_pred(pred_fn(x))

    x = scipy_minimize_object(loss_obj, np.zeros(6, np.float32),
                              method='Newton-CG', pred_fn=pred_fn,
                              loss_pred_fn=loss_pred,
                              options={'maxiter': 50}, device='cpu')
    x_opt = np.linalg.lstsq(a, target, rcond=None)[0]
    np.testing.assert_allclose(x, x_opt, atol=1e-3)


def test_scipy_bridge_hessp_is_the_dense_product():
    """The bridge's ``hessp`` is ``J^T H J p``: checked through the
    product scipy receives, and the whole run against the JAX package's
    bridge."""
    import scipy.optimize
    from adorym_tpu.optim.scipy_bridge import (
        scipy_minimize_object as jax_minimize)
    a, t, x0 = _ls_problem(seed=3)
    tf = _fns_torch(a, t)
    seen = []
    real = scipy.optimize.minimize

    def spy(fun, x, method=None, jac=None, hessp=None, options=None):
        p = np.random.default_rng(9).normal(size=x.shape)
        seen.append((x.copy(), p, hessp(x, p)))
        return real(fun, x, method=method, jac=jac, hessp=hessp,
                    options=options)

    scipy.optimize.minimize = spy
    try:
        got = scipy_minimize_object(tf[2], x0, method='Newton-CG',
                                    pred_fn=tf[0], loss_pred_fn=tf[1],
                                    options={'maxiter': 20}, device='cpu')
    finally:
        scipy.optimize.minimize = real
    x, p, hp = seen[0]
    xd = torch.from_numpy(x)
    t64 = _fns_torch(a.astype(np.float64), t.astype(np.float64))
    jac = torch.autograd.functional.jacobian(t64[0], xd)
    hess = torch.autograd.functional.hessian(t64[1], t64[0](xd))
    assert _rel(hp, (jac.T @ hess @ jac @ torch.from_numpy(p)).numpy()) < 1e-5
    jf = _fns_jax(a, t)
    ref = jax_minimize(jf[2], x0, method='Newton-CG', pred_fn=jf[0],
                       loss_pred_fn=jf[1], options={'maxiter': 20})
    assert _rel(got, ref) < 1e-4


def _settle_tool():
    """``tools/settle_c7_c8.py``, ROADMAP C.7 and C.8's settlement."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / 'tools' / 'settle_c7_c8.py'
    spec = importlib.util.spec_from_file_location('settle_c7_c8', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_first_batch_loss_against_float64():
    """C.7: on ``tests/test_optimizers.py``'s problem from a zero object,
    both packages' predicted magnitudes are within 1e-7 of a float64
    evaluation (f32 rounding), and their first-batch losses within the
    loss's own f32 condition (each magnitude's rounding moves it by up to
    1.1e-4 relative: the residuals are about 1e-3 of the magnitudes).  The
    gap between the packages is that conditioning, not a fault of
    either."""
    out = _settle_tool().c7_loss()
    assert out['port_pred_rel_err'] < 1e-7 and out['jax_pred_rel_err'] < 1e-7
    assert out['port_f32_rel_err'] < out['f32_condition']
    assert out['jax_f32_rel_err'] < out['f32_condition']
    assert out['port_f32_half_rel_err'] < out['f32_condition_half']


def test_minibatch_cg_rise_matches_jax():
    """C.8: 10a's configuration at a CPU size (a 48^3 blob phantom,
    minibatch 23, the immediate scheme, CG, 2 angles), one epoch in both
    packages: each batch's loss at rtol 2e-4 and CG's suggested step after
    each batch at rtol 1e-5 (the same accepted steps; the suggestion
    doubles after a first-trial acceptance in both), and the loss rises
    over the epoch in both: the rise is the JAX package's rule."""
    out = _settle_tool().c8(n_epochs=1)
    jl, tl = (np.asarray(out[k]['losses']) for k in ('jax', 'port'))
    assert len(tl) == len(jl) == 8
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    np.testing.assert_allclose(out['port']['suggested'],
                               out['jax']['suggested'], rtol=1e-5)
    assert tl[-1] > tl[0] and jl[-1] > jl[0]
