"""The port's remaining forward models and refinables against the JAX
package on the CPU: rotation about any axis (differentiable in the angle)
and the three-axis tilt, the multislice branches under kappa, ``repeats``
and ``backprop``, the impulse-response kernel, the projection
approximation (with the minus-logged line projections), sparse multislice
at refinable slice positions, the CTF, the parameter registry's slice
positions, tilts and kappa, and the ptychography and multi-distance
models' new branches.

Tolerance: values and gradients at 1e-5 of the largest value (f32 on
both sides), as ROADMAP.md's contract; the axis-0 rotation is held bit for
bit against its form before any other axis was ported."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adorym_tpu.config as jconfig
from adorym_tpu.models import multidist as jmd
from adorym_tpu.models import ptychography as jpm
from adorym_tpu.ops import propagate as jprop
from adorym_tpu.ops import rotate as jrot
from adorym_tpu.optim import params as jparams
from adorym_tpu.utils.initialize import initialize_probe
import adorym_tpu_torch as pt
from adorym_tpu_torch.models import multidist as tmd
from adorym_tpu_torch.models import ptychography as tpm
from adorym_tpu_torch.ops import propagate as tprop
from adorym_tpu_torch.ops import rotate as trot
from adorym_tpu_torch.optim import params as tparams

TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors (several test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _grads_jax(fn, *args):
    val, grads = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    return float(val), [np.asarray(g) for g in grads]


def _grads_torch(fn, *args):
    ts = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    val = fn(*ts)
    grads = torch.autograd.grad(val, ts, allow_unused=True)
    return float(val.detach()), [np.zeros(t.shape, np.float32) if g is None
                                 else g.numpy() for g, t in zip(grads, ts)]


def _check(jres, tres, tol=TOL):
    (jv, jg), (tv, tg) = jres, tres
    assert abs(tv - jv) <= tol * max(abs(jv), 1e-30), (tv, jv)
    for a, b in zip(tg, jg):
        assert _rel(a, b) < tol, _rel(a, b)


def _functional(out, g, lib):
    """A fixed real functional of a (complex) output."""
    cplx = out.is_complex() if lib is torch else jnp.iscomplexobj(out)
    if cplx:
        return lib.sum(out.real * g[..., 0] + out.imag * g[..., 1])
    return lib.sum(out * g[..., 0])


def _wave(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _probe(pn):
    return initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                            psize_cm=1e-7, probe_mag_sigma=pn / 4,
                            probe_phase_sigma=pn / 4, probe_phase_max=0.3)


# -- ops/rotate.py -------------------------------------------------------------

@pytest.mark.parametrize('axis', [0, 1, 2])
@pytest.mark.parametrize('method', ['bilinear', 'nearest'])
def test_rotate_any_axis_values(axis, method):
    """A non-cubic volume rotated about each axis (the planes across axes
    1 and 2, ``[y, z]`` and ``[y, x]``, are rectangular)."""
    rng = np.random.default_rng(axis)
    vol = rng.normal(size=(10, 13, 7, 2)).astype(np.float32)
    for theta in (0.0, 0.37, -1.2, 2.9):
        j = np.asarray(jrot.rotate(jnp.asarray(vol), theta, axis=axis,
                                   method=method))
        t = trot.rotate(torch.tensor(vol), theta, axis=axis,
                        method=method).numpy()
        assert t.shape == j.shape == vol.shape
        assert _rel(t, j) < TOL


@pytest.mark.parametrize('axis', [0, 1, 2])
@pytest.mark.parametrize('theta', [0.0, 0.41])
def test_rotate_gradients_in_object_and_angle(axis, theta):
    """Bilinear rotation about each axis of a non-cubic volume: the
    gradient reaches the object and the angle (a tensor), as JAX's does;
    at theta = 0 the edge samples sit on the clamp, where both split the
    angle's gradient."""
    rng = np.random.default_rng(10 + axis)
    vol = rng.normal(size=(9, 12, 6, 2)).astype(np.float32)
    g = rng.normal(size=vol.shape + (1,)).astype(np.float32)

    def jfn(v, th):
        return _functional(jrot.rotate(v, th, axis=axis), jnp.asarray(g),
                           jnp)

    def tfn(v, th):
        return _functional(trot.rotate(v, th, axis=axis), torch.tensor(g),
                           torch)
    th = np.float32(theta)
    _check(_grads_jax(jfn, vol, th), _grads_torch(tfn, vol, th))


def test_rotate_axis0_keeps_its_results_bit_for_bit():
    """``rotate`` about axis 0 (every caller before tilt) gives, bit for
    bit, what its one-axis form gave: the same gathers in the same
    order."""
    rng = np.random.default_rng(5)
    obj = torch.tensor(rng.normal(size=(8, 11, 9, 2)).astype(np.float32))

    def one_axis(o, theta):
        s1, s2 = o.shape[1], o.shape[2]
        c1, c2 = trot._rotation_source_coords((s1, s2), theta, o.device)
        v = o.movedim(0, 2)
        idx, wts = trot._corners(c1, c2, s1, s2)
        out = None
        for (a, b), wt in zip(idx, wts):
            vals = v[a, b]
            wt = wt.reshape((-1,) + (1,) * (vals.dim() - 1)).to(vals.dtype)
            out = vals * wt if out is None else out + vals * wt
        return out.reshape((s1, s2) + tuple(v.shape[2:])).movedim(
            2, 0).contiguous()
    for theta in (0.3, -0.9, float(np.float32(2.1))):
        assert torch.equal(trot.rotate(obj, theta), one_axis(obj, theta))
    assert torch.equal(trot.rotate_and_bin_z(obj, 0.3, 4),
                       tprop.bin_z_sum(one_axis(obj, 0.3), 4, axis=2))


def test_tilt_rotate_values_and_gradients():
    """The three-axis tilt sequence, differentiable in the three tilts and
    the object."""
    rng = np.random.default_rng(7)
    vol = rng.normal(size=(10, 12, 8, 2)).astype(np.float32)
    g = rng.normal(size=vol.shape + (1,)).astype(np.float32)
    for tilts in ([0.4, 0.0, 0.0], [0.3, 0.12, -0.07]):
        tilts = np.asarray(tilts, np.float32)

        def jfn(v, tl):
            return _functional(jrot.tilt_rotate(v, tl), jnp.asarray(g), jnp)

        def tfn(v, tl):
            return _functional(trot.tilt_rotate(v, tl), torch.tensor(g),
                               torch)
        _check(_grads_jax(jfn, vol, tilts), _grads_torch(tfn, vol, tilts))


# -- ops/propagate.py ----------------------------------------------------------

def _db(rng, n, py, nz):
    return (rng.random((n, py, py, nz)) * 2e-3).astype(np.float32), \
        (rng.random((n, py, py, nz)) * 5e-5).astype(np.float32)


@pytest.mark.parametrize('fused', [False, True])
def test_multislice_kappa_values_and_gradients(fused):
    """``beta = kappa delta`` with a tensor kappa: the value and the
    gradients in delta, the wave and kappa, on the plain scan and through
    K1's plain version (the packed stack is rebuilt from the new beta),
    with the far field folded in."""
    rng = np.random.default_rng(1)
    delta, beta = _db(rng, 3, 12, 8)
    wave = _wave(rng, (1, 3, 12, 12))
    g = rng.normal(size=(1, 3, 12, 12, 2)).astype(np.float32)
    kappa = np.float32(0.05)
    kw = dict(energy_ev=5000.0, psize_cm=1e-7, binning=2,
              final_prop={'free_prop_cm': 'inf', 'normalize_fft': False})

    def jfn(d, w, k):
        out = jprop.multislice_propagate(
            d, jnp.asarray(beta), w[0] + 1j * w[1], kappa=k,
            db_stack=jnp.stack([d, jnp.asarray(beta)], -1),
            fused=fused, **kw)
        return _functional(out, jnp.asarray(g), jnp)

    def tfn(d, w, k):
        out = tprop.multislice_propagate(
            d, torch.tensor(beta), torch.complex(w[0], w[1]), kappa=k,
            db_stack=torch.stack([d, torch.tensor(beta)], -1),
            fused=fused, **kw)
        return _functional(out, torch.tensor(g), torch)
    w2 = np.stack([wave.real, wave.imag]).astype(np.float32)
    _check(_grads_jax(jfn, delta, w2, kappa),
           _grads_torch(tfn, delta, w2, kappa))


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('binning', [1, 3])
def test_multislice_backprop(fused, binning):
    """Propagation in -z: the slices last to first (the far-end pad in the
    short first bin), the -z step and the flipped phase sign; on K1's
    plain version the step vectors of the -z kernel are its factors, as
    the FFT route takes them."""
    rng = np.random.default_rng(2 + binning)
    delta, beta = _db(rng, 2, 12, 7)
    wave = _wave(rng, (1, 2, 12, 12))
    g = rng.normal(size=(1, 2, 12, 12, 2)).astype(np.float32)
    kw = dict(energy_ev=5000.0, psize_cm=1e-7, binning=binning,
              backprop=True, fused=fused)

    def jfn(d, b):
        out = jprop.multislice_propagate(d, b, jnp.asarray(wave), **kw)
        return _functional(out, jnp.asarray(g), jnp)

    def tfn(d, b):
        out = tprop.multislice_propagate(d, b, torch.tensor(wave), **kw)
        return _functional(out, torch.tensor(g), torch)
    _check(_grads_jax(jfn, delta, beta), _grads_torch(tfn, delta, beta))
    with pytest.raises(ValueError, match='backprop'):
        tprop.multislice_propagate(
            torch.tensor(delta), torch.tensor(beta), torch.tensor(wave),
            5000.0, 1e-7, backprop=True, final_prop={'free_prop_cm': 'inf'})


def test_backprop_step_vectors_split():
    """The -z step kernel is separable as the +z one is: its per-axis
    factors rebuild it, so K1's FFT route takes it as it is."""
    from adorym_tpu_torch.ops import cuda_multislice as cm
    for sign in (1.0, -1.0):
        h = tprop.fresnel_kernel((12, 16), (1.0, 1.0, 1.0), 0.248,
                                 sign * 8.0)
        vy, vx = cm.fft_step_vectors(h)
        assert torch.allclose(vy[:, None] * 12 * vx[None, :] * 16, h,
                              atol=1e-6)
    assert cm.k1_route(12, 16) == 'fft'


@pytest.mark.parametrize('unknown_type', ['delta_beta', 'real_imag'])
def test_multislice_repeats(unknown_type):
    rng = np.random.default_rng(4)
    delta, beta = _db(rng, 2, 12, 3)
    if unknown_type == 'real_imag':
        delta, beta = 1.0 - delta, beta
    wave = _wave(rng, (2, 12, 12))
    g = rng.normal(size=(2, 12, 12, 2)).astype(np.float32)
    kw = dict(energy_ev=5000.0, psize_cm=1e-7, repeats=5,
              unknown_type=unknown_type)

    def jfn(d, b):
        out = jprop.multislice_propagate(d, b, jnp.asarray(wave), **kw)
        return _functional(out, jnp.asarray(g), jnp)

    def tfn(d, b):
        out = tprop.multislice_propagate(d, b, torch.tensor(wave), **kw)
        return _functional(out, torch.tensor(g), torch)
    _check(_grads_jax(jfn, delta, beta), _grads_torch(tfn, delta, beta))
    with pytest.raises(NotImplementedError, match='binning'):
        tprop.multislice_propagate(torch.tensor(delta), torch.tensor(beta),
                                   torch.tensor(wave), 5000.0, 1e-7,
                                   repeats=4, binning=2)


def test_fresnel_kernel_ir():
    for shape, dist in (((16, 16), 5e4), ((12, 20), 2e5)):
        j = np.asarray(jprop.fresnel_kernel_ir(shape, (1.0, 1.3, 1.0), 0.248,
                                               dist))
        t = tprop.fresnel_kernel_ir(shape, (1.0, 1.3, 1.0), 0.248,
                                    dist).numpy()
        assert _rel(t, j) < TOL


@pytest.mark.parametrize('unknown_type', ['delta_beta', 'real_imag'])
@pytest.mark.parametrize('minus_logged,return_sqrt,use_kappa', [
    (False, False, False), (False, False, True), (True, False, False),
    (True, True, False), (True, True, True)])
def test_pure_projection_modulate(unknown_type, minus_logged, return_sqrt,
                                  use_kappa):
    """The projection approximation of both object types, minus-logged or
    not.  The real_imag object absorbs strongly (each slice's |t| between
    0.6 and 0.9): for a nearly transparent one ``-log |t|^2`` sits near 0,
    where both packages' f32 logarithms lose most of their relative
    precision."""
    rng = np.random.default_rng(6)
    delta, beta = _db(rng, 3, 10, 5)
    if unknown_type == 'real_imag':
        delta = (0.6 + 0.3 * rng.random(delta.shape)).astype(np.float32)
        beta = (0.2 * rng.random(beta.shape)).astype(np.float32)
    wave = _wave(rng, (1, 3, 10, 10))
    g = rng.normal(size=(1, 3, 10, 10, 2)).astype(np.float32)
    kappa = np.float32(0.07)
    kw = dict(energy_ev=5000.0, psize_cm=1e-7, unknown_type=unknown_type,
              is_minus_logged=minus_logged, return_sqrt=return_sqrt)

    def jfn(d, b, k):
        out = jprop.pure_projection_modulate(
            d, b, jnp.asarray(wave), kappa=k if use_kappa else None, **kw)
        return _functional(out, jnp.asarray(g), jnp)

    def tfn(d, b, k):
        out = tprop.pure_projection_modulate(
            d, b, torch.tensor(wave), kappa=k if use_kappa else None, **kw)
        return _functional(out, torch.tensor(g), torch)
    _check(_grads_jax(jfn, delta, beta, kappa),
           _grads_torch(tfn, delta, beta, kappa))


@pytest.mark.parametrize('n_slices', [2, 3])
def test_sparse_multislice_and_slice_position_gradients(n_slices):
    """A few slices at tensor positions: the gradient reaches the object
    and every slice position (``k1`` on the lateral voxel size)."""
    rng = np.random.default_rng(8 + n_slices)
    delta, beta = _db(rng, 2, 16, n_slices)
    wave = _wave(rng, (1, 2, 16, 16))
    g = rng.normal(size=(1, 2, 16, 16, 2)).astype(np.float32)
    pos = np.asarray([0.0, 4e-5, 9e-5][:n_slices], np.float32)

    def jfn(d, b, p):
        out = jprop.sparse_multislice_propagate(d, b, jnp.asarray(wave),
                                                5000.0, 1e-7, p)
        return _functional(out, jnp.asarray(g), jnp)

    def tfn(d, b, p):
        out = tprop.sparse_multislice_propagate(d, b, torch.tensor(wave),
                                                5000.0, 1e-7, p)
        return _functional(out, torch.tensor(g), torch)
    _check(_grads_jax(jfn, delta, beta, pos), _grads_torch(tfn, delta, beta,
                                                           pos))
    # A sequence of positions gives the same wave as the tensor.
    t1 = tprop.sparse_multislice_propagate(
        torch.tensor(delta), torch.tensor(beta), torch.tensor(wave), 5000.0,
        1e-7, tuple(float(p) for p in pos))
    t2 = tprop.sparse_multislice_propagate(
        torch.tensor(delta), torch.tensor(beta), torch.tensor(wave), 5000.0,
        1e-7, torch.tensor(pos))
    assert torch.equal(t1, t2)


def test_ctf_intensity_spectrum():
    rng = np.random.default_rng(12)
    wave = _wave(rng, (2, 16, 12))
    j = np.asarray(jprop.ctf_intensity_spectrum(
        jnp.asarray(wave), 3e5, 0.248, (1.0, 1.0, 1.0)))
    t = tprop.ctf_intensity_spectrum(torch.tensor(wave), 3e5, 0.248,
                                     (1.0, 1.0, 1.0)).numpy()
    assert _rel(t, j) < TOL


def test_ctf_kappa_and_distance_gradients():
    """``modulate_and_get_ctf`` with a tensor kappa and distance: the
    predicted magnitude and its gradients in the object, kappa and the
    distance."""
    rng = np.random.default_rng(13)
    delta = (rng.random((1, 16, 16, 3)) * 1e-3).astype(np.float32)
    g = rng.normal(size=(1, 16, 16, 1)).astype(np.float32)
    kappa, dist = np.float32(40.0), np.float32(2e-4)

    def jfn(d, k, z):
        out = jnp.abs(jprop.modulate_and_get_ctf(d, None, 5000.0, 1e-7, z,
                                                 kappa=k))
        return _functional(out, jnp.asarray(g), jnp)

    def tfn(d, k, z):
        out = torch.abs(tprop.modulate_and_get_ctf(d, None, 5000.0, 1e-7, z,
                                                   kappa=k))
        return _functional(out, torch.tensor(g), torch)
    _check(_grads_jax(jfn, delta, kappa, dist),
           _grads_torch(tfn, delta, kappa, dist))
    # pure_phase_ctf of a projection at a float distance and kappa.
    j = np.asarray(jprop.pure_phase_ctf(jnp.asarray(delta[..., 0]), None,
                                        1e6, 0.248, (1.0, 1.0, 1.0), 30.0))
    t = tprop.pure_phase_ctf(torch.tensor(delta[..., 0]), None, 1e6, 0.248,
                             (1.0, 1.0, 1.0), 30.0).numpy()
    assert _rel(t, j) < TOL


# -- optim/params.py -----------------------------------------------------------

def _cfgs(geo, refine, train=None):
    """The same configuration in both packages."""
    return [mod.ReconConfig(geometry=mod.Geometry(**geo),
                            refine=mod.RefineConfig(**refine),
                            train=mod.TrainConfig(**(train or {})))
            for mod in (jconfig, pt)]


def test_registry_slice_positions_tilt_and_kappa():
    """``build_aux_params``, ``build_opt_specs`` and the slice-0 anchor of
    ``apply_param_constraints`` for the slice positions, the tilts (refined
    or fixed: a leaf without a spec) and kappa."""
    geo = dict(obj_size=(8, 8, 2), probe_size=(8, 8),
               slice_pos_cm_ls=(0.0, 1e-4))
    tilt = np.arange(9, dtype=np.float32).reshape(3, 3) * 0.1
    for refine, kw in (
            (dict(optimize_slice_pos=True, optimize_tilt=True,
                  optimize_ctf_lg_kappa=True),
             dict(slice_pos_cm_ls=(0.0, 1e-4), tilt_init=tilt)),
            (dict(fixed_tilt=True, optimize_ctf_lg_kappa=True),
             dict(ctf_lg_kappa_init=1.7)),
            (dict(optimize_tilt=True, tilt_learning_rate=0.5,
                  tilt_optimizer='gd'), {})):
        jc, tc = _cfgs(geo, refine, dict(ctf_kappa=20.0))
        jp = jparams.build_aux_params(jc, 3, 4, **kw)
        tp = tparams.build_aux_params(tc, 3, 4, **kw)
        assert sorted(jp) == sorted(tp)
        for k in jp:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
            assert tp[k].dtype == torch.float32
        assert {k: (s.kind, s.step_size) for k, s in
                tparams.build_opt_specs(tc).items()} == \
            {k: (s.kind, s.step_size) for k, s in
             jparams.build_opt_specs(jc).items()}
    assert 'tilt_ls' not in tparams.build_opt_specs(
        _cfgs(geo, dict(fixed_tilt=True))[1])
    moved = {'slice_pos_cm_ls': torch.tensor([2e-6, 1.03e-4])}
    out = tparams.apply_param_constraints(moved, _cfgs(geo, {})[1])
    jout = jparams.apply_param_constraints(
        {'slice_pos_cm_ls': jnp.asarray([2e-6, 1.03e-4])}, _cfgs(geo, {})[0])
    np.testing.assert_array_equal(out['slice_pos_cm_ls'].numpy(),
                                  np.asarray(jout['slice_pos_cm_ls']))
    with pytest.raises(ValueError, match='slice_pos_cm_ls'):
        tparams.build_aux_params(_cfgs(dict(obj_size=(8, 8, 2),
                                            probe_size=(8, 8)),
                                       dict(optimize_slice_pos=True))[1], 1, 1)


# -- models --------------------------------------------------------------------

def _batch(lib, pos, inds, i_theta=0, theta=0.0):
    if lib is jnp:
        return {'i_theta': jnp.asarray(i_theta), 'theta': jnp.asarray(theta),
                'pos_batch': jnp.asarray(pos, jnp.float32),
                'ind_batch': jnp.asarray(inds)}
    return {'i_theta': i_theta, 'theta': float(np.float32(theta)),
            'pos_batch': np.asarray(pos, np.float32),
            'ind_batch': np.asarray(inds)}


def _model_grads(jcfg, tcfg, params_np, names, pos, i_theta=0, theta=0.0,
                 jmodel=jpm, tmodel=tpm, seed=0):
    """Value and gradients (in ``names``) of a fixed linear functional of
    the models' ``return_wave`` outputs (the complex detector waves of the
    ptychography model; the multi-distance model's uncropped magnitudes),
    both packages.  A functional of the detected magnitudes would weight
    the dark detector pixels, whose phase f32 rounds, as much as the
    bright ones."""
    inds = np.arange(len(pos))
    jb = _batch(jnp, pos, inds, i_theta, theta)
    tb = _batch(torch, pos, inds, i_theta, theta)
    out = np.asarray(jmodel.predict(
        {k: jnp.asarray(v) for k, v in params_np.items()}, jb, jcfg,
        return_wave=True))
    g = np.random.default_rng(seed).normal(size=out.shape + (2,)).astype(
        np.float32)

    def jfn(*xs):
        p = {k: jnp.asarray(v) for k, v in params_np.items()}
        p.update(zip(names, xs))
        return _functional(jmodel.predict(p, jb, jcfg, return_wave=True),
                           jnp.asarray(g), jnp)

    def tfn(*xs):
        p = {k: torch.tensor(v) for k, v in params_np.items()}
        p.update(zip(names, xs))
        return _functional(tmodel.predict(p, tb, tcfg, return_wave=True),
                           torch.tensor(g), torch)
    return (_grads_jax(jfn, *[params_np[k] for k in names]),
            _grads_torch(tfn, *[params_np[k] for k in names]))


def _obj(rng, shape):
    return np.stack([rng.random(shape) * 1e-3, rng.random(shape) * 3e-5],
                    -1).astype(np.float32)


@pytest.mark.parametrize('rol', [False, True])
def test_ptychography_tilt_gradients_and_precedence(rol):
    """With tilt on, the model rotates by the angle's three tilts whatever
    ``rotate_out_of_loop`` says (tilt takes precedence), and the gradient
    reaches every tilt of that angle."""
    rng = np.random.default_rng(20)
    n, pn = 12, 12
    geo = dict(obj_size=(n, n, 10), probe_size=(pn, pn), free_prop_cm='inf')
    jc, tc = _cfgs(geo, dict(optimize_tilt=True),
                   dict(rotate_out_of_loop=rol, minibatch_size=1))
    params = {'obj': _obj(rng, (n, n, 10)), 'probe': _probe(pn),
              'tilt_ls': np.asarray([[0.3, 0.5], [0.08, -0.02],
                                     [-0.05, 0.1]], np.float32)}
    jres, tres = _model_grads(jc, tc, params, ['obj', 'tilt_ls'],
                              np.zeros((1, 2)), i_theta=1, theta=0.5)
    _check(jres, tres)
    assert np.all(tres[1][1][:, 0] == 0) and np.all(tres[1][1][:, 1] != 0)


@pytest.mark.parametrize('minus_logged', [False, True])
@pytest.mark.parametrize('raw', ['magnitude', 'intensity'])
def test_ptychography_pure_projection(minus_logged, raw):
    """The projection approximation and the minus-logged line projection
    (the prediction is the image's magnitude), with kappa refined."""
    rng = np.random.default_rng(21)
    n = 12
    geo = dict(obj_size=(n, n, 6), probe_size=(n, n), free_prop_cm=0,
               pure_projection=True, is_minus_logged=minus_logged)
    cfgs = [mod.ReconConfig(geometry=mod.Geometry(**geo),
                            refine=mod.RefineConfig(
                                optimize_ctf_lg_kappa=True),
                            loss=mod.LossConfig(raw_data_type=raw),
                            train=mod.TrainConfig(minibatch_size=1))
            for mod in (jconfig, pt)]
    params = {'obj': _obj(rng, (n, n, 6)), 'probe': _probe(n),
              'ctf_lg_kappa': np.asarray([-1.3], np.float32)}
    jres, tres = _model_grads(*cfgs, params, ['obj', 'ctf_lg_kappa'],
                              np.zeros((1, 2)))
    _check(jres, tres)


def test_ptychography_sparse_slices_and_kappa():
    """Sparse multislice at refined slice positions, and the plain
    multislice under a refined kappa (through K1's plain version)."""
    rng = np.random.default_rng(22)
    n, pn = 16, 12
    pos = np.asarray([[0.0, 0.0], [2.0, 4.0]])
    geo = dict(obj_size=(n, n, 2), probe_size=(pn, pn), free_prop_cm='inf',
               slice_pos_cm_ls=(0.0, 10e-5))
    jc, tc = _cfgs(geo, dict(optimize_slice_pos=True),
                   dict(minibatch_size=2))
    params = {'obj': _obj(rng, (n, n, 2)), 'probe': _probe(pn),
              'slice_pos_cm_ls': np.asarray([0.0, 10e-5], np.float32)}
    _check(*_model_grads(jc, tc, params, ['obj', 'slice_pos_cm_ls'], pos))
    geo = dict(obj_size=(n, n, 8), probe_size=(pn, pn), free_prop_cm='inf',
               binning=2)
    for fused in ('off', 'on'):
        jc, tc = _cfgs(geo, dict(optimize_ctf_lg_kappa=True),
                       dict(minibatch_size=2, fused_multislice=fused))
        params = {'obj': _obj(rng, (n, n, 8)), 'probe': _probe(pn),
                  'ctf_lg_kappa': np.asarray([-1.5], np.float32)}
        _check(*_model_grads(jc, tc, params, ['obj', 'ctf_lg_kappa'], pos))


@pytest.mark.parametrize('kind', ['ctf', 'ctf_kappa', 'pure_projection'])
def test_multidist_new_branches(kind):
    """The multi-distance model with ``forward_algorithm='ctf'`` (at the
    configured kappa, or the refined one) and with the projection
    approximation under a refined kappa; two distances, refined."""
    rng = np.random.default_rng(23)
    n = 16
    geo = dict(obj_size=(n, n, 1), probe_size=(n, n), free_prop_cm=(2e-4,
                                                                    5e-4),
               n_dists=2, two_d_mode=True, safe_zone_width=2,
               pure_projection=kind == 'pure_projection')
    refine = dict(optimize_free_prop=True,
                  optimize_ctf_lg_kappa=kind != 'ctf')
    train = dict(minibatch_size=1, ctf_kappa=25.0,
                 forward_algorithm='fresnel' if kind == 'pure_projection'
                 else 'ctf')
    jc, tc = _cfgs(geo, refine, train)
    params = {'obj': _obj(rng, (n, n, 1)),
              'probe': np.stack([np.ones((n, n)), np.zeros((n, n))],
                                -1)[None].astype(np.float32),
              'free_prop_cm': np.asarray([2e-4, 5e-4], np.float32)}
    names = ['obj', 'free_prop_cm']
    if kind != 'ctf':
        params['ctf_lg_kappa'] = np.asarray([1.3], np.float32)
        names.append('ctf_lg_kappa')
    _check(*_model_grads(jc, tc, params, names, np.zeros((1, 2)),
                         jmodel=jmd, tmodel=tmd))
