"""ROADMAP C.7 and C.8, settled on the CPU against float64 and the JAX
package.

    JAX_PLATFORMS=cpu python tools/settle_c7_c8.py [--c8-epochs 2]

C.7, two evaluations from the same numpy inputs, each package in float32
beside a float64 evaluation of the same formulas in numpy:

- the first minibatch's loss of ``tests/test_optimizers.py``'s problem (a
  zero object, the Gaussian probe, simulated weak-object data; 2D, one
  slice, Fraunhofer): ``mean((|fftshift(fft2(P t))| - |d|)^2)`` with
  ``t = exp(-k1 beta) exp(-i k1 delta)``;
- ePIE's first position update with a phaseless starting probe (the
  Gaussian envelope of ``tests/test_torch_conventional.py``'s probe
  without its phase): the updated window and probe.

C.8, 10a's configuration at a CPU size (a 48^3 six-blob phantom, a 16^2
probe on a 9x9 grid at stride 4, binning 2, Fraunhofer, the immediate
scheme, minibatch 23, CG, 2 angles), 2 epochs in both packages: each
batch's loss and CG's suggested step after it (the step the Armijo search
accepted, doubled after a first-trial acceptance).

Prints each number and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def optimizers_problem(mod):
    """``tests/test_optimizers.py``'s small problem (as
    ``tests/test_torch_second_order.py::_optimizers_problem`` builds it)."""
    from scipy.ndimage import gaussian_filter
    import adorym_tpu.config as jcfg
    from adorym_tpu.simulate import simulate
    from adorym_tpu.utils.initialize import initialize_probe
    n, pn = 32, 16

    def cfg(m):
        return m.ReconConfig(
            geometry=m.Geometry(obj_size=(n, n, 1), probe_size=(pn, pn),
                                energy_ev=5000.0, psize_cm=1e-7,
                                free_prop_cm='inf', two_d_mode=True),
            train=m.TrainConfig(minibatch_size=8, learning_rate=1.0,
                                optimizer='cg', randomize_probe_pos=True,
                                seed=0))
    rng = np.random.default_rng(0)
    sm = gaussian_filter(rng.random((n, n, 1)), (3, 3, 0))
    obj_true = np.stack([sm * 2e-3, sm * 5e-5], -1).astype(np.float32)
    probe = initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                             psize_cm=1e-7, probe_mag_sigma=4,
                             probe_phase_sigma=4, probe_phase_max=0.4)
    xs = np.arange(0, n - pn + 1, 4)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    data = np.asarray(simulate(cfg(jcfg), obj_true, probe, pos))
    return cfg(mod), obj_true, np.asarray(probe), pos, data


def loss_f64(obj, probe, pos, meas, cfg, pad_arr):
    """The first-batch loss in float64 numpy: ``obj [y, x, 1, 2]`` padded
    by ``pad_arr`` with vacuum, ``probe [1, py, px, 2]``, window starts
    ``pos`` in the padded object, magnitudes ``meas``."""
    obj = np.pad(obj, [tuple(pad_arr[0]), tuple(pad_arr[1]), (0, 0),
                       (0, 0)])
    from adorym_tpu_torch.ops.propagate import wavelength_nm
    geo = cfg.geometry
    py, px = geo.probe_size
    lam = wavelength_nm(geo.energy_ev)
    delta_nm = geo.psize_cm * 1e7
    k1 = 2 * np.pi * delta_nm / lam if geo.scale_ri_by_k else 1.0
    p = probe[0, ..., 0].astype(np.float64) + 1j * probe[0, ..., 1]
    preds = []
    for y, x in np.round(pos).astype(int):
        w = obj[y:y + py, x:x + px, 0].astype(np.float64)
        t = np.exp(-k1 * w[..., 1]) * np.exp(
            -1j * geo.sign_convention * k1 * w[..., 0])
        preds.append(np.abs(np.fft.fftshift(np.fft.fft2(p * t))))
    pred = np.stack(preds)
    res = pred - np.abs(meas.astype(np.float64))
    # The loss's float32 condition: each magnitude rounded by 2^-24 moves
    # the loss by up to this relative amount.
    cond = 2 * np.mean(np.abs(res) * pred) * 2.0 ** -24 / np.mean(res ** 2)
    return float(np.mean(res ** 2)), pred, float(cond)


def c7_loss():
    """The first minibatch's loss at the zero start: each package's f32
    value and the float64 evaluation."""
    import jax.numpy as jnp
    import adorym_tpu.config as jcfg
    from adorym_tpu.recon import Reconstructor as JR
    import adorym_tpu_torch as pt
    out = {}
    cfg, obj_true, probe, pos, data = optimizers_problem(pt)
    jc, *_ = optimizers_problem(jcfg)
    obj0 = np.zeros_like(obj_true)
    tr = pt.Reconstructor(cfg, data=data, probe_pos=pos, probe_init=probe,
                          obj_init=obj0, device='cpu')
    jr = JR(jc, data=data, probe_pos=pos, probe_init=probe, obj_init=obj0)
    i_theta, inds = tr.make_batches(np.random.default_rng(0))[0]
    meas = data[i_theta][inds]
    out['port_f32'] = float(tr.loss_fn(tr.params, tr._batch(i_theta, inds),
                                       torch.as_tensor(meas)))
    jb = {'i_theta': jnp.asarray(i_theta, jnp.int32),
          'theta': jnp.asarray(0.0, jnp.float32),
          'pos_batch': jnp.asarray(pos[inds], jnp.float32),
          'ind_batch': jnp.asarray(inds, jnp.int32)}
    out['jax_f32'] = float(jr.loss_fn(jr.params, jb, jnp.asarray(meas),
                                      None))
    starts = np.round(pos[inds]) + tr.pad_arr[:, 0]
    out['f64'], pred64, out['f32_condition'] = loss_f64(
        obj0, probe, starts, meas, cfg, tr.pad_arr)
    from adorym_tpu.models import ptychography as jmodel
    preds = {'port': tr.model.predict(tr.params, tr._batch(i_theta, inds),
                                      cfg, tr.pad_arr).numpy(),
             'jax': np.asarray(jmodel.predict(jr.params, jb, jc,
                                              jr.pad_arr))}
    for k, v in preds.items():
        out[f'{k}_pred_rel_err'] = float(np.max(np.abs(v - pred64))
                                         / np.max(pred64))
    # The same at the truth halved, where the packages agree closely (a
    # check of the float64 formula).
    half = obj_true * 0.5
    tr2 = pt.Reconstructor(cfg, data=data, probe_pos=pos, probe_init=probe,
                           obj_init=half, device='cpu')
    out['port_f32_half'] = float(tr2.loss_fn(
        tr2.params, tr2._batch(i_theta, inds), torch.as_tensor(meas)))
    out['f64_half'], _, out['f32_condition_half'] = loss_f64(
        half, probe, starts, meas, cfg, tr.pad_arr)
    for k in ('port_f32', 'jax_f32'):
        out[k + '_rel_err'] = abs(out[k] - out['f64']) / out['f64']
    out['port_f32_half_rel_err'] = (abs(out['port_f32_half']
                                        - out['f64_half']) / out['f64_half'])
    return out


def epie_f64(data, probe, obj, y, x, alpha):
    """One ePIE position update in complex128 (the port's formulas)."""
    py, px = probe.shape
    p = probe.astype(np.complex128)
    o = obj.astype(np.complex128).copy()
    sub = o[y:y + py, x:x + px].copy()
    ex = p * sub
    dp = np.fft.fftshift(np.fft.fft2(ex))
    mag = np.maximum(np.abs(dp), 1e-12)
    d = np.fft.ifft2(np.fft.ifftshift(dp * (data / mag))) - ex
    o[y:y + py, x:x + px] = sub + alpha * np.conj(p) * d / np.max(
        np.abs(p) ** 2)
    p = p + alpha * np.conj(sub) * d / np.max(np.abs(sub) ** 2)
    return o, p


def c7_epie():
    """ePIE's first position update from a phaseless starting probe:
    each package's (f32) updated object and probe against complex128."""
    from adorym_tpu import conventional as jconv
    from adorym_tpu_torch import conventional as tconv
    Y, P = 40, 16
    rng = np.random.default_rng(0)
    obj = (np.exp(0.5j * rng.random((Y, Y)))
           * (0.9 + 0.1 * rng.random((Y, Y)))).astype(np.complex64)
    yy, xx = np.mgrid[:P, :P] - (P - 1) / 2
    probe = (np.exp(-(yy ** 2 + xx ** 2) / 30)
             * np.exp(1j * rng.random((P, P)))).astype(np.complex64)
    pos = np.array([[6, 12]])
    data = np.abs(np.fft.fftshift(np.fft.fft2(
        probe * obj[6:6 + P, 12:12 + P])))[None].astype(np.float32)
    probe0 = np.exp(-(yy ** 2 + xx ** 2) / 40).astype(np.complex64)
    obj0 = np.ones((Y, Y), np.complex64)
    kw = dict(alpha=0.8, n_epochs=1)
    jo, jp = jconv.epie_reconstruct(data, probe0, pos, obj0, **kw)
    to, tp = tconv.epie_reconstruct(data, probe0, pos, obj0, device='cpu',
                                    **kw)
    ro, rp = epie_f64(data[0], probe0, obj0, 6, 12, 0.8)

    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))
    return {'port_obj': rel(to.numpy(), ro), 'jax_obj': rel(jo, ro),
            'port_probe': rel(tp.numpy(), rp), 'jax_probe': rel(jp, rp),
            'port_vs_jax_obj': rel(to.numpy(), np.asarray(jo))}


def blob_phantom(n, seed=0, delta=1e-4, beta=3e-6):
    """``chip_smoke.blob_phantom``: six Gaussian blobs, ``[n, n, n, 2]``."""
    rng = np.random.default_rng(seed)
    g = np.arange(n, dtype=np.float32)[:, None, None]
    vol = np.zeros((n, n, n), np.float32)
    for _ in range(6):
        c = rng.uniform(0.3 * n, 0.7 * n, 3).astype(np.float32)
        r = np.float32(rng.uniform(0.06 * n, 0.16 * n))
        vol += (np.exp(-(g - c[0]) ** 2 / (2 * r * r))
                * np.exp(-(g[:, :, 0][None] - c[1]) ** 2 / (2 * r * r))
                * np.exp(-(g[:, 0, 0][None, None] - c[2]) ** 2
                         / (2 * r * r)))
    vol /= vol.max()
    return np.stack([vol * delta, vol * beta], -1)


def c8_problem(mod, n=48, pn=16, stride=4, binning=2, n_theta=2):
    """10a's configuration at a CPU size; the data simulated by the JAX
    package from the blob phantom (geometry only)."""
    import adorym_tpu.config as jcfg
    from adorym_tpu.simulate import simulate

    def cfg(m, **train):
        return m.ReconConfig(
            geometry=m.Geometry(obj_size=(n,) * 3, probe_size=(pn, pn),
                                energy_ev=5000.0, psize_cm=1e-7,
                                free_prop_cm='inf', binning=binning),
            train=m.TrainConfig(**train))
    xs = np.arange(0, n - pn + 1, stride)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    theta = np.linspace(0, np.pi, n_theta, endpoint=False)
    yy, xx = np.mgrid[:pn, :pn] - (pn - 1) / 2
    spot = np.exp(-(yy ** 2 + xx ** 2) / (2 * (pn / 4) ** 2))
    prng = np.random.default_rng(11)
    probe = np.stack([spot + prng.normal(0, 0.02, spot.shape),
                      prng.normal(0, 0.02, spot.shape)], -1)[None]
    probe = probe.astype(np.float32)
    data = np.asarray(simulate(cfg(jcfg), blob_phantom(n), probe, pos,
                               theta))
    obj0 = (np.random.default_rng(8).random((n,) * 3 + (2,),
                                            dtype=np.float32)
            * np.float32(1e-6))
    train = dict(minibatch_size=23, optimizer='cg',
                 update_scheme='immediate')
    return cfg(mod, **train), dict(data=data, probe_pos=pos, theta_ls=theta,
                                   obj_init=obj0, probe_init=probe)


def c8(n_epochs=2):
    """Per-batch losses and CG's suggested step after each batch (the
    accepted step, doubled after a first-trial acceptance) in both
    packages."""
    import adorym_tpu.config as jcfg
    from adorym_tpu.recon import Reconstructor as JR
    import adorym_tpu_torch as pt
    out = {}
    for name, mod, R, dev in (('jax', jcfg, JR, {}),
                              ('port', pt, pt.Reconstructor,
                               {'device': 'cpu'})):
        cfg, kw = c8_problem(mod)
        rec = R(cfg, **kw, **dev)
        steps = []
        if name == 'jax':
            step = rec._step

            def spy(*a, _step=step):
                res = _step(*a)
                steps.append(float(res[1]['obj']['alpha_suggested']))
                return res
            rec._step = spy
        else:
            step = rec.second_order_step

            def spy(*a, _step=step, _rec=rec):
                res = _step(*a)
                steps.append(float(_rec.opt_state['obj']['alpha_suggested']))
                return res
            rec.second_order_step = spy
        losses = []
        for ep in range(n_epochs):
            rec.run_epoch(ep, callback=lambda e, b, loss:
                          losses.append(float(loss)))
        out[name] = {'losses': losses, 'suggested': steps}
    jl, tl = np.asarray(out['jax']['losses']), np.asarray(
        out['port']['losses'])
    out['loss_rel_diff'] = (np.abs(tl - jl) / np.abs(jl)).tolist()
    ja, ta = np.asarray(out['jax']['suggested']), np.asarray(
        out['port']['suggested'])
    out['step_rel_diff'] = (np.abs(ta - ja) / np.abs(ja)).tolist()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--c8-epochs', type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(1)
    res = {'c7_loss': c7_loss(), 'c7_epie': c7_epie(),
           'c8': c8(args.c8_epochs)}
    for k, v in res['c7_loss'].items():
        print(f'C.7 first-batch loss {k}: {v!r}')
    for k, v in res['c7_epie'].items():
        print(f'C.7 ePIE first update, largest error / largest value, {k}: '
              f'{v:.3e}')
    c = res['c8']
    for name in ('jax', 'port'):
        print(f"C.8 {name}: batch losses {c[name]['losses']}")
        print(f"C.8 {name}: suggested steps {c[name]['suggested']}")
    print(f"C.8 loss relative differences {c['loss_rel_diff']}")
    print(f"C.8 suggested-step relative differences {c['step_rel_diff']}")
    print(json.dumps(res))


if __name__ == '__main__':
    main()
