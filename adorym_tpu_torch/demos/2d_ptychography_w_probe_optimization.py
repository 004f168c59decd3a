#!/usr/bin/env python
"""2D ptychography with probe retrieval, the cameraman probe-optimization
configuration, on the port: the JAX package's
``demos/2d_ptychography_w_probe_optimization.py`` through
``adorym_tpu_torch``: phase-only object, a dense scan grid that runs past
the object's edge, the probe initialized by back-propagating the mean
measured magnitude (``probe_type='ifft'``) and refined jointly with the
object and all probe positions.

The data are simulated with a structured "true" probe quite unlike the
ifft guess, so probe retrieval has work to do; the off-edge scan positions
exercise the vacuum out-of-bounds windows.

    python -m adorym_tpu_torch.demos.2d_ptychography_w_probe_optimization [--device cpu]
"""

import os

import numpy as np

from adorym_tpu_torch.demos import _data

DATA_DIR = os.path.join(_data.DEMOS_DIR, 'cameraman_probe_opt')
DATA = os.path.join(DATA_DIR, 'data_cameraman_probe.h5')

N = 128                       # reference object is 256^2; scaled for runtime
PN = 64                       # reference probe is 72^2
ENERGY_EV = 5000.0
PSIZE_CM = 1.0e-7


def phantom(n, seed=7):
    """Smooth phase phantom (phase-only object: |o| = 1)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, n, 1))
    ph = gaussian_filter(base, (3, 3, 0)) - gaussian_filter(base, (9, 9, 0))
    ph = ph / np.abs(ph).max() * 0.5
    return np.stack([np.cos(ph), np.sin(ph)], -1).astype(np.float32)


def true_probe(seed=1):
    """Structured illumination: defocused aperture with astigmatism-like
    phase, deliberately far from the ifft initialization."""
    from adorym_tpu_torch.utils.initialize import initialize_probe
    probe = initialize_probe(
        (PN, PN), 'aperture_defocus', energy_ev=ENERGY_EV,
        psize_cm=PSIZE_CM, aperture_radius=12, probe_defocus_cm=0.004,
        seed=seed)                                # [n_modes, py, px, 2]
    wave = probe[..., 0] + 1j * probe[..., 1]
    yy, xx = np.mgrid[0:PN, 0:PN].astype(np.float32)
    yy = (yy - PN / 2) / PN
    xx = (xx - PN / 2) / PN
    wave = wave * np.exp(1j * 4.0 * (yy ** 2 - xx ** 2))
    return np.stack([wave.real, wave.imag], -1).astype(np.float32)


def main(n_epochs=300, output_folder='recon_probe_opt', device=None):
    import adorym_tpu_torch as pt

    # Dense grid running past the object edge on every side, like the
    # reference's arange(-10, 246, 5) scan.
    xs = np.arange(-8, N - PN + 9, 8)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)

    obj_true = phantom(N)                          # [y, x, 1, 2]

    def make():
        cfg = pt.ReconConfig(
            geometry=pt.Geometry(obj_size=(N, N, 1), probe_size=(PN, PN),
                                 energy_ev=ENERGY_EV, psize_cm=PSIZE_CM,
                                 free_prop_cm='inf', two_d_mode=True),
            train=pt.TrainConfig(minibatch_size=64,
                                 unknown_type='real_imag'))
        d = pt.simulate(cfg, obj_true, true_probe(), pos, device=device)
        return d, dict(probe_pos=pos, energy_ev=ENERGY_EV,
                       psize_cm=PSIZE_CM)

    dataset = _data.measured(DATA, make)
    results = pt.reconstruct_ptychography(
        # Reference params dict (demos/2d_ptychography_w_probe_optimization)
        fname=os.path.basename(DATA), save_path=DATA_DIR,
        output_folder=output_folder,
        obj_size=(N, N, 1), two_d_mode=True,
        energy_ev=ENERGY_EV, psize_cm=PSIZE_CM, free_prop_cm='inf',
        n_epochs=n_epochs, minibatch_size=64,
        probe_type='ifft',                        # probe <- ifft(mean |data|)
        optimize_probe=True, probe_learning_rate=4e-3,
        optimize_all_probe_pos=True, all_probe_pos_learning_rate=1e-2,
        object_type='phase_only',
        optimizer='adam', learning_rate=4e-3,
        update_scheme='immediate', unknown_type='real_imag',
        loss_function_type='lsq', use_checkpoint=False,
        save_intermediate=False, device=device, dataset=dataset)

    obj = results['obj']
    phase = np.arctan2(obj[..., 0, 1], obj[..., 0, 0])
    truth = np.arctan2(obj_true[..., 0, 1], obj_true[..., 0, 0])
    sl = slice(PN // 4, N - PN // 4)
    p0, t0 = phase[sl, sl].ravel(), truth[sl, sl].ravel()
    corr = np.corrcoef(p0, t0)[0, 1]

    # Probe retrieval quality: complex correlation with the true probe, up
    # to the global phase and scale ambiguity of ptychography.
    pr = results['probe'][0]
    probe_rec = pr[..., 0] + 1j * pr[..., 1]
    pt0 = true_probe()[0]
    ptc = pt0[..., 0] + 1j * pt0[..., 1]
    num = np.abs(np.vdot(ptc, probe_rec))
    den = np.linalg.norm(ptc) * np.linalg.norm(probe_rec)
    probe_corr = float(num / max(den, 1e-12))
    print(f'final loss: {results["loss_history"][-1]:.3e}; '
          f'phantom phase correlation: {corr:.3f}; '
          f'probe correlation: {probe_corr:.3f}')
    return corr, probe_corr


if __name__ == '__main__':
    main(device=_data.device_parser(__doc__).parse_args().device)
