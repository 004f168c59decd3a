#!/usr/bin/env python
"""2D ptychography in the Siemens-star APS 2-ID-D configuration, BASELINE
#2, on the port: the JAX package's
``demos/2d_ptychography_experimental_data.py`` through
``adorym_tpu_torch``: real_imag unknown, intensity data, 5 probe modes from
a defocused aperture with a central beamstop, probe intensity rescaling,
probe optimization and per-spot position refinement.

Reads ``demos/siemens_star_aps_2idd/data.h5`` where ``h5py`` imports;
otherwise simulates the Siemens-star dataset in the same geometry (8.8
keV, 1.33 um pixels) with a perturbed probe and scan-position jitter, the
nominal grid recorded, so that probe and position refinement both have
work to do.

    python -m adorym_tpu_torch.demos.2d_ptychography_experimental_data [--device cpu]
"""

import os

import numpy as np

from adorym_tpu_torch.demos import _data

DATA_DIR = os.path.join(_data.DEMOS_DIR, 'siemens_star_aps_2idd')
DATA = os.path.join(DATA_DIR, 'data.h5')

N = 256          # reference object is 618x606; scaled for demo runtime
PN = 72
ENERGY_EV = 8801.121930115722
PSIZE_CM = 1.32789376566526e-06


def siemens_star(n, spokes=24):
    """Spoke-pattern phantom: binary star in an annulus."""
    yy, xx = np.mgrid[0:n, 0:n].astype(float)
    yy -= n / 2
    xx -= n / 2
    r = np.hypot(yy, xx)
    star = (np.sin(spokes * np.arctan2(yy, xx)) > 0).astype(float)
    star *= (r > 6) & (r < n * 0.45)
    from scipy.ndimage import gaussian_filter
    return gaussian_filter(star, 1.0)


def make_probe(perturb=0.0, seed=0):
    from adorym_tpu_torch.utils.initialize import initialize_probe
    probe = initialize_probe(
        (PN, PN), 'aperture_defocus', n_probe_modes=5,
        energy_ev=ENERGY_EV, psize_cm=PSIZE_CM,
        aperture_radius=10, beamstop_radius=5, probe_defocus_cm=0.0069,
        seed=seed)
    if perturb:
        rng = np.random.default_rng(seed + 1)
        probe = probe + perturb * np.abs(probe).max() * rng.normal(
            size=probe.shape).astype(np.float32)
    return probe


def main(n_epochs=500, output_folder='recon_siemens', device=None):
    import adorym_tpu_torch as pt

    rng = np.random.default_rng(0)
    xs = np.arange(0, N - PN + 1, 12)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos_nominal = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)

    def make():
        star = siemens_star(N)
        ph = 0.4 * star
        mag = 1.0 - 0.25 * star
        obj = np.stack([mag * np.cos(ph), mag * np.sin(ph)],
                       -1)[:, :, None, :].astype(np.float32)
        cfg = pt.ReconConfig(
            geometry=pt.Geometry(obj_size=(N, N, 1), probe_size=(PN, PN),
                                 energy_ev=ENERGY_EV, psize_cm=PSIZE_CM,
                                 free_prop_cm='inf', two_d_mode=True),
            train=pt.TrainConfig(minibatch_size=35,
                                 unknown_type='real_imag'))
        # Simulate with the TRUE (perturbed) probe at jittered positions;
        # record the nominal grid, so the reconstruction must refine both.
        probe_true = make_probe(perturb=0.05)
        pos_true = pos_nominal + rng.uniform(-1.5, 1.5, pos_nominal.shape)
        d = pt.simulate(cfg, obj, probe_true, pos_true, device=device)
        # Data is recorded as intensity at the beamline.
        return d ** 2, dict(probe_pos=pos_nominal, energy_ev=ENERGY_EV,
                            psize_cm=PSIZE_CM)

    dataset = _data.measured(DATA, make)
    results = pt.reconstruct_ptychography(
        # Reference params dict (demos/2d_ptychography_experimental_data.py)
        fname=os.path.basename(DATA), save_path=DATA_DIR,
        output_folder=output_folder,
        obj_size=(N, N, 1), two_d_mode=True,
        energy_ev=ENERGY_EV, psize_cm=PSIZE_CM, free_prop_cm='inf',
        n_epochs=n_epochs, minibatch_size=35,
        random_guess_means_sigmas=(1., 0., 0.001, 0.002),
        probe_type='aperture_defocus', n_probe_modes=5,
        aperture_radius=10, beamstop_radius=5, probe_defocus_cm=0.0069,
        rescale_probe_intensity=True, raw_data_type='intensity',
        optimizer='adam', learning_rate=1e-3,
        optimize_probe=True, probe_learning_rate=1e-3,
        optimize_all_probe_pos=True, all_probe_pos_learning_rate=1e-2,
        update_scheme='immediate', unknown_type='real_imag',
        loss_function_type='lsq', use_checkpoint=False,
        save_intermediate=False, device=device, dataset=dataset)

    obj = results['obj']
    mag = np.hypot(obj[..., 0, 0], obj[..., 0, 1])
    phase = np.arctan2(obj[..., 0, 1], obj[..., 0, 0])
    star = siemens_star(N)
    sl = slice(PN // 2, N - PN // 2)
    corr = np.corrcoef(phase[sl, sl].ravel(),
                       (0.4 * star)[sl, sl].ravel())[0, 1]
    m_corr = np.corrcoef(mag[sl, sl].ravel(),
                         (1.0 - 0.25 * star)[sl, sl].ravel())[0, 1]
    print(f'final loss: {results["loss_history"][-1]:.3e}; '
          f'phantom phase correlation: {corr:.3f} '
          f'(magnitude corr {m_corr:.3f})')
    return corr


if __name__ == '__main__':
    main(device=_data.device_parser(__doc__).parse_args().device)
