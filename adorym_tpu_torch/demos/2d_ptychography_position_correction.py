#!/usr/bin/env python
"""2D ptychography with probe-position-error refinement, the cameraman
configuration (BASELINE #3), on the port: the JAX package's
``demos/2d_ptychography_position_correction.py`` through
``adorym_tpu_torch``: data simulated at perturbed positions, the nominal
grid recorded, reconstructed with ``optimize_all_probe_pos`` recovering the
perturbations.

    python -m adorym_tpu_torch.demos.2d_ptychography_position_correction [--device cpu]
"""

import os

import numpy as np

from adorym_tpu_torch.demos import _data

N, PN = 128, 64
DATA = os.path.join(_data.DEMOS_DIR, 'cameraman_pos_error',
                    'data_cameraman_err.h5')


def problem():
    """The demo's draws, in its order: the nominal grid, the true
    (perturbed) positions and the object ``[N, N, 1, 2]``."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(0)
    xs = np.arange(0, N - PN + 1, 12)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos_nominal = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    pos_true = pos_nominal + rng.uniform(-2, 2, pos_nominal.shape)
    img = gaussian_filter(rng.random((N, N, 1)), (5, 5, 0))
    img = (img - img.min()) / max(np.ptp(img), 1e-12)
    obj = np.stack([img * 3e-3, img * 8e-5], -1).astype(np.float32)
    return pos_nominal, pos_true, obj


def main(device=None):
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.utils.initialize import initialize_probe

    pos_nominal, pos_true, obj = problem()

    def make():
        cfg = pt.ReconConfig(
            geometry=pt.Geometry(obj_size=(N, N, 1), probe_size=(PN, PN),
                                 energy_ev=5000.0, psize_cm=1e-7,
                                 free_prop_cm='inf', two_d_mode=True),
            train=pt.TrainConfig(minibatch_size=len(pos_true)))
        probe = initialize_probe((PN, PN), 'gaussian', energy_ev=5000.0,
                                 psize_cm=1e-7, probe_mag_sigma=10,
                                 probe_phase_sigma=10, probe_phase_max=0.4)
        # Simulate at the TRUE (perturbed) positions, store the NOMINAL
        # grid as metadata: the reconstruction must recover the
        # perturbations.
        d = pt.simulate(cfg, obj, probe, pos_true, device=device)
        return d, dict(probe_pos=pos_nominal, energy_ev=5000.0,
                       psize_cm=1e-7)

    dataset = _data.measured(DATA, make)
    results = pt.reconstruct_ptychography(
        fname=os.path.basename(DATA),
        save_path=os.path.dirname(DATA),
        output_folder='recon_poscorr',
        obj_size=(N, N, 1), two_d_mode=True,
        n_epochs=40, learning_rate=2e-4,
        minibatch_size=16, free_prop_cm='inf',
        probe_type='gaussian', probe_mag_sigma=10, probe_phase_sigma=10,
        probe_phase_max=0.4,
        optimize_all_probe_pos=True, all_probe_pos_learning_rate=1e-2,
        use_checkpoint=False, device=device, dataset=dataset,
    )
    if 'probe_pos_correction' in results:
        rec_corr = results['probe_pos_correction'][0]
        true_err = pos_true - pos_nominal
        true_err = true_err - true_err.mean(0)
        resid = np.abs(rec_corr - true_err).mean()
        print(f'mean residual position error: {resid:.2f} px '
              f'(initial {np.abs(true_err).mean():.2f} px)')
    print('final loss:', results['loss_history'][-1])


if __name__ == '__main__':
    main(device=_data.device_parser(__doc__).parse_args().device)
