#!/usr/bin/env python
"""64^3 full-field multislice tomography, BASELINE #1 (the reference's CI
configuration), on the port: the JAX package's
``demos/multislice_tomography_64.py`` through ``adorym_tpu_torch``: plane
probe, ``free_prop_cm=0``, reweighted L1, Adam.

Reads ``demos/adhesin/data_adhesin_64_theta_36.h5`` where ``h5py`` imports;
without it, simulates the adhesin-like blob phantom's data in memory.

    python -m adorym_tpu_torch.demos.multislice_tomography_64 [--device cpu]
"""

import os

import numpy as np

from adorym_tpu_torch.demos import _data

N = 64
DATA = os.path.join(_data.DEMOS_DIR, 'adhesin', 'data_adhesin_64_theta_36.h5')


def make_phantom():
    rng = np.random.default_rng(0)
    zz, yy, xx = np.mgrid[:N, :N, :N].astype(np.float32)
    vol = np.zeros((N, N, N), np.float32)
    for _ in range(6):
        c = rng.uniform(0.3 * N, 0.7 * N, 3)
        r = rng.uniform(0.06 * N, 0.16 * N)
        vol += np.exp(-(((zz - c[0]) ** 2 + (yy - c[1]) ** 2
                         + (xx - c[2]) ** 2) / (2 * r ** 2)))
    vol /= vol.max()
    return np.stack([vol * 1e-3, vol * 3e-5], -1).astype(np.float32)


def main(n_epochs=10, n_theta=36, output_folder='recon_tomo64', data=None,
         device=None):
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.utils.initialize import initialize_probe

    data = data or DATA
    phantom = make_phantom()

    def make():
        cfg = pt.ReconConfig(
            geometry=pt.Geometry(obj_size=(N, N, N), probe_size=(N, N),
                                 energy_ev=800.0, psize_cm=0.67e-7,
                                 free_prop_cm=None),
            train=pt.TrainConfig(minibatch_size=1))
        probe = initialize_probe((N, N), 'plane')
        theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
        pos = np.array([[0.0, 0.0]])
        d = pt.simulate(cfg, phantom, probe, pos, theta_ls=theta,
                        device=device)
        return d, dict(theta=theta, probe_pos=pos, energy_ev=800.0,
                       psize_cm=0.67e-7)

    dataset = _data.measured(data, make)
    results = pt.reconstruct_ptychography(
        fname=os.path.basename(data),
        save_path=os.path.dirname(data),
        output_folder=output_folder,
        obj_size=(N, N, N),
        n_epochs=n_epochs,
        learning_rate=5e-6,
        alpha_d=1e-9 * N ** 3,
        alpha_b=1e-10 * N ** 3,
        reweighted_l1=True,
        energy_ev=800,
        psize_cm=0.67e-7,
        minibatch_size=1,
        free_prop_cm=0,
        probe_type='plane',
        probe_pos=[(0, 0)],
        optimizer='adam',
        use_checkpoint=False,
        device=device, dataset=dataset,
    )
    print('loss history:', results['loss_history'])
    corr = np.corrcoef(results['obj'][..., 0].ravel(),
                       phantom[..., 0].ravel())[0, 1]
    print(f'phantom delta correlation: {corr:.4f}')
    return corr


if __name__ == '__main__':
    main(device=_data.device_parser(__doc__).parse_args().device)
