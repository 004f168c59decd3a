#!/usr/bin/env python
"""256^3 cone multislice ptychotomography, the flagship configuration
(BASELINE #5), on the port: the JAX package's
``demos/multislice_ptycho_256_theta.py`` (reference: 500 angles, 23x23
positions an angle, 72^2 probe, Fraunhofer, binning 8) through
``adorym_tpu_torch``.

Simulates the cone phantom's data at a reduced angle count when the data
file is absent (or, without ``h5py``, in memory); ``--n-theta`` scales it.
The run takes the per-angle path with the rotation out of the loop, one
grid row a minibatch: K1 (``csrc/multislice_db_stored.cu``) and K2
(``csrc/grid_scatter.cu``) once a gradient chunk on the card.

    python -m adorym_tpu_torch.demos.multislice_ptycho_256_theta [--device cpu]
"""

import os

import numpy as np

from adorym_tpu_torch.demos import _data

N, PN, MB, BIN = 256, 72, 23, 8


def cone_phantom(n=N):
    s = n / N
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(np.float32)
    c = (n - 1) / 2
    r = np.sqrt((yy - c) ** 2 + (xx - c) ** 2)
    cone = ((r < (zz + 20 * s) * 0.3) & (zz > 30 * s)
            & (zz < 220 * s)).astype(np.float32)
    from scipy.ndimage import gaussian_filter
    cone = gaussian_filter(cone, max(1.0, 2 * s))
    return np.stack([cone * 1e-4, cone * 3e-6], -1).astype(np.float32)


def geometry(scale=1):
    """Flagship geometry, optionally shrunk by ``scale`` (CI runs the same
    code path, angle-fused per-angle updates, binning and a grid scan, at
    scale 4)."""
    n = N // scale
    pn = PN // scale if scale == 1 else 24
    grid = (n - pn) // 8 + 1
    xs = np.arange(grid) * 8 + (n - (grid - 1) * 8 - pn) // 2
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    return n, pn, grid, pos


def main(n_theta=20, n_epochs=2, data=None, scale=1,
         output_folder='recon_cone256', device=None):
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.utils.initialize import initialize_probe

    n, pn, grid, pos = geometry(scale)
    mb = grid  # one grid row per minibatch (the fast-path decomposition)
    binning = BIN if scale == 1 else 4
    data = data or os.path.join(_data.DEMOS_DIR, 'cone_256',
                                f'data_cone_{n}.h5')
    phantom = cone_phantom(n)
    sigma = 12 / scale

    def make():
        cfg = pt.ReconConfig(
            geometry=pt.Geometry(obj_size=(n, n, n), probe_size=(pn, pn),
                                 energy_ev=5000.0, psize_cm=1e-7,
                                 free_prop_cm='inf', binning=binning),
            train=pt.TrainConfig(minibatch_size=mb))
        probe = initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                                 psize_cm=1e-7, probe_mag_sigma=sigma,
                                 probe_phase_sigma=sigma,
                                 probe_phase_max=0.4)
        theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
        d = pt.simulate(cfg, phantom, probe, pos, theta_ls=theta,
                        minibatch_size=mb * 4, device=device)
        return d, dict(theta=theta, probe_pos=pos, energy_ev=5000.0,
                       psize_cm=1e-7)

    dataset = _data.measured(data, make)
    results = pt.reconstruct_ptychography(
        fname=os.path.basename(data),
        save_path=os.path.dirname(data),
        output_folder=output_folder,
        obj_size=(n, n, n),
        n_epochs=n_epochs,
        learning_rate=1e-7,
        energy_ev=5000.0, psize_cm=1e-7,
        minibatch_size=mb, binning=binning,
        free_prop_cm='inf',
        probe_type='gaussian', probe_mag_sigma=sigma,
        probe_phase_sigma=sigma, probe_phase_max=0.4,
        optimizer='adam',
        rotate_out_of_loop=True, update_scheme='per angle',
        use_checkpoint=False,
        # The reference's default cadence (10 batches) checkpoints every
        # angle here; each checkpoint moves the object and Adam's moments
        # to the host.
        n_batch_per_checkpoint=mb * 30,
        device=device, dataset=dataset,
    )
    print('loss history:', results['loss_history'])
    corr = np.corrcoef(results['obj'][..., 0].ravel(),
                       phantom[..., 0].ravel())[0, 1]
    print(f'phantom delta correlation: {corr:.4f}')
    return corr


if __name__ == '__main__':
    p = _data.device_parser(__doc__)
    p.add_argument('--n-theta', type=int, default=20)
    p.add_argument('--n-epochs', type=int, default=2)
    p.add_argument('--scale', type=int, default=1,
                   help='shrink the geometry by this factor (CI: 4)')
    p.add_argument('--data', default=None)
    args = p.parse_args()
    main(n_theta=args.n_theta, n_epochs=args.n_epochs, data=args.data,
         scale=args.scale, device=args.device)
