#!/usr/bin/env python
"""Multi-distance near-field holography with affine and free-prop
refinement, BASELINE #4, on the port: the JAX package's
``demos/2d_multidist_holography_w_affine.py`` through ``adorym_tpu_torch``:
real_imag unknown, intensity holograms at several propagation distances,
plane probe, reconstructing while refining the propagation distances
(``optimize_free_prop``) and per-distance affine registration
(``optimize_prj_affine``).

Reads ``demos/cameraman_affine/data_nonoise.h5`` where ``h5py`` imports;
otherwise simulates the holograms at the TRUE distances, warped by small
per-distance affine transforms.  The reconstruction starts from perturbed
distances, so both refinements have real errors to recover.

    python -m adorym_tpu_torch.demos.2d_multidist_holography_w_affine [--device cpu]
"""

import os

import numpy as np

from adorym_tpu_torch.demos import _data

DATA_DIR = os.path.join(_data.DEMOS_DIR, 'cameraman_affine')
DATA = os.path.join(DATA_DIR, 'data_nonoise.h5')

N = 128                      # reference is 512^2; scaled for demo runtime
ENERGY_EV = 17500.0
PSIZE_CM = 1e-5
DISTS_TRUE = (0.05, 0.12, 0.3, 0.7)     # cm
# Small per-distance affine misregistrations baked into the "measured" data
# (distance 0 stays identity, as the reconstruction pins it).
AFFINES_TRUE = np.array([
    [[1.000, 0.000, 0.0], [0.000, 1.000, 0.0]],
    [[1.004, 0.002, 0.6], [-0.002, 1.004, -0.4]],
    [[0.996, -0.003, -0.5], [0.003, 0.996, 0.7]],
    [[1.006, 0.001, 0.3], [-0.001, 0.994, 0.5]],
])


def phantom(n, seed=3):
    """Band-limited phantom (difference of Gaussians): in-line holography's
    CTF sin-term vanishes at low spatial frequency at every distance, so a
    smooth phantom's large-scale phase is physically undetermined; keep
    the power in the transferred band."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, n, 1))
    ph = gaussian_filter(base, (2, 2, 0)) - gaussian_filter(base, (6, 6, 0))
    ph = ph / np.abs(ph).max() * 0.5
    mg = rng.random((n, n, 1))
    mag = np.clip(1.0 - (gaussian_filter(mg, (2, 2, 0))
                         - gaussian_filter(mg, (6, 6, 0))), 0.7, 1.0)
    return np.stack([mag * np.cos(ph), mag * np.sin(ph)], -1).astype(np.float32)


def main(n_epochs=400, output_folder='recon_multidist_affine', device=None):
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.models import multidist
    from adorym_tpu_torch.utils.initialize import initialize_probe

    obj_true = phantom(N)

    def make():
        cfg = pt.ReconConfig(
            geometry=pt.Geometry(obj_size=(N, N, 1), probe_size=(N, N),
                                 energy_ev=ENERGY_EV, psize_cm=PSIZE_CM,
                                 free_prop_cm=DISTS_TRUE,
                                 n_dists=len(DISTS_TRUE), two_d_mode=True,
                                 safe_zone_width=0),
            train=pt.TrainConfig(minibatch_size=1,
                                 unknown_type='real_imag'))
        probe = initialize_probe((N, N), 'plane')
        pos = np.array([[0.0, 0.0]])
        data = pt.simulate(cfg, obj_true, probe, pos, model=multidist,
                           device=device)
        # Warp each distance's hologram by its true affine (the measured
        # frames are misregistered; the reconstruction transforms the
        # DATA, matching the reference's loss-side registration).
        from scipy.ndimage import affine_transform
        for d in range(1, len(DISTS_TRUE)):
            a = AFFINES_TRUE[d]
            data[0, d] = affine_transform(data[0, d], a[:, :2],
                                          offset=a[:, 2], order=1,
                                          mode='nearest')
        return data ** 2, dict(probe_pos=pos, energy_ev=ENERGY_EV,
                               psize_cm=PSIZE_CM, free_prop_cm=DISTS_TRUE)

    dataset = _data.measured(DATA, make)
    # Start from perturbed distances; free-prop refinement must recover.
    dists_wrong = tuple(d * 1.06 for d in DISTS_TRUE)
    results = pt.reconstruct_ptychography(
        # Reference params dict (demos/2d_multidist_holography_w_affine.py)
        fname=os.path.basename(DATA), save_path=DATA_DIR,
        output_folder=output_folder,
        obj_size=(N, N, 1), two_d_mode=True,
        energy_ev=ENERGY_EV, psize_cm=PSIZE_CM,
        free_prop_cm=dists_wrong, safe_zone_width=0,
        n_epochs=n_epochs, minibatch_size=1,
        random_guess_means_sigmas=(1., 0., 0., 0.01),
        probe_type='plane', optimize_probe=False,
        optimizer='adam', learning_rate=1e-2,
        optimize_free_prop=True, free_prop_learning_rate=1e-3,
        optimize_prj_affine=True, prj_affine_learning_rate=1e-3,
        randomize_probe_pos=True,
        update_scheme='immediate', unknown_type='real_imag',
        raw_data_type='intensity', loss_function_type='lsq',
        use_checkpoint=False, save_intermediate=False,
        device=device, dataset=dataset)

    obj = results['obj']
    phase = np.arctan2(obj[..., 0, 1], obj[..., 0, 0])
    truth = np.arctan2(obj_true[..., 0, 1], obj_true[..., 0, 0])
    sl = slice(8, N - 8)
    corr = np.corrcoef(phase[sl, sl].ravel(), truth[sl, sl].ravel())[0, 1]
    msg = ''
    if 'free_prop_cm' in results:
        d_rec = np.asarray(results['free_prop_cm'])
        err0 = np.abs(np.asarray(dists_wrong) - DISTS_TRUE).mean()
        err1 = np.abs(d_rec - DISTS_TRUE).mean()
        msg = f'; dist err {err0:.4f} -> {err1:.4f} cm'
    print(f'final loss: {results["loss_history"][-1]:.3e}; '
          f'phantom phase correlation: {corr:.3f}{msg}')
    return corr


if __name__ == '__main__':
    main(device=_data.device_parser(__doc__).parse_args().device)
