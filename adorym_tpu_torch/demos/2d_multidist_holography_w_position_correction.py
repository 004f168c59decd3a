#!/usr/bin/env python
"""Multi-distance near-field holography with per-distance registration
refinement, the cameraman multi-distance position-correction
configuration, on the port: the JAX package's
``demos/2d_multidist_holography_w_position_correction.py`` through
``adorym_tpu_torch``: intensity holograms at several propagation distances
whose frames are mutually misregistered by small translations; the
reconstruction refines one registration shift per distance
(``optimize_all_probe_pos``: in multi-distance mode
``probe_pos_correction`` has shape ``[n_dists, 2]`` and is applied to the
measured data).

The holograms are simulated at the true distances and then shifted by the
true per-distance misregistrations, so the refinement has real errors to
recover.

    python -m adorym_tpu_torch.demos.2d_multidist_holography_w_position_correction [--device cpu]
"""

import os

import numpy as np

from adorym_tpu_torch.demos import _data

DATA_DIR = os.path.join(_data.DEMOS_DIR, 'cameraman_multidist')
DATA = os.path.join(DATA_DIR, 'data_shift.h5')

N = 128                      # reference is 512^2; scaled for demo runtime
ENERGY_EV = 17500.0
PSIZE_CM = 1e-5
DISTS = (0.05, 0.12, 0.3, 0.7)     # cm
# True per-distance misregistrations in px (distance 0 is the anchor frame).
SHIFTS_TRUE = np.array([
    [0.0, 0.0],
    [1.4, -0.8],
    [-1.1, 0.9],
    [0.7, 1.3],
])


def phantom(n, seed=3):
    """Band-limited phantom: in-line holography's CTF sin-term vanishes at
    low spatial frequency, so keep the power in the transferred band."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, n, 1))
    ph = gaussian_filter(base, (2, 2, 0)) - gaussian_filter(base, (6, 6, 0))
    ph = ph / np.abs(ph).max() * 0.5
    mg = rng.random((n, n, 1))
    mag = np.clip(1.0 - (gaussian_filter(mg, (2, 2, 0))
                         - gaussian_filter(mg, (6, 6, 0))), 0.7, 1.0)
    return np.stack([mag * np.cos(ph), mag * np.sin(ph)], -1).astype(np.float32)


def main(n_epochs=300, output_folder='recon_multidist_posopt', device=None):
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.models import multidist
    from adorym_tpu_torch.utils.initialize import initialize_probe

    obj_true = phantom(N)

    def make():
        cfg = pt.ReconConfig(
            geometry=pt.Geometry(obj_size=(N, N, 1), probe_size=(N, N),
                                 energy_ev=ENERGY_EV, psize_cm=PSIZE_CM,
                                 free_prop_cm=DISTS, n_dists=len(DISTS),
                                 two_d_mode=True, safe_zone_width=0),
            train=pt.TrainConfig(minibatch_size=1,
                                 unknown_type='real_imag'))
        probe = initialize_probe((N, N), 'plane')
        pos = np.array([[0.0, 0.0]])
        data = pt.simulate(cfg, obj_true, probe, pos, model=multidist,
                           device=device)
        # Shift each distance's hologram by its true misregistration (the
        # measured frames are out of register; the reconstruction shifts
        # the DATA back, matching the reference's loss-side registration).
        from scipy.ndimage import shift as nd_shift
        for d in range(1, len(DISTS)):
            data[0, d] = nd_shift(data[0, d], SHIFTS_TRUE[d], order=1,
                                  mode='nearest')
        return data ** 2, dict(probe_pos=pos, energy_ev=ENERGY_EV,
                               psize_cm=PSIZE_CM, free_prop_cm=DISTS)

    dataset = _data.measured(DATA, make)
    results = pt.reconstruct_ptychography(
        # Reference params dict
        # (demos/2d_multidist_holography_w_position_correction.py)
        fname=os.path.basename(DATA), save_path=DATA_DIR,
        output_folder=output_folder,
        obj_size=(N, N, 1), two_d_mode=True,
        energy_ev=ENERGY_EV, psize_cm=PSIZE_CM,
        free_prop_cm=DISTS, safe_zone_width=0,
        n_epochs=n_epochs, minibatch_size=1,
        random_guess_means_sigmas=(1., 0., 0., 0.01),
        probe_type='plane', optimize_probe=False,
        optimizer='adam', learning_rate=1e-2,
        optimize_all_probe_pos=True, all_probe_pos_learning_rate=1e-1,
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
    if 'probe_pos_correction' in results:
        rec = np.asarray(results['probe_pos_correction'])
        # The refined shifts are determined up to a common translation
        # (the object can absorb a global shift): compare relative to the
        # anchor frame 0, SIGNED: the refinement shifts the measured frame
        # BY the correction, so undoing a +s misregistration lands at -s.
        rel_rec = rec - rec[0]
        rel_true = SHIFTS_TRUE - SHIFTS_TRUE[0]
        err0 = np.abs(rel_true[1:]).mean()
        err1 = np.abs(rel_rec[1:] + rel_true[1:]).mean()
        msg = (f'; misregistration |err| {err0:.2f} px, residual '
               f'{err1:.2f} px')
    print(f'final loss: {results["loss_history"][-1]:.3e}; '
          f'phantom phase correlation: {corr:.3f}{msg}')
    return corr


if __name__ == '__main__':
    main(device=_data.device_parser(__doc__).parse_args().device)
