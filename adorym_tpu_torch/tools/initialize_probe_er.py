#!/usr/bin/env python
"""Retrieve an initial probe from averaged far-field data by error
reduction, on the port (the JAX package's ``tools/initialize_probe_er.py``):
averages the diffraction patterns of one angle, then iterates Fienup error
reduction with a disk finite-support mask (magnitudes outside the support
damped by ``beta``) in torch on the device.  Writes probe magnitude and
phase TIFFs usable as ``probe_type='supplied'`` input.

    python -m adorym_tpu_torch.tools.initialize_probe_er data.h5 [--device cpu]
"""

import argparse

import numpy as np
import torch


def retrieve_probe(mean_dp_mag, mask_radius, n_epochs=100, beta=0.8,
                   seed=0, device=None):
    """``mean_dp_mag``: [py, px] mean detected magnitude.  Returns the
    complex probe (a host array) and the last epoch's far-field MSE, on
    ``device`` (CUDA unless ``'cpu'`` is passed)."""
    from adorym_tpu_torch.ops.fourier import fft2, fftshift2, ifft2, ifftshift2
    from adorym_tpu_torch.recon import resolve_device

    dev = resolve_device(device)
    shape = mean_dp_mag.shape
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    c = ((shape[0] - 1) / 2, (shape[1] - 1) / 2)
    mask = ((yy - c[0]) ** 2 + (xx - c[1]) ** 2
            <= mask_radius ** 2).astype(np.float32)
    beta_mask = mask + (-beta) * (1 - mask)

    rng = np.random.default_rng(seed)
    probe0 = (rng.normal(1, 0.1, shape)
              + np.exp(1j * rng.normal(0, 0.1, shape))) * mask

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    probe = torch.complex(t(np.real(probe0)), t(np.imag(probe0)))
    img, mask, beta_mask = t(mean_dp_mag), t(mask), t(beta_mask)
    mse = None
    for _ in range(n_epochs):
        f = fftshift2(fft2(probe))
        mag = torch.abs(f)
        mse = torch.mean((mag - img) ** 2)
        f = f / torch.clamp(mag, min=1e-12) * img
        probe = (1 - mask) * probe + beta_mask * ifft2(ifftshift2(f))
    probe = probe.cpu().numpy()
    return (probe.real.astype(np.float64) + 1j * probe.imag, float(mse))


def main(argv=None):
    from adorym_tpu_torch.io.data import _h5py
    from adorym_tpu_torch.io.output import write_tiff
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('fname', help='Adorym-layout HDF5')
    p.add_argument('--n_epochs', type=int, default=100)
    p.add_argument('--beta', type=float, default=0.8)
    p.add_argument('--mask_radius', type=int, default=64)
    p.add_argument('--normalize', action='store_true')
    p.add_argument('--raw_data_type', default='intensity')
    p.add_argument('--out_prefix', default='guessed_probe')
    p.add_argument('--device', default=None,
                   help="'cpu' to run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    with _h5py().File(args.fname, 'r') as f:
        img = np.mean(np.abs(f['exchange/data'][0]), axis=0)
    if args.raw_data_type == 'intensity':
        img = np.sqrt(img)
    if args.normalize:
        img = img / np.sqrt(img.size)
    probe, mse = retrieve_probe(img, args.mask_radius, args.n_epochs,
                                args.beta, device=args.device)
    write_tiff(np.abs(probe), args.out_prefix + '_mag')
    write_tiff(np.angle(probe), args.out_prefix + '_phase')
    print(f'final MSE {mse:.4e}; wrote {args.out_prefix}_mag/phase.tiff')
    return probe


if __name__ == '__main__':
    main()
