"""Ptychography / ptychotomography forward model
(``adorym_tpu/models/ptychography.py``): the probe with its refinements
(defocus, per-angle position offset, per-spot position correction as
per-spot waves); the plain multislice branch (delta_beta or real_imag)
with the detector propagation handed to the propagator where nothing sits
between the exit wave and the detector; the projection approximation
(with the minus-logged line projections of absorption tomography) and
sparse multislice at (refinable) slice positions; the single-material
kappa (``beta = 10**ctf_lg_kappa * delta``); and the exit wave's refined
projection offset and propagation distance.  :func:`predict` rotates the
object inside autograd: by the three tilt angles where tilt is on (fixed
or refined), else by the view angle unless the Reconstructor rotates it
out of the loop."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import ReconConfig
from ..constants import wavelength_nm
from ..ops import patches as patch_ops
from ..ops import propagate as prop
from ..ops.fourier import fft2, fourier_shift, ifft2, shift_phase_ramp
from ..ops.rotate import rotate, tilt_rotate
from .base import incoherent_mode_sum


def complex_probe(probe):
    """``[n_modes, py, px, 2]`` float -> ``[n_modes, py, px]`` complex64."""
    return torch.complex(probe[..., 0].float(), probe[..., 1].float())


def select_probe(params, batch):
    """Per-angle probes (a 5D ``[n_theta, n_modes, py, px, 2]`` probe) are
    indexed by the current angle."""
    probe = params['probe']
    if probe.dim() == 5:
        probe = probe[batch['i_theta']]
    return probe


def defocus_probe(probe, params: Dict, cfg: ReconConfig):
    """The probe propagated by the refined defocus
    ``params['probe_defocus_mm'][0]`` (a differentiable Fresnel step)."""
    geo = cfg.geometry
    voxel_nm = (geo.psize_cm * 1e7,) * 3
    dist_nm = params['probe_defocus_mm'][0] * 1e6
    h = prop.fresnel_kernel(probe.shape[-2:], voxel_nm,
                            wavelength_nm(geo.energy_ev), dist_nm,
                            fresnel_approx=geo.fresnel_approx,
                            sign_convention=geo.sign_convention,
                            device=probe.device)
    return ifft2(fft2(probe) * h)


def prepare_probe(params: Dict, batch: Dict, cfg: ReconConfig):
    """The complex probe ``[n_modes, py, px]`` with the global refinements:
    the refined defocus, then the angle's refined position offset
    (``params['probe_pos_offset'][i_theta]``, a Fourier shift)."""
    probe = complex_probe(select_probe(params, batch))
    if cfg.refine.optimize_probe_defocusing:
        probe = defocus_probe(probe, params, cfg)
    if cfg.refine.optimize_probe_pos_offset:
        probe = fourier_shift(probe,
                              params['probe_pos_offset'][batch['i_theta']])
    return probe


def rotated_object(params: Dict, batch: Dict, cfg: ReconConfig):
    """The object at the view angle, differentiably: as it is in 2D mode;
    with tilt on (fixed or refined), rotated by the angle's three tilts
    ``params['tilt_ls'][:, i_theta]``, always bilinear, whatever
    ``rotate_out_of_loop`` says (tilt takes precedence); as it is with the
    rotation out of the loop (the Reconstructor rotates); else rotated by
    ``batch['theta']`` (a Python float)."""
    obj = params['obj']
    if cfg.geometry.two_d_mode:
        return obj
    if cfg.refine.tilt_active:
        return tilt_rotate(obj, params['tilt_ls'][:, batch['i_theta']])
    if cfg.train.rotate_out_of_loop:
        return obj
    return rotate(obj, batch['theta'], method=cfg.train.interpolation)


def batch_indices(batch: Dict, device) -> torch.Tensor:
    """The batch's spot indices ``batch['ind_batch']`` as a long tensor on
    ``device``."""
    ind = batch['ind_batch']
    if torch.is_tensor(ind):
        return ind.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(ind, np.int64), device=device)


def shifted_probes(probe, params: Dict, batch: Dict, cfg: ReconConfig):
    """Per-spot probes ``[N, n_modes, py, px]``, each shifted by its
    refined sub-pixel correction ``params['probe_pos_correction'][i_theta,
    ind_batch]`` through one batched phase ramp on the probe's spectrum;
    without position refinement the shared probe ``[n_modes, py, px]``."""
    if not cfg.refine.optimize_all_probe_pos:
        return probe
    ppc = params['probe_pos_correction']
    shifts = ppc[batch['i_theta'], batch_indices(batch, ppc.device)]
    ramp = shift_phase_ramp(probe.shape[-2:], shifts)          # [N, py, px]
    return ifft2(fft2(probe)[None] * ramp[:, None])


def unfolded_far_field(cfg: ReconConfig) -> bool:
    """Whether the detector propagation stays out of the multislice: it is
    off by configuration, or something sits between the exit wave and the
    detector (the projection offset's shift) or the distance is refined
    (its gradient flows through the propagation)."""
    return (cfg.train.fuse_farfield == 'off'
            or cfg.refine.optimize_prj_pos_offset
            or cfg.refine.optimize_free_prop)


def predict(params: Dict, batch: Dict, cfg: ReconConfig,
            pad_arr: Optional[np.ndarray] = None, return_wave: bool = False,
            gather_fn=None):
    """Detected magnitudes ``[N, py, px]`` of one minibatch: rotate the
    object, pad it, extract the windows at ``round(batch['pos_batch'])``
    (a host ``[N, 2]`` table; windows past the padded edge see vacuum)
    and run :func:`predict_from_patches`.  ``return_wave``: the complex
    exit waves ``[n_modes, N, py, px]`` before detection instead.
    ``gather_fn(obj, pad_arr, pos, probe_size)``: reads the windows (at
    ``pos`` in the padded frame, all in range) of the unpadded rotated
    object in place of the padding and the gather — the halo gather of an
    object split over a mesh."""
    geo = cfg.geometry
    if pad_arr is None:
        pad_arr = np.zeros((2, 2), dtype=np.int64)
    pos = (np.round(np.asarray(batch['pos_batch'], np.float32))
           .astype(np.int64) + np.asarray([pad_arr[0][0], pad_arr[1][0]]))
    if gather_fn is not None:
        subobj = gather_fn(rotated_object(params, batch, cfg), pad_arr, pos,
                           geo.probe_size)
    else:
        obj = patch_ops.pad_object(rotated_object(params, batch, cfg),
                                   pad_arr, cfg.train.unknown_type)
        subobj = patch_ops.extract_patches_vacuum(
            obj, pos, geo.probe_size, unknown_type=cfg.train.unknown_type)
    return predict_from_patches(params, batch, subobj, cfg,
                                return_wave=return_wave)


def predict_from_patches(params: Dict, batch: Dict, subobj, cfg: ReconConfig,
                         return_wave: bool = False, prebinned_z: bool = False,
                         zmajor: bool = False):
    """Detected magnitudes ``[N, py, px]`` from pre-extracted object
    patches ``[N, py, px, z, 2]`` — or, with ``zmajor=True``,
    ``[zb, 2, N, py, px]``, the multislice kernel's operand layout.
    ``prebinned_z``: the patches' z axis is already bin-summed (the plain
    delta_beta multislice only).  Under ``pure_projection`` with
    ``is_minus_logged`` the prediction is the image's magnitude."""
    geo = cfg.geometry
    probes = shifted_probes(prepare_probe(params, batch, cfg), params, batch,
                            cfg)
    if cfg.train.run_bfloat16:
        # bf16 storage of the packed patches (a no-op when they were
        # extracted from the bf16 copy); the two channels are views of it.
        subobj = subobj.to(torch.bfloat16)
    if zmajor:
        delta = torch.movedim(subobj[:, 0], 0, -1)
        beta = torch.movedim(subobj[:, 1], 0, -1)
    else:
        delta = subobj[..., 0]
        beta = subobj[..., 1]
    if probes.dim() == 4:
        # Per-spot probes [N, n_modes, py, px] -> [n_modes, N, py, px].
        wave = probes.transpose(0, 1)
    else:
        # The shared probe broadcast to the [n_modes, N, py, px] stack.
        wave = probes[:, None].expand(probes.shape[0], delta.shape[0],
                                      *probes.shape[-2:])
    kappa = None
    if cfg.refine.optimize_ctf_lg_kappa:
        kappa = 10.0 ** params['ctf_lg_kappa'][0]
    final_prop = None
    if geo.pure_projection:
        out = prop.pure_projection_modulate(
            delta, beta, wave, geo.energy_ev, geo.psize_cm,
            slice_spacing_cm=geo.slice_spacing_cm,
            unknown_type=cfg.train.unknown_type,
            sign_convention=geo.sign_convention,
            scale_ri_by_k=geo.scale_ri_by_k, kappa=kappa,
            is_minus_logged=geo.is_minus_logged,
            return_sqrt=cfg.loss.raw_data_type == 'intensity')
    elif geo.slice_pos_cm_ls is not None:
        out = prop.sparse_multislice_propagate(
            delta, beta, wave, geo.energy_ev, geo.psize_cm,
            params['slice_pos_cm_ls'] if cfg.refine.optimize_slice_pos
            else geo.slice_pos_cm_ls,
            unknown_type=cfg.train.unknown_type,
            fresnel_approx=geo.fresnel_approx,
            sign_convention=geo.sign_convention,
            scale_ri_by_k=geo.scale_ri_by_k)
    else:
        fused = {'auto': 'auto', 'on': True, 'off': False}[
            cfg.train.fused_multislice]
        if not unfolded_far_field(cfg):
            final_prop = {'free_prop_cm': geo.free_prop_cm,
                          'normalize_fft': cfg.loss.normalize_fft}
        out = prop.multislice_propagate(
            delta, beta, wave, geo.energy_ev, geo.psize_cm,
            slice_spacing_cm=geo.slice_spacing_cm, binning=geo.binning,
            unknown_type=cfg.train.unknown_type,
            fresnel_approx=geo.fresnel_approx,
            sign_convention=geo.sign_convention,
            scale_ri_by_k=geo.scale_ri_by_k, kappa=kappa, fused=fused,
            prebinned=prebinned_z, final_prop=final_prop,
            db_stack=None if zmajor else subobj,
            db_zmajor=subobj if zmajor else None)
    if final_prop is None:
        if cfg.refine.optimize_prj_pos_offset:
            out = fourier_shift(out,
                                params['prj_pos_offset'][batch['i_theta']])
        free_prop_cm = geo.free_prop_cm
        if cfg.refine.optimize_free_prop:
            free_prop_cm = params['free_prop_cm'][0]
        dz_cm = (geo.psize_cm if geo.slice_spacing_cm is None
                 else geo.slice_spacing_cm)
        voxel_nm = (geo.psize_cm * 1e7, geo.psize_cm * 1e7, dz_cm * 1e7)
        out = prop.free_space_propagate(
            out.to(torch.complex64), free_prop_cm,
            wavelength_nm(geo.energy_ev), voxel_nm,
            sign_convention=geo.sign_convention,
            normalize_fft=cfg.loss.normalize_fft,
            fresnel_approx=geo.fresnel_approx)
    if return_wave:
        return out
    if geo.pure_projection and geo.is_minus_logged:
        # The modulated "wave" is the predicted image itself.
        return torch.abs(out) if out.dim() == 3 else incoherent_mode_sum(out)
    return incoherent_mode_sum(out)
