"""Multi-distance near-field holography forward model
(``adorym_tpu/models/multidist.py``).

A full-field probe illuminates the object; the exit wave is Fresnel-
propagated to ``n_dists`` detector distances, one hologram each.  Large
fields of view go as tiles ("blocks") padded by a safe zone, so that the
propagation's fringes do not wrap at the tile's edges; the safe zone is
cropped after propagation.  Data layout as in the reference:
``data[theta, i_dist * n_blocks + block]``; :func:`expand_indices` maps a
batch of blocks to its rows at every distance.

The registration refinements act on the measured data
(:func:`transform_measured`): a per-distance affine (``prj_affine_ls``), a
per-angle offset and per-distance shifts (``probe_pos_correction`` is
``[n_dists, 2]`` here).  The refined distances (``free_prop_cm``) enter the
propagation as tensors.  Besides the Fresnel multislice, the exit wave may
come from the projection approximation (``pure_projection``), and
``forward_algorithm='ctf'`` predicts each distance's hologram by the
pure-phase CTF; the refined ``ctf_lg_kappa`` enters both as
``10**ctf_lg_kappa``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import ReconConfig
from ..constants import wavelength_nm
from ..ops import patches as patch_ops
from ..ops import propagate as prop
from ..ops.fourier import fourier_shift
from ..ops.rotate import rotate
from ..ops.warp import affine_transform_2d
from .base import incoherent_mode_sum
from .ptychography import complex_probe, defocus_probe


def _safe_zone_width(cfg: ReconConfig) -> int:
    """The safe zone in pixels: the configured width, else the fringe
    half-width ``ceil(sqrt(lambda z_max) / psize)``."""
    szw = cfg.geometry.safe_zone_width
    if szw is None:
        lmbda_nm = wavelength_nm(cfg.geometry.energy_ev)
        psize_nm = cfg.geometry.psize_cm * 1e7
        zmax_nm = float(np.max(np.asarray(cfg.geometry.free_prop_cm))) * 1e7
        szw = int(np.ceil(np.sqrt(lmbda_nm * zmax_nm) / psize_nm))
    return szw


def compute_pad(cfg: ReconConfig, obj_size_yx, probe_pos) -> np.ndarray:
    """Static object padding so that every safe-zone-expanded tile is in
    range."""
    szw = _safe_zone_width(cfg)
    sub = cfg.geometry.probe_size
    return patch_ops.calculate_pad(obj_size_yx,
                                   np.asarray(probe_pos) - szw,
                                   (sub[0] + 2 * szw, sub[1] + 2 * szw))


def gather_window(cfg: ReconConfig):
    """The object window one batch element reads: a safe-zone-expanded
    tile."""
    szw = _safe_zone_width(cfg)
    sub = cfg.geometry.probe_size
    return (sub[0] + 2 * szw, sub[1] + 2 * szw)


def expand_indices(inds: np.ndarray, n_pos: int,
                   cfg: ReconConfig) -> np.ndarray:
    """Block indices to measurement rows at every distance (``n_pos`` is
    the dataset's row count, ``n_dists`` blocks' worth)."""
    n_dists = cfg.geometry.n_dists
    n_blocks = n_pos // n_dists
    return np.concatenate([np.asarray(inds) + i * n_blocks
                           for i in range(n_dists)])


def _distances_cm(params: Dict, cfg: ReconConfig, device):
    """The propagation distances in cm, float32 ``[n_dists]`` on
    ``device``: the refined ones, else the geometry's."""
    if cfg.refine.optimize_free_prop:
        return params['free_prop_cm']
    return torch.as_tensor(
        np.atleast_1d(np.asarray(cfg.geometry.free_prop_cm, np.float32)),
        device=device)


def predict(params: Dict, batch: Dict, cfg: ReconConfig,
            pad_arr: Optional[np.ndarray] = None,
            return_wave: bool = False, gather_fn=None):
    """Predicted hologram magnitudes ``[n_dists * N, sy, sx]`` of the N
    blocks whose top-left corners are ``batch['pos_batch']`` (a host
    ``[N, 2]`` table; ``[[0, 0]]`` for one full-field block).
    ``return_wave``: the uncropped magnitudes at the tile size.
    ``gather_fn(obj, pad_arr, pos, tile)``: reads the tiles of the
    unpadded object (the halo gather of an object split over a mesh)."""
    geo = cfg.geometry
    szw = _safe_zone_width(cfg)
    sub = tuple(geo.probe_size)
    tile = (sub[0] + 2 * szw, sub[1] + 2 * szw)
    obj = params['obj']
    dev = obj.device
    if not geo.two_d_mode:
        obj = rotate(obj, batch['theta'], method=cfg.train.interpolation)
    probe = complex_probe(params['probe'])        # [n_modes, Y, X]
    if cfg.refine.optimize_probe_defocusing:
        probe = defocus_probe(probe, params, cfg)
    # The object pads with vacuum and the probe with a unit plane wave, so
    # that any tile at pos - szw is in range.
    if pad_arr is None:
        pad_arr = np.array([[szw, szw], [szw, szw]], dtype=np.int64)
    pos = np.round(np.asarray(batch['pos_batch'], np.float32)).astype(
        np.int64)
    (t, b), (l, r) = ((int(v) for v in row) for row in pad_arr)
    probe_p = probe.new_ones((probe.shape[0], probe.shape[1] + t + b,
                              probe.shape[2] + l + r))
    probe_p[:, t:t + probe.shape[1], l:l + probe.shape[2]] = probe
    tile_pos = pos + np.asarray([pad_arr[0][0] - szw, pad_arr[1][0] - szw])
    if gather_fn is not None:
        subobj = gather_fn(obj, pad_arr, tile_pos, tile)
    else:
        obj_p = patch_ops.pad_object(obj, pad_arr, cfg.train.unknown_type)
        subobj = patch_ops.extract_patches(obj_p, tile_pos, tile)
    delta, beta = subobj[..., 0], subobj[..., 1]     # [N, ty, tx, z]
    iy, ix = patch_ops._window_index(tile_pos, tile, probe_p.shape[-2:],
                                     dev)
    subprobe = probe_p[:, iy[:, :, None], ix[:, None, :]]   # [modes, N, ...]
    lmbda_nm = wavelength_nm(geo.energy_ev)
    dz_cm = (geo.psize_cm if geo.slice_spacing_cm is None
             else geo.slice_spacing_cm)
    voxel_nm = (geo.psize_cm * 1e7, geo.psize_cm * 1e7, dz_cm * 1e7)
    dists_cm = _distances_cm(params, cfg, dev)
    if cfg.train.forward_algorithm != 'fresnel':
        # The pure-phase CTF of each distance, on the refined kappa where
        # the run holds one, else the configured one.
        kappa = (10.0 ** params['ctf_lg_kappa'][0]
                 if 'ctf_lg_kappa' in params else cfg.train.ctf_kappa)
        mags = [torch.abs(prop.modulate_and_get_ctf(
                    delta, beta, geo.energy_ev, geo.psize_cm,
                    dists_cm[i_dist], kappa=kappa))
                for i_dist in range(geo.n_dists)]
    else:
        kappa = None
        if cfg.refine.optimize_ctf_lg_kappa:
            kappa = 10.0 ** params['ctf_lg_kappa'][0]
        if geo.pure_projection:
            exit_wave = prop.pure_projection_modulate(
                delta, beta, subprobe, geo.energy_ev, geo.psize_cm,
                slice_spacing_cm=geo.slice_spacing_cm,
                unknown_type=cfg.train.unknown_type,
                sign_convention=geo.sign_convention,
                scale_ri_by_k=geo.scale_ri_by_k, kappa=kappa)
        else:
            fused = {'auto': 'auto', 'on': True, 'off': False}[
                cfg.train.fused_multislice]
            exit_wave = prop.multislice_propagate(
                delta, beta, subprobe, geo.energy_ev, geo.psize_cm,
                slice_spacing_cm=geo.slice_spacing_cm, binning=geo.binning,
                unknown_type=cfg.train.unknown_type,
                fresnel_approx=geo.fresnel_approx,
                sign_convention=geo.sign_convention,
                scale_ri_by_k=geo.scale_ri_by_k, kappa=kappa, fused=fused)
        if cfg.refine.optimize_prj_pos_offset:
            exit_wave = fourier_shift(
                exit_wave, params['prj_pos_offset'][batch['i_theta']])
        mags = []
        for i_dist in range(geo.n_dists):
            det = prop.fresnel_propagate(exit_wave, dists_cm[i_dist] * 1e7,
                                         lmbda_nm, voxel_nm,
                                         fresnel_approx=geo.fresnel_approx,
                                         sign_convention=geo.sign_convention)
            mags.append(incoherent_mode_sum(det))
    out = torch.cat(mags, 0)                       # [n_dists * N, ty, tx]
    if return_wave:
        return out
    if szw > 0:
        out = out[:, szw:szw + sub[0], szw:szw + sub[1]]
    return out


def transform_measured(params: Dict, batch: Dict, measured,
                       cfg: ReconConfig):
    """The registration refinements applied to the measured holograms
    ``[n_dists * N, sy, sx]``: each distance's affine, the angle's Fourier
    shift, each distance's Fourier shift; returns magnitudes."""
    n_dists = cfg.geometry.n_dists
    n = measured.shape[0] // n_dists
    measured = measured.to(torch.complex64)
    if cfg.refine.optimize_prj_affine:
        measured = torch.cat([
            affine_transform_2d(torch.abs(measured[n * i:n * (i + 1)]),
                                params['prj_affine_ls'][i])
            .to(torch.complex64) for i in range(n_dists)])
    if cfg.refine.optimize_probe_pos_offset:
        measured = fourier_shift(measured,
                                 params['probe_pos_offset'][batch['i_theta']])
    if cfg.refine.optimize_all_probe_pos:
        measured = torch.cat([
            fourier_shift(measured[n * i:n * (i + 1)],
                          params['probe_pos_correction'][i])
            for i in range(n_dists)])
    return torch.abs(measured)
