"""The Reconstructor: the per-angle scheme with the object rotated out of
the autodiff loop, and the immediate scheme (the reference's default) with
the rotation inside it.

Counterpart of ``adorym_tpu/recon.py``'s ``Reconstructor`` on two paths.

Per angle, ``run_epoch`` -> ``angles_epoch`` -> ``angle_step`` (patch
mode, prebin, fused rotate-back) -> ``patch_accum`` -> ``apply_step``:

  1. rotate the object once, pad it, bin it in z;
  2. per gradient chunk (a whole angle at the flagship), extract the
     patches (z-major for the delta/beta kernel, else with the grid-gather
     kernel), run the forward model (a multislice kernel), take the loss
     and its gradient with respect to the patches, and add the patch
     gradients into the accumulator with the grid-scatter kernel;
  3. crop, expand in z and rotate the accumulated gradient back in one
     gather, and apply the optimizer and the constraints.

Immediate, ``run_epoch`` -> ``epoch_fused`` -> ``step_band`` or ``step``,
one optimizer update per minibatch:

  - ``step_band``, where every minibatch is one constant-stride grid row:
    rotate (and bin) only the band of object rows the row's windows cover,
    extract the patches, run the forward model and its gradient, add the
    row's patch gradients into a band accumulator with the one-row grid
    scatter (K6), apply the exact transpose of the band's rotation (or,
    opt-in, the -theta interpolation) and update the whole object;
  - ``step``, for any other scan table: autograd through the whole
    object's rotation (``models.ptychography.predict``).

The measured data lives on the device.  Per-batch losses stay on the
device until the epoch ends.  Runs outside these paths raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import ReconConfig
from .models import base as model_base
from .models import ptychography as ptycho_model
from .ops import patches as patch_ops
from .ops import propagate as prop
from .ops.cuda_scatter_grid import (scatter_grid2d_add,
                                    scatter_rowgrid_add_kernel)
from .ops.rotate import (rotate, rotate_adjoint, rotate_adjoint_taps,
                         rotate_and_bin_z, rotate_expanded_from_binned_z)
from .optim import optimizers as opt_lib
from .optim import params as param_lib
from .utils import profiling as _prof
from .utils.initialize import initialize_object, initialize_probe

#: The ROADMAP item that ports what the two schemes still leave out.
_REST = ('ROADMAP A, the rest of the per-angle path and of the immediate '
         'scheme')


def resolve_device(device=None) -> torch.device:
    """The run's device: ``None`` means CUDA, which must then exist — the
    port never falls back to the CPU on its own."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           'run on the CPU')
    return dev


def _check_slice(cfg: ReconConfig):
    """Raise for configurations outside the ported paths."""
    geo, t, p, lc = cfg.geometry, cfg.train, cfg.parallel, cfg.loss
    per_angle = t.update_scheme == 'per angle'
    todo = []
    if t.update_scheme not in ('immediate', 'per angle'):
        raise ValueError("update_scheme must be 'immediate' or 'per angle', "
                         f'got {t.update_scheme!r}')
    if t.imm_grad_rotation not in ('exact', 'interp'):
        raise ValueError("imm_grad_rotation must be 'exact'|'interp', "
                         f'got {t.imm_grad_rotation!r}')
    if t.n_batch_per_update > 1:
        todo.append(f'n_batch_per_update > 1 ({_REST})')
    if not per_angle and t.rotate_out_of_loop:
        todo.append("update_scheme='immediate' with rotate_out_of_loop=True "
                    f'({_REST})')
    if per_angle and not t.rotate_out_of_loop:
        todo.append("update_scheme='per angle' with the rotation inside "
                    f'autodiff ({_REST})')
    if geo.two_d_mode:
        todo.append('two_d_mode (ROADMAP A, remaining model families '
                    'and refinables)')
    if cfg.refine.tilt_active:
        todo.append('tilt (ROADMAP A, remaining model families and '
                    'refinables)')
    if (lc.alpha_d or lc.alpha_b or lc.gamma or lc.corr_reg
            or lc.grad_corr_reg):
        todo.append('regularizers (ROADMAP A, remaining model families '
                    'and refinables)')
    if p.data_axis > 1 or p.object_axis > 1:
        todo.append('device meshes (ROADMAP A, multi-GPU and out-of-core)')
    if p.offload_optimizer_state or p.offload_object is True:
        todo.append('offload (ROADMAP A, multi-GPU and out-of-core)')
    if t.shrink_cycle is not None:
        todo.append('shrink-wrap (ROADMAP A, remaining model families '
                    'and refinables)')
    if per_angle and t.stream_rotation == 'on':
        todo.append(f'streaming rotation ({_REST})')
    if per_angle and t.exact_grad_rotation:
        todo.append(f'exact gradient rotate-back ({_REST})')
    if per_angle and (t.randomize_probe_pos or t.patch_grad):
        todo.append(f'per-angle scan tables that are not grid rows ({_REST})')
    if todo:
        raise NotImplementedError('not ported yet: ' + '; '.join(todo))


def _band_prebin(cfg) -> bool:
    """Whether the band is binned in z before extraction (the delta_beta
    multislice branch with ``binning > 1``)."""
    geo = cfg.geometry
    return (cfg.train.prebin_z in ('auto', 'on') and geo.binning > 1
            and cfg.train.unknown_type == 'delta_beta'
            and not geo.pure_projection and geo.slice_pos_cm_ls is None)


def _band_rotate_fwd(band, theta, cfg, px0, px1):
    """The band's forward: rotate (and bin in z) the vacuum-filled band,
    pad x, cast for the bf16 extraction.  Rotation keeps a constant vacuum
    plane exactly, so filling before rotating matches the reference's
    rotate-then-pad order."""
    geo = cfg.geometry
    interp = cfg.train.interpolation
    if _band_prebin(cfg):
        rb = rotate_and_bin_z(band, theta, geo.binning, method=interp)
    else:
        rb = rotate(band, theta, method=interp)
    rb = patch_ops.pad_object(rb, np.array([[0, 0], [px0, px1]], np.int64),
                              cfg.train.unknown_type)
    if cfg.train.run_bfloat16:
        rb = rb.to(torch.bfloat16)
    return rb


#: Force the tap-gather exact adjoint on (True) or off (False); None is
#: auto, the transpose through autograd on every device.  On an H100 the
#: tap form took 3.0 ms of device time in 367 kernels at the flagship band
#: and the transpose 1.6 ms in 128 (``tools/probe_immediate_torch.py``).
#: Tests set it to cover both forms.
FORCE_ADJOINT_TAPS = None


def _use_adjoint_taps(cfg) -> bool:
    return (cfg.train.interpolation == 'bilinear'
            and bool(FORCE_ADJOINT_TAPS))


def _band_adjoint_back(acc, theta, cfg, px0, X, nz):
    """The band's exact backward: crop the x padding from the band
    accumulator ``[py, X + pad, zb, 2]``, expand z and apply the transpose
    of the band's rotation, through autograd or, when forced, as the tap
    gather (reading the binned accumulator directly).  Returns ``[py, X,
    nz, 2]``."""
    geo = cfg.geometry
    gb = acc[:, px0:px0 + X]
    prebin = _band_prebin(cfg)
    if _use_adjoint_taps(cfg):
        return rotate_adjoint_taps(gb, theta,
                                   binning=geo.binning if prebin else 1,
                                   nz_full=nz)
    if prebin:
        gb = torch.repeat_interleave(gb, geo.binning, dim=2)[:, :, :nz]
    return rotate_adjoint(gb, theta, method=cfg.train.interpolation)


def _band_grad_back(acc, theta, cfg, px0, X, nz):
    """The band gradient's rotate-back: the exact adjoint (the default,
    ``imm_grad_rotation='exact'``) or the opt-in -theta interpolation
    (``'interp'``), one gather reading the binned accumulator directly."""
    if cfg.train.imm_grad_rotation == 'exact':
        return _band_adjoint_back(acc, theta, cfg, px0, X, nz)
    geo = cfg.geometry
    gb = acc[:, px0:px0 + X]
    if _band_prebin(cfg):
        return rotate_expanded_from_binned_z(
            gb, -theta, geo.binning, nz, method=cfg.train.interpolation)
    return rotate(gb, -theta, method=cfg.train.interpolation)


class Reconstructor:
    """Owns the parameters, the optimizer state and the steps of one run
    (per angle, or immediate).  ``device``: where it runs; ``None`` means
    CUDA and raises when there is none."""

    def __init__(self, cfg: ReconConfig, *, data: np.ndarray,
                 probe_pos: np.ndarray, theta_ls: Optional[np.ndarray] = None,
                 obj_init: Optional[np.ndarray] = None,
                 probe_init: Optional[np.ndarray] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        _check_slice(cfg)
        geo = cfg.geometry
        self.data = np.abs(np.asarray(data)).astype(np.float32)
        self.n_theta, self.n_pos = self.data.shape[:2]
        self.probe_pos = np.asarray(probe_pos, dtype=np.float64)
        if self.probe_pos.ndim != 2:
            raise NotImplementedError(f'per-angle scan tables: {_REST}')
        if theta_ls is None:
            theta_ls = np.zeros(self.n_theta)
        self.theta_ls = np.asarray(theta_ls, dtype=np.float32)

        # -- parameters ----------------------------------------------------
        if obj_init is None:
            obj_init = initialize_object(geo.obj_size,
                                         unknown_type=cfg.train.unknown_type,
                                         object_type=cfg.train.object_type,
                                         non_negativity=cfg.train.non_negativity,
                                         seed=cfg.train.seed)
        if probe_init is None:
            probe_init = initialize_probe(
                geo.probe_size, 'plane', n_probe_modes=cfg.train.n_probe_modes)
        dev = self.device
        self.params: Dict[str, torch.Tensor] = {
            'obj': torch.as_tensor(np.asarray(obj_init, np.float32),
                                   device=dev),
            'probe': torch.as_tensor(np.asarray(probe_init, np.float32),
                                     device=dev),
        }
        self.params.update(param_lib.build_aux_params(
            cfg, self.n_theta, self.n_pos, device=dev))
        self.specs = param_lib.build_opt_specs(cfg)
        self.opt_state = opt_lib.tree_init(self.specs, self.params)

        # -- statics -------------------------------------------------------
        self._immediate = cfg.train.update_scheme == 'immediate'
        self.pad_arr = patch_ops.calculate_pad(geo.obj_size[:2],
                                               self.probe_pos, geo.probe_size)
        mb = cfg.train.minibatch_size
        self._rowgrid_stride = (
            None if cfg.train.randomize_probe_pos else
            patch_ops.detect_row_grid(self.probe_pos, mb, geo.probe_size))
        if self._rowgrid_stride is None and not self._immediate:
            raise NotImplementedError(
                'per-angle scan tables whose minibatches are not '
                f'constant-stride grid rows: {_REST}')
        if (cfg.train.imm_grad_rotation == 'interp' and self._immediate
                and self._rowgrid_stride is None):
            # The knob reaches the band step only; the generic step
            # differentiates through the rotation (exact).
            warnings.warn("imm_grad_rotation='interp' requires the "
                          'band-granular immediate fast path (row-grid '
                          'scan table, 3D far-field ptychography); '
                          'running the exact-AD generic step instead')
        self._prebin = _band_prebin(cfg)
        nz_patch = geo.obj_size[2]
        if self._prebin:
            nz_patch = -(-nz_patch // geo.binning)
        # Gradient-chunk budget, the JAX package's formula on this device's
        # capacity: ~6 patch stacks live through forward + backward, plus
        # the multislice kernel's stored records (2 per probe mode).  The
        # immediate scheme's chunk is one minibatch.
        patch_bytes = mb * geo.probe_size[0] * geo.probe_size[1] * nz_patch * 8
        obj_bytes = int(np.prod(geo.obj_size)) * 8
        hbm = _prof.hbm_limit_bytes(dev)
        if (not self._immediate and cfg.train.stream_rotation == 'auto'
                and self._prebin and obj_bytes > hbm * (1.5 / 16)):
            raise NotImplementedError(
                f'objects that need the streaming rotation: {_REST}')
        avail = (hbm - _prof.xla_reserve_bytes(hbm)) - 6 * obj_bytes
        kernel_db = (cfg.train.unknown_type == 'delta_beta'
                     and not geo.pure_projection
                     and geo.slice_pos_cm_ls is None and geo.fresnel_approx
                     and (cfg.train.fused_multislice == 'on'
                          or (cfg.train.fused_multislice == 'auto'
                              and dev.type == 'cuda')))
        bufs = 6 + 2 * cfg.train.n_probe_modes if kernel_db else 6
        self._fuse_g = 1
        if not self._immediate:
            self._fuse_g = (int(max(1, min(64, avail // max(
                1, bufs * patch_bytes)))) if avail > 0 else 1)
            # A smaller chunk that lets the dataset live on the device
            # beats a larger one that does not.
            resid = min(3.5e9, 0.22 * hbm)
            fit = (hbm - resid) - 6 * obj_bytes - self.data.nbytes
            g_fit = int(fit // max(1, bufs * patch_bytes))
            if 1 <= g_fit < self._fuse_g:
                self._fuse_g = g_fit
        ws_bytes = 6 * obj_bytes + bufs * patch_bytes * self._fuse_g
        if self.data.nbytes > (hbm - _prof.data_headroom_bytes(hbm)) - ws_bytes:
            raise NotImplementedError(
                f'a dataset of {self.data.nbytes / 1e9:.2f} GB does not fit '
                'on the device next to the working set; staging it from the '
                'host is ROADMAP A, multi-GPU and out-of-core')
        # The per-angle chunk must be whole grid rows of a complete 2D grid
        # for the grid scatter (row-by-row scatters are ROADMAP A, the rest
        # of the per-angle path).
        self._grid_scatter_rows = None
        if not self._immediate:
            full = patch_ops.detect_full_grid(self.probe_pos, mb,
                                              geo.probe_size)
            if full is not None and self.n_pos % mb == 0:
                n_b = self.n_pos // mb
                g_ = min(self._fuse_g, n_b)
                if n_b % g_ == 0:
                    self._grid_scatter_rows = g_
            if self._grid_scatter_rows is None:
                raise NotImplementedError(
                    'scan tables that are not one complete grid split into '
                    f'whole chunks: {_REST}')
        self.i_opt_batch = 0      # optimizer step counter
        self.global_batch = 0     # epoch*n_batch + i_batch, for update gates
        self.loss_history: List[float] = []
        self._data_dev = None

    # ------------------------------------------------------------------
    def make_batches(self, rng: np.random.Generator):
        """Same-angle minibatches, angles shuffled, positions in scan order
        (shuffled under ``randomize_probe_pos``) and padded to a full last
        batch: by repeats of the last spot for a static row-grid table,
        else by random spots.  The JAX package's draws from the same
        Generator."""
        t = self.cfg.train
        mb = t.minibatch_size
        n_spots = self.probe_pos.shape[-2]
        deterministic_pad = (not t.randomize_probe_pos
                             and patch_ops.detect_row_grid_ragged(
                                 self.probe_pos, mb,
                                 self.cfg.geometry.probe_size) is not None)
        batches = []
        for i_theta in rng.permutation(self.n_theta):
            spots = (rng.permutation(n_spots) if t.randomize_probe_pos
                     else np.arange(n_spots))
            n_batches = -(-n_spots // mb)
            pad = n_batches * mb - n_spots
            if pad:
                tail = (np.full(pad, n_spots - 1) if deterministic_pad
                        else rng.choice(n_spots, pad))
                spots = np.concatenate([spots, tail])
            for b in range(n_batches):
                batches.append((int(i_theta), spots[b * mb:(b + 1) * mb]))
        return batches

    @staticmethod
    def _group_batches(batches):
        """``[(i_theta, [inds, ...]), ...]`` of contiguous same-angle
        batches."""
        groups = []
        for i_theta, inds in batches:
            if groups and groups[-1][0] == i_theta:
                groups[-1][1].append(inds)
            else:
                groups.append((i_theta, [inds]))
        return groups

    def _stage_angle(self, inds_list):
        """Per-angle tables in gradient chunks of ``g`` minibatches (whole
        grid rows; ``g`` divides the angle's batch count).  Returns numpy
        ``(inds [n_c, g*mb], pos [n_c, g*mb, 2])``."""
        inds_arr = np.stack(inds_list)
        n_c = len(inds_list) // self._grid_scatter_rows
        inds_arr = inds_arr.reshape(n_c, -1)
        pos = self.probe_pos[inds_arr].astype(np.float32)
        return inds_arr, pos

    def _dataset(self) -> torch.Tensor:
        """The dataset on the device, moved there on first use."""
        if self._data_dev is None:
            self._data_dev = torch.as_tensor(self.data, device=self.device)
        return self._data_dev

    def _measured(self, i_theta, inds):
        """The angle's measured rows ``[n_c, g*mb, py, px]``, gathered from
        the device-resident dataset."""
        idx = torch.as_tensor(inds.reshape(-1), device=self.device)
        rows = self._dataset()[i_theta][idx]
        return rows.reshape(inds.shape + self.data.shape[2:])

    # ------------------------------------------------------------------
    def _zmajor(self) -> bool:
        cfg = self.cfg
        geo = cfg.geometry
        return ((cfg.train.zmajor_extract == 'on'
                 or (cfg.train.zmajor_extract == 'auto'
                     and self.device.type == 'cuda'))
                and cfg.train.unknown_type == 'delta_beta'
                and not geo.pure_projection and geo.slice_pos_cm_ls is None)

    def _patch_grads(self, sub, i_theta, theta, measured, zm, groups):
        """Forward model and loss of the patches ``sub`` (z-major when
        ``zm``) against ``measured``, and the gradient of the sum of the
        ``groups`` minibatches' mean losses with respect to ``sub`` and the
        refined probe.  Returns ``(losses [groups], g_sub, {name:
        grad})``; ``g_sub`` is in the scatter layout ``[N, py, px, zb, 2]``
        (for z-major patches, a view of the z-major gradient, which the
        scatter kernels read in place)."""
        cfg = self.cfg
        aux_names = [k for k in self.specs if k != 'obj']
        sub.requires_grad_(True)
        aux = {'probe': self.params['probe'].detach().requires_grad_(
            'probe' in aux_names)}
        batch = {'i_theta': i_theta, 'theta': theta}
        with torch.enable_grad():
            pred = ptycho_model.predict_from_patches(
                aux, batch, sub, cfg, prebinned_z=self._prebin, zmajor=zm)
            per_item = model_base.mismatch_loss(
                pred, measured, cfg.loss.loss_function_type,
                cfg.loss.raw_data_type, cfg.loss.poisson_multiplier,
                per_item=True)
            per_batch = per_item.reshape(groups, -1).mean(1)
            grads = torch.autograd.grad(per_batch.sum(),
                                        [sub] + [aux[k] for k in aux_names])
        g_sub = grads[0]
        if zm:
            g_sub = g_sub.permute(2, 3, 4, 0, 1)
        return per_batch.detach(), g_sub, dict(zip(aux_names, grads[1:]))

    def patch_accum(self, obj_pad, theta, i_theta, pos_all, measured_all):
        """Scan the angle's gradient chunks at patch granularity, adding
        the patch gradients into an ``obj_pad``-shaped f32 accumulator with
        the grid scatter.  The chunk objective is the sum of its batches'
        mean losses.  Returns ``(acc_obj, acc_aux, losses [n_c, g])``;
        ``acc_aux`` holds the probe gradient when the probe is refined."""
        cfg = self.cfg
        geo = cfg.geometry
        g = self._grid_scatter_rows
        zm = self._zmajor()
        # run_bfloat16: extract from a bf16 copy (the same values the
        # model would cast to); the accumulator stays f32.
        obj_ex = (obj_pad.to(torch.bfloat16) if cfg.train.run_bfloat16
                  else obj_pad)
        obj_zx = obj_ex.permute(2, 3, 0, 1).contiguous() if zm else None
        pad_off = np.asarray([self.pad_arr[0][0], self.pad_arr[1][0]])
        acc_obj = torch.zeros_like(obj_pad)
        acc_aux = {k: torch.zeros_like(self.params[k]) for k in self.specs
                   if k != 'obj'}
        losses = []
        for c in range(pos_all.shape[0]):
            pos_int = np.round(pos_all[c]).astype(np.int64) + pad_off
            if zm:
                sub = patch_ops.extract_patches_zmajor(obj_zx, pos_int,
                                                       geo.probe_size)
            else:
                # The chunk is whole rows of the complete grid: the grid
                # gather (the exact transpose of the scatter below).
                sub = patch_ops.extract_grid2d_best(
                    obj_ex, pos_int[0, 0], pos_int[0, 1],
                    self._rowgrid_stride, g, cfg.train.minibatch_size,
                    geo.probe_size)
            per_batch, g_sub, g_aux = self._patch_grads(
                sub, i_theta, theta, measured_all[c], zm, g)
            scatter_grid2d_add(
                acc_obj, g_sub, pos_int[0, 0], pos_int[0, 1],
                self._rowgrid_stride, g)
            for k, gk in g_aux.items():
                acc_aux[k] += gk
            losses.append(per_batch)
        return acc_obj, acc_aux, torch.stack(losses)

    def apply_step(self, grads, i_opt_batch: int, global_batch: int):
        """Optimizer update of every spec'd leaf (the probe inside its
        update window), then the constraints."""
        cfg = self.cfg
        mask = {}
        if 'probe' in self.specs:
            mask['probe'] = param_lib.probe_update_gate(cfg, global_batch)
        params, self.opt_state = opt_lib.tree_apply(
            self.specs, self.params, grads, self.opt_state, i_opt_batch,
            update_mask=mask)
        params = param_lib.apply_param_constraints(params, cfg)
        params['obj'] = param_lib.apply_object_constraints(params['obj'],
                                                            cfg)
        self.params = params

    @torch.no_grad()
    def angle_step(self, i_theta: int, inds_list) -> torch.Tensor:
        """One angle: rotate, pad and bin the object, accumulate the
        chunks' gradients, rotate the gradient back (expanding the bins in
        the same gather) and update.  Returns the per-batch losses of the
        angle, on the device."""
        cfg = self.cfg
        geo = cfg.geometry
        theta = float(self.theta_ls[i_theta])
        inds, pos = self._stage_angle(inds_list)
        measured = self._measured(i_theta, inds)
        method = cfg.train.interpolation
        obj_pad = patch_ops.pad_object(
            rotate(self.params['obj'], theta, method=method), self.pad_arr,
            cfg.train.unknown_type)
        if self._prebin:
            obj_pad = prop.bin_z_sum(obj_pad, geo.binning, axis=2)
        acc_obj, acc_aux, losses = self.patch_accum(
            obj_pad, theta, i_theta, pos, measured)
        p = self.pad_arr
        g_rot = acc_obj[p[0][0]:acc_obj.shape[0] - p[0][1],
                        p[1][0]:acc_obj.shape[1] - p[1][1]]
        if self._prebin:
            g_obj = rotate_expanded_from_binned_z(
                g_rot, -theta, geo.binning, geo.obj_size[2], method=method)
        else:
            g_obj = rotate(g_rot, -theta, method=method)
        self.apply_step({**acc_aux, 'obj': g_obj}, self.i_opt_batch,
                        self.global_batch)
        self.i_opt_batch += 1
        self.global_batch += len(inds_list)
        return losses.reshape(-1)

    @torch.no_grad()
    def step_band(self, i_theta: int, inds, measured) -> torch.Tensor:
        """One immediate update from one grid row of patterns: only the
        band of object rows ``[y0, y0 + py)`` that the row's windows cover
        is rotated, and its gradient is rotated back, the same linear
        chain autograd applies to the whole object (rotation acts on each
        y plane alone).  Band rows outside the object are vacuum going in
        and are dropped coming back.  Returns the batch's loss, on the
        device."""
        cfg = self.cfg
        geo = cfg.geometry
        Y, X, nz = geo.obj_size
        py = geo.probe_size[0]
        px0, px1 = int(self.pad_arr[1][0]), int(self.pad_arr[1][1])
        nzb = -(-nz // geo.binning) if self._prebin else nz
        theta = float(self.theta_ls[i_theta])
        pos = self.probe_pos[inds].astype(np.float32)
        obj = self.params['obj']
        y0 = int(np.round(pos[0, 0]))
        lo = min(max(y0, 0), Y)           # the object rows the band holds
        hi = max(min(y0 + py, Y), lo)
        if (lo, hi) == (y0, y0 + py):
            band = obj[lo:hi]
        else:
            band = obj.new_zeros((py,) + tuple(obj.shape[1:]))
            if cfg.train.unknown_type == 'real_imag':
                band[..., 0] = 1.0
            band[lo - y0:hi - y0] = obj[lo:hi]
        rb = _band_rotate_fwd(band, theta, cfg, px0, px1)
        x0s = np.round(pos[:, 1]).astype(np.int64) + px0
        posi = np.stack([np.zeros_like(x0s), x0s], 1)
        zm = self._zmajor()
        if zm:
            sub = patch_ops.extract_patches_zmajor(
                rb.permute(2, 3, 0, 1).contiguous(), posi, geo.probe_size)
        else:
            sub = patch_ops.extract_patches(rb, posi, geo.probe_size)
        loss, g_sub, g_aux = self._patch_grads(sub, i_theta, theta,
                                               measured, zm, 1)
        acc = torch.zeros((py, X + px0 + px1, nzb) + tuple(obj.shape[3:]),
                          dtype=torch.float32, device=obj.device)
        scatter_rowgrid_add_kernel(acc, g_sub, 0, int(x0s[0]),
                                   self._rowgrid_stride)
        g_band = _band_grad_back(acc, theta, cfg, px0, X, nz)
        g_obj = torch.zeros_like(obj)
        g_obj[lo:hi] = g_band[lo - y0:hi - y0]
        self.apply_step({**g_aux, 'obj': g_obj}, self.i_opt_batch,
                        self.global_batch)
        return loss[0]

    def loss_fn(self, params, batch, measured):
        """The minibatch's data-mismatch loss of :func:`models.ptychography.
        predict` (regularizers are ROADMAP A, remaining model families and
        refinables)."""
        cfg = self.cfg
        pred = ptycho_model.predict(params, batch, cfg, self.pad_arr)
        return model_base.mismatch_loss(
            pred, measured, cfg.loss.loss_function_type,
            cfg.loss.raw_data_type, cfg.loss.poisson_multiplier)

    @torch.no_grad()
    def step(self, i_theta: int, inds, measured) -> torch.Tensor:
        """One immediate update by autograd through the whole forward
        model, the object's rotation included.  Returns the batch's loss,
        on the device."""
        names = list(self.specs)
        params = {k: v.detach().requires_grad_(k in self.specs)
                  for k, v in self.params.items()}
        batch = {'i_theta': i_theta, 'theta': float(self.theta_ls[i_theta]),
                 'pos_batch': self.probe_pos[inds].astype(np.float32)}
        with torch.enable_grad():
            loss = self.loss_fn(params, batch, measured)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        self.apply_step(dict(zip(names, grads)), self.i_opt_batch,
                        self.global_batch)
        return loss.detach()

    def epoch_fused(self, batches) -> torch.Tensor:
        """An immediate epoch: one update per minibatch, through
        :meth:`step_band` where the scan table is grid rows, else
        :meth:`step`.  The batches' rows of the device-resident dataset
        are gathered by one index table moved to the device once.  Returns
        the per-batch losses ``[n_b]``, on the device."""
        step = self.step_band if self._rowgrid_stride is not None else self.step
        inds_dev = torch.as_tensor(np.stack([inds for _, inds in batches]),
                                   device=self.device)
        data = self._dataset()
        losses = []
        for i, (i_theta, inds) in enumerate(batches):
            losses.append(step(i_theta, inds, data[i_theta][inds_dev[i]]))
            self.i_opt_batch += 1
            self.global_batch += 1
        return torch.stack(losses)

    def run_epoch(self, i_epoch: int,
                  rng: Optional[np.random.Generator] = None) -> float:
        """One epoch over every angle; returns the mean per-batch loss,
        the same number the JAX package's ``run_epoch`` returns."""
        if rng is None:
            rng = np.random.default_rng(self.cfg.train.seed + i_epoch)
        batches = self.make_batches(rng)
        if self._immediate:
            losses = self.epoch_fused(batches)
        else:
            losses = torch.cat([self.angle_step(i_theta, inds_list)
                                for i_theta, inds_list
                                in self._group_batches(batches)])
        mean_loss = float(losses.double().mean().cpu())
        self.loss_history.append(mean_loss)
        return mean_loss

    @property
    def obj(self) -> np.ndarray:
        """The object ``[y, x, z, 2]`` as a host array."""
        return self.params['obj'].detach().cpu().numpy()
