"""The Reconstructor, cut down to the flagship path: per-angle updates
with the object rotated out of the autodiff loop.

Counterpart of ``adorym_tpu/recon.py``'s ``Reconstructor`` on the path
``run_epoch`` -> ``angles_epoch`` -> ``angle_step`` (patch mode, prebin,
fused rotate-back) -> ``patch_accum`` -> ``apply_step``.  Per angle:

  1. rotate the object once, pad it, bin it in z;
  2. per gradient chunk (a whole angle at the flagship), extract the
     patches (z-major for the delta/beta kernel, else with the grid-gather
     kernel), run the forward model (a multislice kernel), take the loss
     and its gradient with respect to the patches, and add the patch
     gradients into the accumulator with the grid-scatter kernel;
  3. crop, expand in z and rotate the accumulated gradient back in one
     gather, and apply the optimizer and the constraints.

The measured data lives on the device.  Per-batch losses stay on the
device until the epoch ends.  Runs outside this path raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .config import ReconConfig
from .models import base as model_base
from .models import ptychography as ptycho_model
from .ops import patches as patch_ops
from .ops import propagate as prop
from .ops.cuda_scatter_grid import scatter_grid2d_add
from .ops.rotate import rotate, rotate_expanded_from_binned_z
from .optim import optimizers as opt_lib
from .optim import params as param_lib
from .utils import profiling as _prof
from .utils.initialize import initialize_object, initialize_probe


def resolve_device(device=None) -> torch.device:
    """The run's device: ``None`` means CUDA, which must then exist — the
    port never falls back to the CPU on its own."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           'run on the CPU')
    return dev


def _check_slice(cfg: ReconConfig):
    """Raise for configurations outside the ported path."""
    geo, t, p, lc = cfg.geometry, cfg.train, cfg.parallel, cfg.loss
    todo = []
    if t.update_scheme != 'per angle' or t.n_batch_per_update > 1:
        todo.append("update_scheme='immediate' (ROADMAP A, the "
                    "immediate scheme)")
    if not t.rotate_out_of_loop:
        todo.append('rotation inside autodiff (ROADMAP A, the immediate '
                    'scheme)')
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
    if t.stream_rotation == 'on':
        todo.append('streaming rotation (ROADMAP A, the rest of the '
                    'per-angle path)')
    if t.exact_grad_rotation:
        todo.append('exact gradient rotate-back (ROADMAP A, the rest of '
                    'the per-angle path)')
    if t.shrink_cycle is not None:
        todo.append('shrink-wrap (ROADMAP A, remaining model families '
                    'and refinables)')
    if t.randomize_probe_pos or t.patch_grad:
        todo.append('scan tables that are not grid rows (ROADMAP A, the '
                    'rest of the per-angle path)')
    if todo:
        raise NotImplementedError('not ported yet: ' + '; '.join(todo))


class Reconstructor:
    """Owns the parameters, the optimizer state and the per-angle step of
    one run.  ``device``: where it runs; ``None`` means CUDA and raises
    when there is none."""

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
            raise NotImplementedError('per-angle scan tables: ROADMAP A, '
                                      'the rest of the per-angle path')
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
        self.pad_arr = patch_ops.calculate_pad(geo.obj_size[:2],
                                               self.probe_pos, geo.probe_size)
        mb = cfg.train.minibatch_size
        self._rowgrid_stride = patch_ops.detect_row_grid(
            self.probe_pos, mb, geo.probe_size)
        if self._rowgrid_stride is None:
            raise NotImplementedError(
                'scan tables whose minibatches are not constant-stride grid '
                'rows: ROADMAP A, the rest of the per-angle path')
        self._prebin = (cfg.train.prebin_z in ('auto', 'on')
                        and geo.binning > 1
                        and cfg.train.unknown_type == 'delta_beta'
                        and not geo.pure_projection
                        and geo.slice_pos_cm_ls is None)
        nz_patch = geo.obj_size[2]
        if self._prebin:
            nz_patch = -(-nz_patch // geo.binning)
        # Gradient-chunk budget, the JAX package's formula on this device's
        # capacity: ~6 patch stacks live through forward + backward, plus
        # the multislice kernel's stored records (2 per probe mode).
        patch_bytes = mb * geo.probe_size[0] * geo.probe_size[1] * nz_patch * 8
        obj_bytes = int(np.prod(geo.obj_size)) * 8
        hbm = _prof.hbm_limit_bytes(dev)
        if (cfg.train.stream_rotation == 'auto'
                and self._prebin and obj_bytes > hbm * (1.5 / 16)):
            raise NotImplementedError(
                'objects that need the streaming rotation: ROADMAP A, the '
                'rest of the per-angle path')
        avail = (hbm - _prof.xla_reserve_bytes(hbm)) - 6 * obj_bytes
        kernel_db = (cfg.train.unknown_type == 'delta_beta'
                     and not geo.pure_projection
                     and geo.slice_pos_cm_ls is None and geo.fresnel_approx
                     and (cfg.train.fused_multislice == 'on'
                          or (cfg.train.fused_multislice == 'auto'
                              and dev.type == 'cuda')))
        bufs = 6 + 2 * cfg.train.n_probe_modes if kernel_db else 6
        self._fuse_g = (int(max(1, min(64, avail // max(1, bufs * patch_bytes))))
                        if avail > 0 else 1)
        # A smaller chunk that lets the dataset live on the device beats a
        # larger one that does not.
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
        # The chunk must be whole grid rows of a complete 2D grid for the
        # grid scatter (row-by-row scatters are ROADMAP A, the rest of the
        # per-angle path).
        self._grid_scatter_rows = None
        full = patch_ops.detect_full_grid(self.probe_pos, mb, geo.probe_size)
        if full is not None and self.n_pos % mb == 0:
            n_b = self.n_pos // mb
            g_ = min(self._fuse_g, n_b)
            if n_b % g_ == 0:
                self._grid_scatter_rows = g_
        if self._grid_scatter_rows is None:
            raise NotImplementedError(
                'scan tables that are not one complete grid split into '
                'whole chunks: ROADMAP A, the rest of the per-angle path')
        self.i_opt_batch = 0      # optimizer step counter
        self.global_batch = 0     # epoch*n_batch + i_batch, for update gates
        self.loss_history: List[float] = []
        self._data_dev = None

    # ------------------------------------------------------------------
    def make_batches(self, rng: np.random.Generator):
        """Same-angle minibatches, angles shuffled, positions in scan order
        (the JAX package's draws from the same Generator; the complete grid
        fills every batch, so none is padded)."""
        mb = self.cfg.train.minibatch_size
        spots = np.arange(self.n_pos)
        return [(int(i_theta), spots[b * mb:(b + 1) * mb])
                for i_theta in rng.permutation(self.n_theta)
                for b in range(self.n_pos // mb)]

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

    def _measured(self, i_theta, inds):
        """The angle's measured rows ``[n_c, g*mb, py, px]``, gathered from
        the device-resident dataset (moved there on first use)."""
        if self._data_dev is None:
            self._data_dev = torch.as_tensor(self.data, device=self.device)
        idx = torch.as_tensor(inds.reshape(-1), device=self.device)
        rows = self._data_dev[i_theta][idx]
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
        aux_names = [k for k in self.specs if k != 'obj']
        acc_obj = torch.zeros_like(obj_pad)
        acc_aux = {k: torch.zeros_like(self.params[k]) for k in aux_names}
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
            sub.requires_grad_(True)
            aux = {'probe': self.params['probe'].detach().requires_grad_(
                'probe' in aux_names)}
            batch = {'i_theta': i_theta, 'theta': theta}
            with torch.enable_grad():
                pred = ptycho_model.predict_from_patches(
                    aux, batch, sub, cfg, prebinned_z=self._prebin,
                    zmajor=zm)
                per_item = model_base.mismatch_loss(
                    pred, measured_all[c], cfg.loss.loss_function_type,
                    cfg.loss.raw_data_type, cfg.loss.poisson_multiplier,
                    per_item=True)
                per_batch = per_item.reshape(g, -1).mean(1)
                grads = torch.autograd.grad(
                    per_batch.sum(), [sub] + [aux[k] for k in aux_names])
            g_sub = grads[0]
            if zm:
                # A view in the scatter layout [N, py, px, zb, 2]; the
                # kernel reads the z-major memory in place.
                g_sub = g_sub.permute(2, 3, 4, 0, 1)
            scatter_grid2d_add(
                acc_obj, g_sub, pos_int[0, 0], pos_int[0, 1],
                self._rowgrid_stride, g)
            for k, gk in zip(aux_names, grads[1:]):
                acc_aux[k] += gk
            losses.append(per_batch.detach())
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

    def run_epoch(self, i_epoch: int,
                  rng: Optional[np.random.Generator] = None) -> float:
        """One epoch over every angle; returns the mean per-batch loss,
        the same number the JAX package's ``run_epoch`` returns."""
        if rng is None:
            rng = np.random.default_rng(self.cfg.train.seed + i_epoch)
        groups = self._group_batches(self.make_batches(rng))
        losses = [self.angle_step(i_theta, inds_list)
                  for i_theta, inds_list in groups]
        mean_loss = float(torch.cat(losses).double().mean().cpu())
        self.loss_history.append(mean_loss)
        return mean_loss

    @property
    def obj(self) -> np.ndarray:
        """The object ``[y, x, z, 2]`` as a host array."""
        return self.params['obj'].detach().cpu().numpy()
