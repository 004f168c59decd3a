"""The Reconstructor: the per-angle scheme with the object rotated out of
the autodiff loop, the immediate scheme (the reference's default) with
the rotation inside it, and the accumulate-then-update loop that runs the
other combinations.

Counterpart of ``adorym_tpu/recon.py``'s ``Reconstructor`` on three paths.

Per angle, ``run_epoch`` -> ``angles_epoch`` -> ``angle_step`` ->
``patch_accum`` or ``_chunk_grads`` -> ``apply_step``, for any scan table
(one for every angle, or one an angle):

  1. rotate the object once, pad it, bin it in z (or, streaming, rotate
     and bin it y chunk by y chunk);
  2. per gradient chunk (``fuse_g`` minibatches, a whole angle at the
     flagship; the last chunk padded by repeats of the last batch at
     weight 0), at patch granularity where the table is grid rows or
     ``patch_grad`` asks for it: extract the patches (z-major for the
     delta/beta kernel, else with the grid-gather kernel or the plain
     gather), run the forward model (a multislice kernel), take the loss
     and its gradient with respect to the patches, and add the patch
     gradients into the accumulator: whole rows of one complete grid with
     the grid-scatter kernel (K2), other grid rows one at a time with the
     one-row kernel (K6, reading each row in place), any other table
     with a plain scatter.  Else differentiate the chunk through the
     model's ``predict`` on the whole rotated object;
  3. crop, expand in z and rotate the accumulated gradient back (in one
     gather where nothing needs the expanded gradient; the exact
     transpose under ``exact_grad_rotation``), and apply the optimizer
     and the constraints.

Immediate, ``run_epoch`` -> ``epoch_fused`` -> ``step_band`` or
``accum_step``, one optimizer update per minibatch:

  - ``step_band``, where every minibatch is one constant-stride grid row:
    rotate (and bin) only the band of object rows the row's windows cover,
    extract the patches, run the forward model and its gradient, add the
    row's patch gradients into a band accumulator with the one-row grid
    scatter (K6), apply the exact transpose of the band's rotation (or,
    opt-in, the -theta interpolation) and update the whole object;
  - ``accum_step`` with an update every batch, for any other scan table:
    autograd through the whole object's rotation
    (``models.ptychography.predict``).

Accumulate-then-update, ``run_epoch`` -> ``epoch_fused`` ->
``accum_step``, for the per-angle scheme with the rotation inside
autodiff (and with tilt, which turns the rotation out of the loop off),
the immediate scheme with ``rotate_out_of_loop``, ``n_batch_per_update >
1`` and the per-angle scheme of another forward model: each batch's
gradient by autograd through the whole forward model adds into an
accumulator, applied at the angle's end ('per angle') or every
``n_batch_per_update`` batches ('immediate').  With the rotation out of
the loop the object is rotated once an angle (and stays stale within it
under 'immediate') and only the object's gradient is rotated back.

In 2D (``two_d_mode``) nothing rotates: the immediate scheme takes
``accum_step`` and the per-angle scheme ``angle_step`` without the
rotations.

Under a second-order object optimizer (``'cg'``, ``'curveball'``,
:mod:`.optim.second_order`) every batch takes ``second_order_step``,
whatever the scheme: autograd through the whole forward model (the view
rotation inside it, even under ``rotate_out_of_loop``), a first-order
update of the auxiliary leaves, then CG's line search or Curveball's
Gauss-Newton step on the object.  ``external_algorithm='ctf'`` replaces
the object's delta channel with the multi-distance CTF retrieval after
each update of the immediate steps and of the per-angle path.

Every step takes the gradient of every refined leaf: the object, the
probe and the auxiliary refinables (defocus, offsets, per-spot positions,
distances, affines), each with its own optimizer; the batch carries its
spot indices (``ind_batch``) for the per-spot positions.  ``model=`` takes
another forward model with the ptychography model's ``predict`` and, as
hooks, ``compute_pad``, ``transform_measured`` and ``expand_indices``: the
multi-distance model (:mod:`.models.multidist`) runs on ``accum_step``;
the band step stays ptychography's, and the per-angle step takes another
model (without ``expand_indices``) through its whole-object branch.

Regularizers act on the whole object: the band step adds their own
gradient by the sum rule, ``accum_step`` adds them to its loss, and the
per-angle step takes them on the rotated object, scaled by the angle's
batch count (once an angle at patch granularity, inside each chunk's loss
on the whole-object branch).  A finite support mask constrains every
update and shrinks on the reference's cadence (shrink-wrap).

``run`` drives the epochs (``n_epochs='auto'`` stops when the loss falls
by less than ``crit_conv_rate``).  With an ``output_folder`` it writes the
reference's output tree, checkpoints every ``n_batch_per_checkpoint``
batches (each naming the NEXT batch to run) and resumes from one.

The measured data lives on the device where it fits beside the working
set; else (or when ``data`` is a :class:`~.io.fastloader.FastLoader`) its
rows are gathered on the host and copied up while the previous step runs
(:class:`.offload.DataStager`).  ``offload_optimizer_state`` keeps the
object's optimizer state on the host, in y slabs under a first-order
optimizer (each slab's moments go up, update with the slab and come back
down), and ``offload_object`` the object itself: per angle each slab goes
up and is rotated and binned into the binned object, the patch gradients
accumulate there, and each slab's full-depth gradient is made from the
binned gradient's rows just before the slab's update, so the object is
never whole on the device.  Per-batch losses stay on the device until the
epoch ends (``run_epochs`` fetches them one epoch late); only a batch that
writes a checkpoint or an intermediate dump visits the host.
``use_orbax=True`` writes the sharded checkpoint form
(:func:`.io.checkpoint.save_sharded`, ``torch.distributed.checkpoint``):
every slab of the object and of its state is written as it lies, by the
rank that holds it.

Under a device mesh (``mesh=``, :mod:`.parallel`) each rank holds its y
slab of the object, of its optimizer state and of the support; every rank
runs the same program.  Grid-row tables take the structured mesh paths
(:mod:`.recon_mesh`): per angle, or immediate.  Everything else takes the
generic path: each rank runs its share of every batch over 'dp' (the
whole batch where ``data_axis`` does not divide it), the model reads the
object through the halo gather where the geometry allows it
(:func:`.parallel.halo.padded_window_gather`), else through a counted
all-gather of the slabs, the regularizers act on the slabs (sums over
'op', TV's one-row halo), and the gradients and losses are summed over
'dp'.  Rank 0 writes the outputs and the npz checkpoints, which hold the
whole object under the same keys as a single-device run; under
``use_orbax`` each rank of dp = 0 writes its own slab (no all-gather) and
rank 0 the rest.  A resume on a mesh reads only the rank's rows, from a
checkpoint of either form written at any mesh shape or on one device.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import convert
from . import offload as off_lib
from . import recon_mesh as mc_lib
from .config import ReconConfig
from .io import checkpoint as ckpt_lib
from .io import fastloader as fl_mod
from .io import output as out_lib
from .models import base as model_base
from .models import ptychography as ptycho_model
from .models import regularizers as regs
from .ops import patches as patch_ops
from .ops import propagate as prop
from .ops.cuda_scatter_grid import (scatter_grid2d_add,
                                    scatter_rowgrid_add_kernel)
from .ops.rotate import (rotate, rotate_adjoint, rotate_adjoint_taps,
                         rotate_and_bin_z, rotate_expanded_from_binned_z)
from .optim import optimizers as opt_lib
from .optim import params as param_lib
from .optim import second_order as so
from .parallel import halo as halo_lib
from .parallel.comm import flat_all_reduce
from .parallel.mesh import dp_share, gather_obj, shard_batch
from .utils import profiling as _prof
from .utils.initialize import initialize_object, initialize_probe

#: ``aux_init``'s names and the ``build_aux_params`` keyword each sets.
_AUX_INIT_KW = {'free_prop_cm': 'free_prop_cm',
                'slice_pos_cm_ls': 'slice_pos_cm_ls',
                'probe_pos_correction': 'probe_pos_correction_init',
                'tilt_ls': 'tilt_init',
                'prj_affine_ls': 'prj_affine_init',
                'ctf_lg_kappa': 'ctf_lg_kappa_init'}

#: Batches between two refreshes of the reweighted-L1 weights on the
#: immediate scheme, as in the reference.
WEIGHT_L1_INTERVAL = 10


def build_regularizers(cfg: ReconConfig) -> List[regs.Regularizer]:
    """The regularizers that the loss weights of ``cfg`` switch on."""
    ls: List[regs.Regularizer] = []
    lc = cfg.loss
    ut = cfg.train.unknown_type
    if lc.alpha_d or lc.alpha_b:
        kind = (regs.ReweightedL1Regularizer if lc.reweighted_l1
                else regs.L1Regularizer)
        ls.append(kind(ut, lc.alpha_d, lc.alpha_b))
    if lc.gamma:
        ls.append(regs.TVRegularizer(ut, lc.gamma))
    if lc.corr_reg:
        ls.append(regs.CorrRegularizer(ut, lc.corr_reg))
    if lc.grad_corr_reg:
        ls.append(regs.GradCorrRegularizer(ut, lc.grad_corr_reg))
    return ls


def resolve_device(device=None) -> torch.device:
    """The run's device: ``None`` means CUDA, which must then exist — the
    port never falls back to the CPU on its own."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           'run on the CPU')
    return dev


def rol_active(cfg: ReconConfig) -> bool:
    """Whether the object is rotated out of the autodiff loop: asked for,
    in 3D, and without tilt, whose three-axis rotation inside the model
    takes precedence."""
    return (cfg.train.rotate_out_of_loop and not cfg.geometry.two_d_mode
            and not cfg.refine.tilt_active)


def _check_slice(cfg: ReconConfig, mesh=None):
    """Raise for configurations outside the ported paths and for a mesh
    that does not match ``cfg.parallel``."""
    geo, t, p = cfg.geometry, cfg.train, cfg.parallel
    if t.update_scheme not in ('immediate', 'per angle'):
        raise ValueError("update_scheme must be 'immediate' or 'per angle', "
                         f'got {t.update_scheme!r}')
    if t.imm_grad_rotation not in ('exact', 'interp'):
        raise ValueError("imm_grad_rotation must be 'exact'|'interp', "
                         f'got {t.imm_grad_rotation!r}')
    for knob in ('prebin_z', 'stream_rotation'):
        if getattr(t, knob) not in ('auto', 'on', 'off'):
            raise ValueError(f"{knob} must be 'auto'|'on'|'off', got "
                             f'{getattr(t, knob)!r}')
    if cfg.refine.tilt_active and geo.two_d_mode:
        raise NotImplementedError('tilt is not implemented for two_d_mode')
    if mesh is None and (p.data_axis > 1 or p.object_axis > 1):
        raise ValueError(
            f'device meshes: cfg.parallel asks for data_axis={p.data_axis}, '
            f'object_axis={p.object_axis}; pass mesh=parallel.make_mesh('
            'cfg.parallel) on every rank')
    if mesh is not None and (mesh.n_dp, mesh.n_op) != (p.data_axis,
                                                       p.object_axis):
        raise ValueError(f'device meshes: the mesh is {mesh.n_dp} x '
                         f'{mesh.n_op}, cfg.parallel asks for '
                         f'{p.data_axis} x {p.object_axis}')
    if mesh is not None and geo.obj_size[0] % p.object_axis:
        raise ValueError(f'device meshes: the object y extent '
                         f'{geo.obj_size[0]} does not split into '
                         f'object_axis={p.object_axis} slabs')


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
    (per angle, or immediate).  ``finite_support_mask``: ``[y, x, z]``,
    0 outside the object's support; ``reg_list``: regularizers in place of
    the ones the config's loss weights switch on; ``output_folder``: where
    the reference's output tree, the loss log and the checkpoints go
    (nothing is written without one).  ``aux_init``: initial values of
    auxiliary refinables by name (``probe_pos_correction``,
    ``free_prop_cm``, ``prj_affine_ls``).  ``model``: the forward model
    (default :mod:`.models.ptychography`).  ``external_algorithm``:
    ``'ctf'`` for the CTF object update after each step, or None.
    ``data``: the measured magnitudes ``[n_theta, n_pos, h, w]``, an array
    or a :class:`~.io.fastloader.FastLoader` (whose rows stay on the host).
    ``device``: where it runs; ``None`` means CUDA and raises when there
    is none (under a mesh, the mesh's device).  ``mesh``: this rank's
    :class:`~.parallel.mesh.Mesh` (every rank builds its Reconstructor with
    the same arguments), None for one device."""

    def __init__(self, cfg: ReconConfig, *, data,
                 probe_pos: np.ndarray, theta_ls: Optional[np.ndarray] = None,
                 obj_init: Optional[np.ndarray] = None,
                 probe_init: Optional[np.ndarray] = None,
                 beamstop: Optional[np.ndarray] = None,
                 finite_support_mask: Optional[np.ndarray] = None,
                 reg_list=None, output_folder: Optional[str] = None,
                 aux_init: Optional[Dict[str, Any]] = None, model=None,
                 external_algorithm: Optional[str] = None, device=None,
                 mesh=None):
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        # Only rank 0 of a mesh writes files.
        self._writer = mesh is None or mesh.rank == 0
        if external_algorithm not in (None, 'ctf'):
            raise ValueError("external_algorithm must be None or 'ctf', got "
                             f'{external_algorithm!r}')
        # A non-AD object update after each optimizer step: 'ctf' replaces
        # the delta channel with the multi-distance CTF retrieval of the
        # measured holograms.
        self.external_algorithm = external_algorithm
        # A model is a namespace with predict(params, batch, cfg, pad_arr)
        # and optional hooks: compute_pad, transform_measured (refinements
        # applied to the data) and expand_indices (a batch's blocks to its
        # measurement rows).
        self.model = model or ptycho_model
        self.transform_measured = getattr(self.model, 'transform_measured',
                                          None)
        self.expand_indices = getattr(self.model, 'expand_indices', None)
        geo = cfg.geometry
        t = cfg.train
        # Routing, as the JAX package's run_epoch: updates that wait for
        # more than one batch, or an object rotated out of the loop, take
        # the accumulate-then-update loop, except the per-angle scheme with
        # the rotation out of the loop (or in 2D), which takes the
        # per-angle path (one program an angle).  A second-order object
        # optimizer (CG, Curveball) updates every batch through
        # second_order_step, whatever the scheme.
        self.second_order = t.optimizer in ('cg', 'curveball')
        self._rol = rol_active(cfg)
        accum = ((t.update_scheme == 'per angle' or self._rol
                  or t.n_batch_per_update > 1) and not self.second_order)
        self._angles = (accum and t.update_scheme == 'per angle'
                        and t.n_batch_per_update <= 1
                        and (self._rol or geo.two_d_mode)
                        and self.expand_indices is None)
        self._accum = accum and not self._angles
        _check_slice(cfg, mesh)
        if isinstance(data, fl_mod.FastLoader):
            self.loader, self.data = data, None
            data_shape = data.shape
        else:
            self.loader = None
            self.data = np.abs(np.asarray(data)).astype(np.float32)
            data_shape = self.data.shape
        self.n_theta, self.n_pos = data_shape[:2]
        data_nbytes = int(np.prod(data_shape)) * 4
        # One table [n_pos, 2] for every angle, or one an angle [n_theta,
        # n_pos, 2] (common_probe_pos=False).
        self.probe_pos = np.asarray(probe_pos, dtype=np.float64)
        if self.probe_pos.ndim not in (2, 3):
            raise ValueError('probe_pos must be [n_pos, 2] or [n_theta, '
                             f'n_pos, 2], got {self.probe_pos.shape}')
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
        # The object stays on the host until its placement (on the device,
        # or in host slabs under object offload) at the end.
        self.params: Dict[str, Any] = {
            'obj': torch.as_tensor(np.asarray(obj_init, np.float32)),
            'probe': torch.as_tensor(np.asarray(probe_init, np.float32),
                                     device=dev),
        }
        aux_kw = {'free_prop_cm': (None if isinstance(geo.free_prop_cm, str)
                                    else geo.free_prop_cm),
                  'slice_pos_cm_ls': geo.slice_pos_cm_ls}
        if cfg.refine.tilt_active:
            # The axis-0 tilt is the view angle, refined around its
            # nominal value.
            aux_kw['tilt_init'] = np.stack([self.theta_ls,
                                            np.zeros_like(self.theta_ls),
                                            np.zeros_like(self.theta_ls)])
        for k, v in (aux_init or {}).items():
            if k not in _AUX_INIT_KW:
                raise ValueError(f'aux_init: unknown refinable {k!r}')
            if k == 'ctf_lg_kappa':
                v = float(np.ravel(v)[0])
            aux_kw[_AUX_INIT_KW[k]] = v
        self.params.update(param_lib.build_aux_params(
            cfg, self.n_theta, self.n_pos, device=dev, **aux_kw))
        self.specs = param_lib.build_opt_specs(cfg)
        # The second-order object optimizers keep their own state; the
        # auxiliary leaves keep their first-order specs.  The object's
        # state is made with the object's placement.
        if self.second_order:
            self.specs.pop('obj', None)
        self.opt_state = opt_lib.tree_init(
            {k: v for k, v in self.specs.items() if k != 'obj'}, self.params)
        # The configuration the model's predict sees.  Under a
        # second-order optimizer in 3D the view rotation stays inside
        # autodiff even with rotate_out_of_loop: no path rotates the
        # object outside the model there.  (The JAX package skips it and
        # fits every angle to the object at theta = 0, ROADMAP C.)
        self._model_cfg = cfg
        if self.second_order and self._rol:
            self._model_cfg = cfg.replace(train=dataclasses.replace(
                t, rotate_out_of_loop=False))

        # -- statics -------------------------------------------------------
        compute_pad = getattr(self.model, 'compute_pad', None)
        if compute_pad is not None:
            self.pad_arr = compute_pad(cfg, geo.obj_size[:2], self.probe_pos)
        else:
            self.pad_arr = patch_ops.calculate_pad(
                geo.obj_size[:2], self.probe_pos.reshape(-1, 2),
                geo.probe_size)
        mb = cfg.train.minibatch_size
        # The stride when every minibatch of the one static table is a
        # constant-stride grid row (minibatches are slices of the table
        # unless randomize_probe_pos shuffles it), else None.
        self._rowgrid_stride = (
            None if (cfg.train.randomize_probe_pos
                     or self.model is not ptycho_model
                     or self.probe_pos.ndim != 2) else
            patch_ops.detect_row_grid(self.probe_pos, mb, geo.probe_size))
        # The band step: the immediate scheme on grid rows, in 3D, with
        # the view rotation (not tilt) inside the loop, one batch an
        # update.
        band_ok = (t.update_scheme == 'immediate' and not self._rol
                   and self._rowgrid_stride is not None and mesh is None
                   and not geo.two_d_mode and not cfg.refine.tilt_active
                   and not self.second_order
                   and self.external_algorithm is None)
        self._band = band_ok and not accum
        if (cfg.train.imm_grad_rotation == 'interp'
                and t.update_scheme == 'immediate' and not band_ok):
            # The knob reaches the band step only; the generic step
            # differentiates through the rotation (exact).
            warnings.warn("imm_grad_rotation='interp' requires the "
                          'band-granular immediate fast path (row-grid '
                          'scan table, 3D far-field ptychography); '
                          'running the exact-AD generic step instead')
        # The per-angle path at patch granularity (the patches'
        # gradients scattered by hand) on grid rows or under patch_grad,
        # for the ptychography model (the JAX package's gate: a
        # predict_from_patches, no transform_measured, the plain gather);
        # else it differentiates each chunk through the model's predict on
        # the whole rotated object.  Patches move binned in z only at
        # patch granularity (the band step's always are).
        self._patch_mode = mesh is None and (
            self._rowgrid_stride is not None
            or (t.patch_grad and self.model is ptycho_model))
        self._prebin = self._patch_mode and _band_prebin(cfg)
        nz_patch = geo.obj_size[2]
        if self._prebin:
            nz_patch = -(-nz_patch // geo.binning)
        # Gradient-chunk budget, the JAX package's formula on this device's
        # capacity: ~6 patch stacks live through forward + backward, plus
        # the multislice kernel's stored records (2 per probe mode).  Off
        # the per-angle path the chunk is one minibatch.
        patch_bytes = mb * geo.probe_size[0] * geo.probe_size[1] * nz_patch * 8
        obj_bytes = int(np.prod(geo.obj_size)) * 8
        hbm = _prof.hbm_limit_bytes(dev)
        stream_auto = obj_bytes > _prof.stream_rotation_auto_bytes(hbm)
        # Under object offload only the binned object's buffers live on the
        # device: the JAX package's conditions for it that are known here
        # (the full list is checked once the regularizers are).
        par, lc = cfg.parallel, cfg.loss
        self._obj_off_likely = (
            bool(par.offload_object) and par.offload_optimizer_state
            and par.offload_slabs > 1 and self._patch_mode and self._prebin
            and not t.exact_grad_rotation and t.update_scheme == 'per angle'
            and t.rotate_out_of_loop and t.n_batch_per_update <= 1
            and not self.second_order and not cfg.refine.tilt_active
            and finite_support_mask is None and reg_list is None
            and not (lc.alpha_d or lc.alpha_b or lc.gamma or lc.corr_reg
                     or lc.grad_corr_reg)
            and (par.offload_object is True
                 or obj_bytes > _prof.obj_offload_auto_bytes(hbm)))
        obj_budget = (obj_bytes // max(1, geo.binning)
                      if self._obj_off_likely else obj_bytes)
        avail = (hbm - _prof.xla_reserve_bytes(hbm)) - 6 * obj_budget
        kernel_db = (cfg.train.unknown_type == 'delta_beta'
                     and not geo.pure_projection
                     and geo.slice_pos_cm_ls is None and geo.fresnel_approx
                     and (cfg.train.fused_multislice == 'on'
                          or (cfg.train.fused_multislice == 'auto'
                              and dev.type == 'cuda')))
        bufs = 6 + 2 * cfg.train.n_probe_modes if kernel_db else 6
        self._chunk_bufs = bufs
        self._fuse_g = 1
        if self._angles:
            self._fuse_g = (int(max(1, min(64, avail // max(
                1, bufs * patch_bytes)))) if avail > 0 else 1)
            # A smaller chunk that lets the dataset live on the device
            # beats a larger one that does not.
            if self.data is not None and not self._obj_off_likely:
                resid = min(3.5e9, 0.22 * hbm)
                fit = (hbm - resid) - 6 * obj_budget - data_nbytes
                g_fit = int(fit // max(1, bufs * patch_bytes))
                if 1 <= g_fit < self._fuse_g:
                    self._fuse_g = g_fit
        ws_bytes = 6 * obj_budget + bufs * patch_bytes * self._fuse_g
        # The dataset lives on the device where it fits beside the working
        # set; else (and from a loader) its rows are staged from the host.
        self._data_dev_ok = (mesh is None and self.data is not None
                             and data_nbytes
                             <= (hbm - _prof.data_headroom_bytes(hbm))
                             - ws_bytes)
        # Chunks of whole grid rows of one complete 2D grid take the grid
        # gather and scatter (K3, K2); other row-grid chunks scatter row by
        # row (K6), any other table patch by patch.
        self._grid_scatter_rows = None
        if self._angles and self._rowgrid_stride is not None:
            full = patch_ops.detect_full_grid(self.probe_pos, mb,
                                              geo.probe_size)
            if full is not None and self.n_pos % mb == 0:
                n_b = self.n_pos // mb
                g_ = min(self._fuse_g, n_b)
                if n_b % g_ == 0:
                    self._grid_scatter_rows = g_
        bs = model_base.make_beamstop_mask(beamstop)
        self.beamstop_mask = (None if bs is None
                              else torch.as_tensor(bs, device=dev))
        self.finite_support_mask = None
        if finite_support_mask is not None:
            # A 2D mask ([y, x], as a one-page TIFF gives it) spans z.
            m = np.asarray(finite_support_mask, np.float32)
            m = np.broadcast_to(m.reshape(m.shape + (1,) * (3 - m.ndim)),
                                tuple(geo.obj_size))
            self.finite_support_mask = torch.as_tensor(
                self._own_rows(m).copy(), device=dev)
        self.reg_list = (list(reg_list) if reg_list is not None
                         else build_regularizers(cfg))
        self._needs_weight_l1 = any(
            isinstance(r, regs.ReweightedL1Regularizer) for r in self.reg_list)
        self.weight_l1 = (torch.ones(self._own_rows(self.params['obj']).shape,
                                     device=dev)
                          if self._needs_weight_l1 else None)
        # The per-angle streaming rotation: with the prebin hoist and the
        # -theta gradient rotate-back, the object is rotated and binned y
        # chunk by y chunk and the binned gradient expanded and rotated
        # back the same way, so neither the rotated full-depth object nor
        # the expanded gradient is ever whole beside the chunk's buffers;
        # regularizers need the rotated object, so they turn it off.
        # 'auto' streams past stream_rotation_auto_bytes of the device.
        self._stream_rot = (self._prebin and not geo.two_d_mode
                            and (t.stream_rotation == 'on'
                                 or (t.stream_rotation == 'auto'
                                     and stream_auto))
                            and not t.exact_grad_rotation
                            and not self.reg_list)
        # -- out-of-core (the reference's shared_file mode) ----------------
        # offload_optimizer_state keeps the object's optimizer state on the
        # host where it has one (not GD's): in y slabs under a first-order
        # optimizer with offload_slabs > 1, else whole (CG, Curveball).
        # offload_object keeps the object there too, in the same slabs, on
        # the JAX package's conditions; True raises where they fail,
        # 'auto' takes it past obj_offload_auto_bytes where they hold.
        has_state = (self.specs['obj'].kind != 'gd' if 'obj' in self.specs
                     else self.second_order and t.optimize_object)
        self._off_state = bool(par.offload_optimizer_state and has_state)
        self._off_slabbed = (self._off_state and 'obj' in self.specs
                             and par.offload_slabs > 1
                             and (mesh is None or mesh.n_op == 1))
        self._slab_keys = self._slab_ranges = None
        if self._off_slabbed:
            self._slab_keys, self._slab_ranges = off_lib.slab_ranges(
                geo.obj_size[0], par.offload_slabs)
        want_obj_off = par.offload_object
        if want_obj_off == 'auto':
            if mesh is not None:
                # Each rank holds obj / object_axis: the same boundary on
                # the rank's share.
                want_obj_off = (self._off_state and obj_bytes / mesh.n_op
                                > _prof.obj_offload_auto_bytes(hbm))
            else:
                want_obj_off = (self._off_slabbed and obj_bytes
                                > _prof.obj_offload_auto_bytes(hbm))
        self._obj_offloaded = False
        # Under a mesh each rank keeps its own slab on the host, on the
        # per-angle mesh path's conditions (resolved below).
        want_obj_off_mesh = False
        if want_obj_off and mesh is not None:
            want_obj_off_mesh, want_obj_off = par.offload_object, False
        if want_obj_off:
            problems = []
            if not self._off_slabbed:
                problems.append('offload_optimizer_state with '
                                'offload_slabs>1')
            if not (self._patch_mode and self._prebin):
                problems.append('the patch-granular prebin angle path '
                                '(row-grid scan table, delta_beta, '
                                'binning>1)')
            if geo.two_d_mode:
                problems.append('a 3D object')
            if t.exact_grad_rotation:
                problems.append('the interp gradient rotate-back '
                                '(exact_grad_rotation=False)')
            if self.reg_list or self._needs_weight_l1:
                problems.append('no regularizers')
            if self.finite_support_mask is not None:
                problems.append('no finite-support mask')
            if (t.update_scheme != 'per angle' or not t.rotate_out_of_loop
                    or t.n_batch_per_update > 1):
                problems.append("update_scheme='per angle' with "
                                'rotate_out_of_loop')
            if self.second_order:
                problems.append('a first-order object optimizer')
            if cfg.refine.tilt_active:
                problems.append('no tilt')
            if problems and par.offload_object is True:
                raise ValueError('offload_object requires: '
                                 + '; '.join(problems))
            self._obj_offloaded = not problems
        self._arena = off_lib.HostArena(dev)
        self._mover = off_lib.HostMover(dev)
        # -- the mesh: structured paths, the generic path's object reads ---
        self._mc = self._mci = None
        self._mc_decline_reasons: List[str] = []
        self._gather_fn = None
        self._dp_split = False
        self._obj_off_mesh = False
        self._shard = None
        if mesh is not None:
            self._setup_mesh(want_obj_off_mesh)
        self.i_opt_batch = 0      # optimizer step counter
        self.global_batch = 0     # epoch*n_batch + i_batch, for update gates
        self.loss_history: List[float] = []
        self.epoch_seconds: List[float] = []    # run()'s epoch walls
        self._stager = None
        self.stop_requested = False
        self._t_start = time.time()
        self._ckpt_seconds = 0.0
        self._ckpt_count = 0
        self._ckpt_warned = False
        self.verbose = False

        # -- outputs, checkpoints and resume (only with an output folder) --
        self.output_folder = output_folder
        self._logger = None
        self._stdout_f = None
        self._start_epoch = 0
        self._start_batch = 0
        self._restored = False
        restored_obj_state = None
        if output_folder is not None:
            if self._writer:
                os.makedirs(output_folder, exist_ok=True)
            if cfg.io.save_stdout and self._writer:
                # Tee the progress lines to a timestamped file; asking for
                # the tee turns the lines on.
                ts = time.strftime('%Y%m%d_%H%M%S')
                self._stdout_f = open(
                    os.path.join(output_folder, f'stdout_{ts}.txt'), 'a')
                self.verbose = True
            if self._writer:
                out_lib.write_summary(cfg, output_folder)
            if cfg.io.use_checkpoint:
                restored_obj_state = self._restore(
                    os.path.join(output_folder, 'checkpoint'))
            if self._writer:
                self._logger = out_lib.LossLogger(
                    output_folder,
                    append=self._start_epoch > 0 or self._start_batch > 0)
        self._place_object(restored_obj_state)

    # -- the mesh ------------------------------------------------------------
    def _setup_mesh(self, want_obj_off_mesh):
        """The mesh's layouts: the structured per-angle or immediate path
        (with the JAX package's decline reasons), the object kept on the
        host by slab under the per-angle path (``offload_object``), and the
        generic path's data split and object reads."""
        cfg = self.cfg
        geo = cfg.geometry
        mesh = self.mesh
        self._mc = mc_lib.build_mc_layout(self)
        if self._mc is None and cfg.train.update_scheme == 'immediate':
            # The per-angle layout's scheme reason is no decline of this
            # path.
            self._mc_decline_reasons = []
            self._mci = mc_lib.build_mc_imm_layout(self)
        if want_obj_off_mesh:
            problems = []
            if self._mc is None:
                problems.append(
                    'the mesh patch-granular fast path ('
                    + ('; '.join(self._mc_decline_reasons) or 'geometry')
                    + ')')
            elif not self._mc['prebin']:
                problems.append('prebin (delta_beta, binning>1)')
            if self.reg_list or self._needs_weight_l1:
                problems.append('no regularizers')
            if not self._off_state:
                problems.append('offload_optimizer_state')
            if problems and want_obj_off_mesh is True:
                raise ValueError('offload_object under a mesh requires: '
                                 + '; '.join(problems))
            self._obj_off_mesh = not problems
        if self._mc is None and self._mci is None and mesh.n_op > 1:
            why = '; '.join(self._mc_decline_reasons) or 'geometry'
            warnings.warn('mesh patch-granular fast path declined '
                          f'({why}); running the generic mesh path')
        self._dp_split = (mesh.n_dp > 1 and cfg.train.minibatch_size
                          % mesh.n_dp == 0)
        self._shard = halo_lib.SlabShard(mesh) if mesh.n_op > 1 else None
        gw = getattr(self.model, 'gather_window', None)
        use = cfg.parallel.use_halo_gather
        if (mesh.n_op > 1 and use and not cfg.refine.tilt_active
                and (self.model is ptycho_model or gw is not None)):
            window_y = gw(cfg)[0] if gw is not None else geo.probe_size[0]
            if halo_lib.padded_geometry(geo.obj_size[0], self.pad_arr,
                                        window_y, mesh.n_op):
                ut = cfg.train.unknown_type
                self._gather_fn = (
                    lambda o, pad, pos, win: halo_lib.padded_window_gather(
                        o, pad, pos, win, ut, mesh))
            elif use is True:
                warnings.warn('use_halo_gather requested but geometry does '
                              'not satisfy its constraints; falling back to '
                              'a full-object all-gather for the patch '
                              'gather')

    def _own_rows(self, x):
        """This rank's y slab of a whole-object array (``x`` itself off a
        mesh or without an object split)."""
        if self.mesh is None or self.mesh.n_op == 1:
            return x
        st, sz = self.mesh.slab(int(x.shape[0]))
        return x[st:st + sz]

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The whole object (or a slab-shaped leaf) from the ranks' slabs;
        every rank calls it."""
        if self.mesh is None or self.mesh.n_op == 1:
            return t
        return gather_obj(t.to(self.device), self.mesh)

    def _obj_up(self) -> torch.Tensor:
        """The object on the device (this rank's slab, from its host block
        where the mesh keeps it there)."""
        if self._obj_off_mesh:
            self._mover.wait()
            self.params['obj'] = self._mover.up(self._obj_host)
        return self.params['obj']

    def _obj_down(self):
        """The updated slab back into its host block (mesh object
        offload)."""
        if self._obj_off_mesh:
            self._mover.down(self._obj_host, self.params['obj'])
            self.params['obj'] = self._obj_host

    def _predict(self, params, batch, cfg, **kw):
        """The model's ``predict``; under a mesh with an object split the
        object is this rank's slab, read through the halo gather where the
        geometry allows it, else gathered whole."""
        if self.mesh is not None and self.mesh.n_op > 1:
            if self._gather_fn is not None:
                return self.model.predict(params, batch, cfg, self.pad_arr,
                                          gather_fn=self._gather_fn, **kw)
            params = {**params, 'obj': halo_lib.all_gather_obj(
                params['obj'], self.mesh)}
        return self.model.predict(params, batch, cfg, self.pad_arr, **kw)

    def _dp_weight(self) -> float:
        """The weight of this rank's share of a batch loss: its share's
        mean, and the regularizers (the same on every rank), count
        ``1/data_axis`` where the batch splits, so that the sum over 'dp'
        is the batch's loss."""
        return 1.0 / self.mesh.n_dp if self._dp_split else 1.0

    def _share(self, batch, measured):
        """This rank's dp share of a batch dict and its measured rows (the
        rows of every distance block for the multi-distance model)."""
        if not self._dp_split:
            return batch, measured
        if self.expand_indices is None:
            return shard_batch(batch, measured, self.mesh)
        n = len(batch['ind_batch'])
        sl = dp_share(n, self.mesh)
        batch, _ = shard_batch(batch, measured, self.mesh)
        rows = measured.reshape((-1, n) + tuple(measured.shape[1:]))
        return batch, rows[:, sl].reshape((-1,) + tuple(measured.shape[1:]))

    def _dp_sum(self, tensors):
        """Sum a list of tensors over 'dp' (one collective) where batches
        split; else as they are."""
        if not self._dp_split:
            return list(tensors)
        return flat_all_reduce(self.mesh.comm, tensors, ('dp',))

    def _restore(self, folder: str):
        """Continue from the checkpoint in ``folder``, written by either
        package, slabbed or not: parameters, optimizer state, step counts,
        the NEXT (epoch, batch) to run, and the shrink-wrapped support mask
        where the checkpoint holds one.  The object (and, under offload,
        its state) stays on the host for :meth:`_place_object`, which
        splits it for this run's configuration.  Under a mesh with an
        object split only the rank's rows are read (and kept).  Returns
        the object's restored state, or None."""
        rows = None
        if self.mesh is not None and self.mesh.n_op > 1:
            st, sz = self.mesh.slab(self.cfg.geometry.obj_size[0])
            rows = (st, st + sz)
        ck = convert.load_checkpoint(folder, device=self.device,
                                     host_obj=True,
                                     host_obj_state=self._off_state,
                                     rows=rows)
        if ck is None:
            if self.cfg.io.force_to_use_checkpoint:
                raise FileNotFoundError(
                    'force_to_use_checkpoint set but no checkpoint found')
            return None
        self.params = ck['params']
        self._restored = True
        # A GD leaf has no state and so no entry in the file.
        self.opt_state = {k: ck['opt_state'].get(k, v)
                          for k, v in self.opt_state.items()}
        self._start_epoch, self._start_batch = ck['i_epoch'], ck['i_batch']
        self.i_opt_batch = ck['i_opt_batch']
        self.global_batch = ck['global_batch']
        mask = ck['extra'].get('finite_support_mask')
        if mask is not None and self.finite_support_mask is not None:
            self.finite_support_mask = torch.as_tensor(
                np.asarray(mask, np.float32).copy(), device=self.device)
        return ck['opt_state'].get('obj')

    def _place_object(self, restored_state=None):
        """Put the object and its optimizer state (``restored_state``, or a
        fresh one) where the run keeps them: on the device, or in host
        blocks (page-locked on a card), in y slabs where offloaded slab by
        slab.  An offloaded state is never made on the device.  A restored
        object and state are already this rank's rows."""
        t = self.cfg.train
        arena = self._arena
        obj = self.params['obj']                        # on the host
        if not self._restored:
            obj = self._own_rows(obj)
        if self._obj_off_mesh:
            self._obj_host = arena.copy_of(obj)
            self.params['obj'] = self._obj_host
        elif self._obj_offloaded:
            self.params['obj'] = off_lib.slab_views(
                arena.copy_of(obj), self._slab_keys, self._slab_ranges)
        else:
            obj = obj.to(self.device)
            if self._off_slabbed and obj.device.type == 'cpu':
                # The slab updates write in place: own the memory.
                obj = obj.clone()
            self.params['obj'] = obj
        st = restored_state
        if st is None and 'obj' in self.specs and self._off_state:
            # The moments' zeros go straight into host blocks.
            shapes = opt_lib.opt_init(self.specs['obj'],
                                      torch.empty(obj.shape, device='meta'))
            st = {n: arena.zeros(a.shape, a.dtype)
                  for n, a in shapes.items()}
        elif st is not None and self._off_state:
            st = {n: arena.copy_of(a) for n, a in st.items()}
        elif st is None and 'obj' in self.specs:
            st = opt_lib.opt_init(self.specs['obj'], self.params['obj'])
        elif st is None and self.second_order and t.optimize_object:
            init = so.cg_init if t.optimizer == 'cg' else so.curveball_init
            st = init(obj if self._off_state else self.params['obj'])
            if self._off_state:
                st = {n: arena.copy_of(a) for n, a in st.items()}
        if st is None:
            return
        if self._off_state:
            if self._off_slabbed:
                st = {n: off_lib.slab_views(a, self._slab_keys,
                                            self._slab_ranges)
                      for n, a in st.items()}
        else:
            st = {n: a.to(self.device) for n, a in st.items()}
        self.opt_state = {'obj': st, **{k: v for k, v in self.opt_state.items()
                                        if k != 'obj'}}

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
                             and self.probe_pos.ndim == 2
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

    def _pos_table(self, i_theta: int) -> np.ndarray:
        """The scan table ``[n_pos, 2]`` of angle ``i_theta``."""
        return (self.probe_pos if self.probe_pos.ndim == 2
                else self.probe_pos[i_theta])

    def _stage_angle(self, i_theta: int, inds_list):
        """The angle's minibatches in gradient chunks of ``g = min(fuse_g,
        n_b)``, the last chunk padded by repeats of the last batch at
        weight 0.  Returns numpy ``(inds [n_c, g*mb], pos [n_c, g*mb, 2],
        w [n_c, g], n_b)``."""
        inds_arr = np.stack(inds_list)                    # [n_b, mb]
        n_b, mb = inds_arr.shape
        g = min(self._fuse_g, n_b)
        n_c = -(-n_b // g)
        pad_b = n_c * g - n_b
        w = np.ones(n_b, np.float32)
        if pad_b:
            inds_arr = np.concatenate(
                [inds_arr, np.repeat(inds_arr[-1:], pad_b, axis=0)])
            w = np.concatenate([w, np.zeros(pad_b, np.float32)])
        pos = self._pos_table(i_theta)[inds_arr].reshape(n_c, g * mb, 2)
        return (inds_arr.reshape(n_c, g * mb), pos.astype(np.float32),
                w.reshape(n_c, g), n_b)

    def stager(self) -> off_lib.DataStager:
        """The measured data's one way onto the device (made at first use,
        device-resident where ``_data_dev_ok``)."""
        if self._stager is None:
            self._stager = off_lib.DataStager(
                self.data, self.loader, self.device, self._data_dev_ok,
                self._arena)
        return self._stager

    def _dataset(self) -> torch.Tensor:
        """The device-resident dataset, moved there on first use."""
        return self.stager().dataset()

    def _angle_rows(self, i_theta: int, inds_list):
        """A request for the angle's measured rows ``[n_c, g*mb, py, px]``
        in :meth:`_stage_angle`'s chunks (take it with
        ``stager().take``)."""
        inds = self._stage_angle(i_theta, inds_list)[0]
        return self.stager().request(i_theta, inds)

    # ------------------------------------------------------------------
    def _zmajor(self) -> bool:
        cfg = self.cfg
        geo = cfg.geometry
        return ((cfg.train.zmajor_extract == 'on'
                 or (cfg.train.zmajor_extract == 'auto'
                     and self.device.type == 'cuda'))
                and cfg.train.unknown_type == 'delta_beta'
                and not geo.pure_projection and geo.slice_pos_cm_ls is None)

    def _patch_grads(self, sub, i_theta, theta, inds, measured, zm, groups,
                     w=None, spot_w=None, mb=None, prebin=None):
        """Forward model and loss of the patches ``sub`` (z-major when
        ``zm``) of the spots ``inds`` against ``measured``, and the
        gradient of the sum of the ``groups`` minibatches' mean losses,
        each weighted by ``w [groups]`` (a pad batch at 0), with respect to
        ``sub`` and every refined leaf but the object (the probe, the
        auxiliary refinables).  Returns ``(losses [groups], g_sub, {name:
        grad})``; ``g_sub`` is in the scatter layout ``[N, py, px, zb, 2]``
        (for z-major patches, a view of the z-major gradient, which the
        scatter kernels read in place).  The mesh paths weight spots
        instead (``spot_w [N]``, each group's sum over ``mb``: a rank's
        part of a batch's mean) and say whether the patches are binned in
        z (``prebin``)."""
        prebin = self._prebin if prebin is None else prebin
        cfg = self.cfg
        aux_names = [k for k in self.specs if k != 'obj']
        sub.requires_grad_(True)
        aux = {k: v.detach().requires_grad_(k in aux_names)
               for k, v in self.params.items() if k != 'obj'}
        batch = {'i_theta': i_theta, 'theta': theta,
                 'ind_batch': np.asarray(inds).reshape(-1)}
        with torch.enable_grad():
            pred = ptycho_model.predict_from_patches(
                aux, batch, sub, cfg, prebinned_z=prebin, zmajor=zm)
            per_item = model_base.mismatch_loss(
                pred, measured, cfg.loss.loss_function_type,
                cfg.loss.raw_data_type, cfg.loss.poisson_multiplier,
                self.beamstop_mask, per_item=True)
            if spot_w is not None:
                per_batch = (per_item * spot_w).reshape(groups, -1).sum(1) / mb
            else:
                per_batch = per_item.reshape(groups, -1).mean(1)
            total = per_batch.sum() if w is None else (per_batch * w).sum()
            grads = torch.autograd.grad(total,
                                        [sub] + [aux[k] for k in aux_names])
        g_sub = grads[0]
        if zm:
            g_sub = g_sub.permute(2, 3, 4, 0, 1)
        return per_batch.detach(), g_sub, dict(zip(aux_names, grads[1:]))

    def patch_accum(self, obj_pad, theta, i_theta, inds_all, pos_all,
                    measured_all, w_all):
        """Scan the angle's gradient chunks (spots ``inds_all[c]`` at
        ``pos_all[c]``, batch weights ``w_all[c]``) at patch granularity,
        adding the patch gradients into an ``obj_pad``-shaped f32
        accumulator: chunks of whole rows of one complete grid through the
        grid scatter (K2), other grid-row chunks one row at a time (K6, on
        the row's slice of the chunk's gradient), any other table patch by
        patch (:func:`patches.scatter_patches_add`).  The chunk objective
        is the weighted sum of its batches' mean losses.  Returns
        ``(acc_obj, acc_aux, losses [n_c, g])``; ``acc_aux`` holds the
        gradients of the other refined leaves."""
        cfg = self.cfg
        geo = cfg.geometry
        g = w_all.shape[1]
        mb = cfg.train.minibatch_size
        full_grid = g == self._grid_scatter_rows
        with _prof.span('stage'):
            w_dev = torch.as_tensor(w_all, device=obj_pad.device)
        zm = self._zmajor()
        with _prof.span('layout'):
            # run_bfloat16: extract from a bf16 copy (the same values the
            # model would cast to); the accumulator stays f32.
            obj_ex = (obj_pad.to(torch.bfloat16) if cfg.train.run_bfloat16
                      else obj_pad)
            obj_zx = obj_ex.permute(2, 3, 0, 1).contiguous() if zm else None
            acc_obj = torch.zeros_like(obj_pad)
            acc_aux = {k: torch.zeros_like(self.params[k])
                       for k in self.specs if k != 'obj'}
        pad_off = np.asarray([self.pad_arr[0][0], self.pad_arr[1][0]])
        losses = []
        for c in range(pos_all.shape[0]):
            with _prof.span('chunk'):
                pos_int = np.round(pos_all[c]).astype(np.int64) + pad_off
                with _prof.span('extract'):
                    if zm:
                        sub = patch_ops.extract_patches_zmajor(
                            obj_zx, pos_int, geo.probe_size)
                    elif full_grid:
                        # Whole rows of the complete grid: the grid gather
                        # (the exact transpose of the grid scatter below).
                        sub = patch_ops.extract_grid2d_best(
                            obj_ex, pos_int[0, 0], pos_int[0, 1],
                            self._rowgrid_stride, g, mb, geo.probe_size)
                    else:
                        sub = patch_ops.extract_patches(obj_ex, pos_int,
                                                        geo.probe_size)
                with _prof.span('model'):
                    per_batch, g_sub, g_aux = self._patch_grads(
                        sub, i_theta, theta, inds_all[c], measured_all[c],
                        zm, g, w_dev[c])
                with _prof.span('scatter'):
                    if full_grid:
                        scatter_grid2d_add(
                            acc_obj, g_sub, pos_int[0, 0], pos_int[0, 1],
                            self._rowgrid_stride, g)
                    elif self._rowgrid_stride is not None:
                        for r in range(g):
                            scatter_rowgrid_add_kernel(
                                acc_obj, g_sub[r * mb:(r + 1) * mb],
                                pos_int[r * mb, 0], pos_int[r * mb, 1],
                                self._rowgrid_stride)
                    else:
                        patch_ops.scatter_patches_add(acc_obj, g_sub,
                                                      pos_int)
                for k, gk in g_aux.items():
                    acc_aux[k] += gk
                losses.append(per_batch)
        return acc_obj, acc_aux, torch.stack(losses)

    def _first_order_update(self, grads, i_opt_batch: int,
                            global_batch: int, obj_slab_grad=None):
        """The updated parameters, before the constraints: an optimizer
        step of every spec'd leaf (the probe inside its update window, the
        auxiliary leaves after ``other_params_update_delay`` batches).
        Offloaded object state goes up for the update and comes back down:
        whole, or slab by slab with each slab's object rows (from the host
        under object offload, constrained there) and gradient rows
        (``obj_slab_grad(start, size)`` where given, else ``grads['obj']``'s
        rows)."""
        cfg = self.cfg
        mask = {}
        if 'probe' in self.specs:
            mask['probe'] = param_lib.probe_update_gate(cfg, global_batch)
        aux_on = param_lib.aux_update_gate(cfg, global_batch)
        for k in self.specs:
            if k not in ('obj', 'probe'):
                mask[k] = aux_on
        if obj_slab_grad is not None and not self._off_slabbed:
            grads = {**grads, 'obj': obj_slab_grad(
                0, self.cfg.geometry.obj_size[0])}
        if not self._off_slabbed:
            whole = self._off_state and 'obj' in self.specs
            state = self.opt_state
            if whole:
                state = {**state, 'obj': self._obj_state_up()}
            params, state = opt_lib.tree_apply(
                self.specs, self.params, grads, state, i_opt_batch,
                update_mask=mask)
            if whole:
                state['obj'] = self._obj_state_down(state['obj'])
            self.opt_state = state
            return params
        specs = {k: v for k, v in self.specs.items() if k != 'obj'}
        params, self.opt_state = opt_lib.tree_apply(
            specs, self.params, grads, self.opt_state, i_opt_batch,
            update_mask=mask)
        mv = self._mover
        mv.wait()
        host_st = self.opt_state['obj']
        obj = params['obj']
        for key, (st, sz) in zip(self._slab_keys, self._slab_ranges):
            g_k = (obj_slab_grad(st, sz) if obj_slab_grad is not None
                   else grads['obj'][st:st + sz])
            o_k = mv.up(obj[key]) if self._obj_offloaded else obj[st:st + sz]
            st_k = {n: mv.up(h[key]) for n, h in host_st.items()}
            o2, st2 = opt_lib.opt_apply(self.specs['obj'], o_k, g_k, st_k,
                                        i_opt_batch)
            del g_k, o_k, st_k
            if self._obj_offloaded:
                mv.down(obj[key], param_lib.apply_object_constraints(
                    o2, cfg, None))
            else:
                obj[st:st + sz] = o2
            for n, a in st2.items():
                mv.down(host_st[n][key], a)
            del o2, st2
        return params

    def _obj_state_up(self):
        """The object's whole offloaded optimizer state on the device."""
        self._mover.wait()
        return {n: self._mover.up(h)
                for n, h in self.opt_state['obj'].items()}

    def _obj_state_down(self, state):
        """``state`` back into the object state's host blocks; returns
        them."""
        host = self.opt_state['obj']
        for n, a in state.items():
            self._mover.down(host[n], a)
        return host

    def _constrain(self, params):
        """The parameter and object constraints, the support included;
        the result becomes the run's parameters (an offloaded object was
        constrained slab by slab)."""
        params = param_lib.apply_param_constraints(params, self.cfg)
        if not self._obj_offloaded:
            params['obj'] = param_lib.apply_object_constraints(
                params['obj'], self.cfg, self.finite_support_mask)
        self.params = params

    def apply_step(self, grads, i_opt_batch: int, global_batch: int,
                   obj_slab_grad=None):
        """Optimizer update of every spec'd leaf, then the constraints,
        the support mask included."""
        self._constrain(self._first_order_update(
            grads, i_opt_batch, global_batch, obj_slab_grad))

    def _rotate_and_bin(self, theta: float) -> torch.Tensor:
        """The object rotated by ``theta`` and binned in z (y chunk by y
        chunk at the streaming sizes); under object offload each host
        slab goes up and into its rows of the binned object."""
        geo = self.cfg.geometry
        method = self.cfg.train.interpolation
        obj = self.params['obj']
        if not self._obj_offloaded:
            return rotate_and_bin_z(obj, theta, geo.binning, method=method)
        mv = self._mover
        mv.wait()
        first = obj[self._slab_keys[0]]
        out = torch.empty((geo.obj_size[0], geo.obj_size[1],
                           -(-geo.obj_size[2] // geo.binning))
                          + tuple(first.shape[3:]), device=self.device)
        for key, (st, sz) in zip(self._slab_keys, self._slab_ranges):
            out[st:st + sz] = rotate_and_bin_z(mv.up(obj[key]), theta,
                                               geo.binning, method=method)
        return out

    # -- regularizers and the support ------------------------------------
    @staticmethod
    def _weight_l1_refresh(obj, sh=None):
        """Reweighted-L1 weights ``max(obj) / (|obj| + 1e-4 mean(obj))``;
        ones until the object is first nonzero.  Under a mesh (``sh``, the
        slab's :class:`~.parallel.halo.SlabShard`) the max and the mean are
        the whole object's."""
        if sh is None:
            mean, mx = torch.mean(obj), torch.max(obj)
        else:
            mean = sh.sum(torch.sum(obj).detach()) / (obj.numel() * sh.n)
            mx = sh.max(torch.max(obj))
        denom = torch.abs(obj) + 1e-4 * mean
        w = torch.where(denom > 0, mx / denom, torch.ones_like(obj))
        return torch.nan_to_num(w, nan=1.0, posinf=1.0)

    def _regularization(self, obj):
        """The regularizers' value at ``obj`` (this rank's slab under a
        mesh: the whole object's value on every rank)."""
        return regs.total_regularization(self.reg_list, obj,
                                         weight_l1=self.weight_l1,
                                         shard=self._shard)

    def _reg_value_and_grad(self, obj):
        """The regularizers' value and gradient at ``obj``, by autograd."""
        o = obj.detach().requires_grad_(True)
        with torch.enable_grad():
            rv = self._regularization(o)
            if not torch.is_tensor(rv):        # every weight zero
                return torch.zeros((), device=o.device), torch.zeros_like(o)
            g, = torch.autograd.grad(rv, o)
        return rv.detach(), g

    def _shrink(self):
        """Shrink-wrap: drop the support where delta fell below
        ``shrink_threshold``."""
        keep = self.params['obj'][..., 0] >= self.cfg.train.shrink_threshold
        self.finite_support_mask = self.finite_support_mask * keep

    # ------------------------------------------------------------------
    @torch.no_grad()
    def angle_step(self, i_theta: int, inds_list,
                   measured: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One angle, one update: rotate the object (in 2D nothing
        rotates), accumulate its gradient-chunks' gradients, rotate the
        gradient back and update.  At patch granularity (:meth:`patch_accum`)
        the rotated object is padded and binned in z once, or, streaming,
        rotated and binned y chunk by y chunk; else each chunk is
        differentiated through the model's ``predict`` on the whole
        rotated object (:meth:`_chunk_grads`).  Regularizers are taken on
        the rotated object and count once a real batch; they need the
        full-depth gradient, so the bins expand by ``repeat`` before the
        rotate-back.  The rotate-back is the -theta interpolation (reading
        the binned gradient where nothing needs it expanded first) or,
        under ``exact_grad_rotation``, the rotation's exact transpose.
        ``measured``: the angle's rows (:meth:`_angle_rows`), staged here
        when not given.  Under object offload the binned object is made
        slab by slab from the host, and the update makes each slab's
        gradient from the binned gradient's rows.  Returns the real
        batches' losses, on the device."""
        cfg = self.cfg
        geo = cfg.geometry
        t = cfg.train
        rotates = not geo.two_d_mode
        theta = float(self.theta_ls[i_theta])
        with _prof.span('stage'):
            inds, pos, w, n_b = self._stage_angle(i_theta, inds_list)
            if measured is None:
                measured = self.stager().rows(i_theta, inds)
        method = t.interpolation
        obj = self.params['obj']
        stream = self._stream_rot or self._obj_offloaded
        obj_rot = None
        with _prof.span('rotate'):
            if not stream:
                obj_rot = (rotate(obj, theta, method=method) if rotates
                           else obj)
            if self._patch_mode:
                if stream:
                    obj_pad = patch_ops.pad_object(
                        self._rotate_and_bin(theta), self.pad_arr,
                        t.unknown_type)
                else:
                    obj_pad = patch_ops.pad_object(obj_rot, self.pad_arr,
                                                   t.unknown_type)
                    if self._prebin:
                        obj_pad = prop.bin_z_sum(obj_pad, geo.binning,
                                                 axis=2)
        if self._patch_mode:
            if not self.reg_list:
                obj_rot = None
            acc_obj, grads, losses = self.patch_accum(
                obj_pad, theta, i_theta, inds, pos, measured, w)
            del obj_pad
            p = self.pad_arr
            g_rot = acc_obj[p[0][0]:acc_obj.shape[0] - p[0][1],
                            p[1][0]:acc_obj.shape[1] - p[1][1]]
            del acc_obj
            fused_back = (self._prebin and not stream
                          and not self.reg_list and not t.exact_grad_rotation
                          and rotates)
            if self._prebin and not stream and not fused_back:
                with _prof.span('rotate_back'):
                    g_rot = torch.repeat_interleave(
                        g_rot, geo.binning, dim=2)[:, :, :geo.obj_size[2]]
            if self.reg_list:
                with _prof.span('reg'):
                    rv, g_reg = self._reg_value_and_grad(obj_rot)
                    g_rot = g_rot + float(w.sum()) * g_reg
                    losses = losses + rv
        else:
            losses, grads = [], None
            for c in range(inds.shape[0]):
                with _prof.span('chunk'):
                    per_batch, gc = self._chunk_grads(
                        obj_rot, i_theta, theta, inds[c], pos[c],
                        measured[c], w[c])
                    losses.append(per_batch)
                    if grads is None:
                        grads = gc
                    else:
                        for k, gk in gc.items():
                            grads[k].add_(gk)
            losses = torch.stack(losses)
            g_rot = grads.pop('obj')
            fused_back = False
        del obj_rot, measured
        slab_grad = None
        with _prof.span('rotate_back'):
            if not rotates:
                g_obj = g_rot
            elif stream and self._off_slabbed:
                # Each slab's full-depth gradient just before its update,
                # from the binned gradient's rows (rotation acts in each y
                # plane): the rotate-back runs inside the update.
                g_obj = None

                def slab_grad(st, sz):
                    return rotate_expanded_from_binned_z(
                        g_rot[st:st + sz], -theta, geo.binning,
                        geo.obj_size[2], method=method)
            elif stream or fused_back:
                # The binned gradient expanded in z inside the
                # rotate-back's gather, in y chunks at the streaming sizes.
                g_obj = rotate_expanded_from_binned_z(
                    g_rot, -theta, geo.binning, geo.obj_size[2],
                    method=method)
            elif t.exact_grad_rotation:
                g_obj = rotate_adjoint(g_rot, theta, method=method)
            else:
                g_obj = rotate(g_rot, -theta, method=method)
            if slab_grad is None:
                del g_rot
        with _prof.span('update'):
            self.apply_step({**grads, 'obj': g_obj}, self.i_opt_batch,
                            self.global_batch, obj_slab_grad=slab_grad)
        self.i_opt_batch += 1
        self.global_batch += len(inds_list)
        return losses.reshape(-1)[:n_b]

    def _chunk_grads(self, obj_rot, i_theta, theta, inds, pos, measured, w):
        """One gradient chunk through the model's ``predict`` on the whole
        (rotated) object ``obj_rot``: the weighted sum of its ``g``
        batches' mean losses plus the regularizers at ``obj_rot`` once a
        real batch, differentiated in the object (in the rotated frame, as
        the patch-granular branch's accumulator is) and every other refined
        leaf.  Returns ``(per-batch losses [g], {name: grad})``; each loss
        carries the regularizers' value.  Under a mesh each rank runs its
        dp share of every batch and the sums go over 'dp'."""
        cfg = self.cfg
        names = ['obj'] + [k for k in self.specs if k != 'obj']
        params = {k: v.detach().requires_grad_(k in self.specs)
                  for k, v in self.params.items()}
        params['obj'] = obj_rot.detach().requires_grad_(True)
        inds = np.asarray(inds)
        if self._dp_split:
            g = len(w)
            mb = len(inds) // g
            sl = dp_share(mb, self.mesh)
            idx = (np.arange(g)[:, None] * mb
                   + np.arange(sl.start, sl.stop)).reshape(-1)
            inds, pos = inds[idx], pos[idx]
            measured = measured[torch.as_tensor(idx,
                                                device=measured.device)]
        f = self._dp_weight()
        batch = {'i_theta': i_theta, 'theta': theta, 'pos_batch': pos,
                 'ind_batch': inds}
        w_dev = torch.as_tensor(w, device=obj_rot.device)
        with torch.enable_grad():
            pred = self._predict(params, batch, cfg)
            if self.transform_measured is not None:
                measured = self.transform_measured(params, batch, measured,
                                                   cfg)
            per_item = model_base.mismatch_loss(
                pred, measured, cfg.loss.loss_function_type,
                cfg.loss.raw_data_type, cfg.loss.poisson_multiplier,
                self.beamstop_mask, per_item=True)
            per_batch = per_item.reshape(len(w), -1).mean(1) * f
            total = (per_batch * w_dev).sum()
            rv = 0.0
            if self.reg_list:
                rv = self._regularization(params['obj'])
                total = total + w_dev.sum() * rv * f
            grads = torch.autograd.grad(total, [params[k] for k in names],
                                        allow_unused=True)
        grads = [torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)]
        per_batch, *grads = self._dp_sum([per_batch.detach()] + grads)
        per_batch = per_batch + (rv.detach() if torch.is_tensor(rv) else rv)
        return per_batch, dict(zip(names, grads))

    @torch.no_grad()
    def step_band(self, i_theta: int, inds, measured) -> torch.Tensor:
        """One immediate update from one grid row of patterns: only the
        band of object rows ``[y0, y0 + py)`` that the row's windows cover
        is rotated, and its gradient is rotated back, the same linear
        chain autograd applies to the whole object (rotation acts on each
        y plane alone).  Band rows outside the object are vacuum going in
        and are dropped coming back.  The regularizers' gradient on the
        whole object adds by the sum rule.  Returns the batch's loss, on
        the device."""
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
        loss, g_sub, g_aux = self._patch_grads(sub, i_theta, theta, inds,
                                               measured, zm, 1)
        acc = torch.zeros((py, X + px0 + px1, nzb) + tuple(obj.shape[3:]),
                          dtype=torch.float32, device=obj.device)
        scatter_rowgrid_add_kernel(acc, g_sub, 0, int(x0s[0]),
                                   self._rowgrid_stride)
        g_band = _band_grad_back(acc, theta, cfg, px0, X, nz)
        if self.reg_list:
            rv, g_obj = self._reg_value_and_grad(obj)
            loss = loss + rv
        else:
            g_obj = torch.zeros_like(obj)
        g_obj[lo:hi] += g_band[lo - y0:hi - y0]
        self.apply_step({**g_aux, 'obj': g_obj}, self.i_opt_batch,
                        self.global_batch)
        self.i_opt_batch += 1
        return loss[0]

    def loss_fn(self, params, batch, measured):
        """The minibatch's loss: the data mismatch of the model's
        ``predict`` (against the measured data as the model's
        ``transform_measured`` registers them) plus the regularizers."""
        cfg = self._model_cfg
        pred = self._predict(params, batch, cfg)
        if self.transform_measured is not None:
            measured = self.transform_measured(params, batch, measured, cfg)
        loss = model_base.mismatch_loss(
            pred, measured, cfg.loss.loss_function_type,
            cfg.loss.raw_data_type, cfg.loss.poisson_multiplier,
            self.beamstop_mask)
        if self.mesh is not None:
            # This rank's share of the batch's loss (the sum over 'dp' is
            # the batch's).
            f = self._dp_weight()
            loss = loss * f
            if self.reg_list:
                loss = loss + self._regularization(params['obj']) * f
            return loss
        if self.reg_list:
            loss = loss + regs.total_regularization(
                self.reg_list, params['obj'], weight_l1=self.weight_l1)
        return loss

    def _grad_step(self, i_theta: int, inds, measured, obj=None):
        """The batch's loss (:meth:`loss_fn`) and its gradient in every
        refined leaf (and in the object under a second-order optimizer,
        whose spec it keeps itself), by autograd through the whole forward
        model (the object's rotation included where the model rotates).  ``obj``: the
        object to differentiate at in place of ``params['obj']`` (the
        object rotated out of the loop).  Returns ``(loss, {name:
        grad})``, on the device."""
        names = list(self.specs)
        if self.second_order:
            names.append('obj')
        params = {k: v.detach().requires_grad_(k in names)
                  for k, v in self.params.items()}
        if obj is not None:
            params['obj'] = obj.detach().requires_grad_('obj' in names)
        batch, measured = self._share(self._batch(i_theta, inds), measured)
        with torch.enable_grad():
            loss = self.loss_fn(params, batch, measured)
            grads = torch.autograd.grad(loss, [params[k] for k in names],
                                        allow_unused=True)
        grads = [torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)]
        loss, *grads = self._dp_sum([loss.detach()] + grads)
        return loss, dict(zip(names, grads))

    def _batch(self, i_theta: int, inds) -> Dict[str, Any]:
        """The model's batch dict for the spots ``inds`` of angle
        ``i_theta``."""
        return {'i_theta': i_theta, 'theta': float(self.theta_ls[i_theta]),
                'pos_batch': self._pos_table(i_theta)[inds].astype(
                    np.float32),
                'ind_batch': np.asarray(inds)}

    @torch.no_grad()
    def second_order_step(self, i_theta: int, inds,
                          measured) -> torch.Tensor:
        """One batch's update under CG or Curveball: the batch's loss and
        gradient in every leaf (:meth:`_grad_step`), the first-order update
        of the auxiliary leaves, then the object's second-order step at
        the old auxiliary values (CG on the full loss; Curveball's
        curvature on the data term against the measured data as the
        model's ``transform_measured`` registers them), then the
        constraints.  Returns the batch's loss, on the device."""
        cfg = self.cfg
        t = cfg.train
        loss, grads = self._grad_step(i_theta, inds, measured)
        params = self._first_order_update(grads, self.i_opt_batch,
                                          self.global_batch)
        if t.optimize_object:
            old = self.params
            # Under a mesh: this rank's dp share, losses and curvature
            # products summed over 'dp', the object's dot products over
            # 'op' (its slabs).
            batch, measured = self._share(self._batch(i_theta, inds),
                                          measured)
            state = (self._obj_state_up() if self._off_state
                     else self.opt_state['obj'])
            f = 1.0 if self.mesh is None else self._dp_weight()

            def dp_sum(x):
                return self._dp_sum([x])[0]

            psum = None
            if self._shard is not None:
                psum = self._shard.sum

            def loss_obj_fn(o):
                return dp_sum(self.loss_fn({**old, 'obj': o}, batch,
                                           measured))

            if t.optimizer == 'cg':
                obj, state, _ = so.cg_step(loss_obj_fn, old['obj'],
                                           grads['obj'], loss, state,
                                           psum=psum)
            else:
                mcfg = self._model_cfg
                meas = measured
                if self.transform_measured is not None:
                    meas = self.transform_measured(old, batch, measured,
                                                   mcfg)

                def pred_fn(o):
                    return self._predict({**old, 'obj': o}, batch, mcfg)

                def loss_pred_fn(pred):
                    return model_base.mismatch_loss(
                        pred, meas, cfg.loss.loss_function_type,
                        cfg.loss.raw_data_type, cfg.loss.poisson_multiplier,
                        self.beamstop_mask) * f

                obj, state, _ = so.curveball_step(
                    pred_fn, loss_pred_fn, loss_obj_fn, old['obj'], state,
                    reduce=dp_sum if self._dp_split else None, psum=psum)
            params['obj'] = obj
            self.opt_state['obj'] = (self._obj_state_down(state)
                                     if self._off_state else state)
        self._constrain(params)
        self.i_opt_batch += 1
        return loss

    def _apply_external_algorithm(self):
        """The external update, after an optimizer step: under 'ctf', the
        object's delta channel becomes the multi-distance CTF retrieval
        (:func:`.conventional.multidistance_ctf`) of the first view's
        holograms, one a distance; kappa from the refined ``ctf_lg_kappa``
        where there is one, the refined affines where there are."""
        if self.external_algorithm is None:
            return
        from .conventional import multidistance_ctf
        geo = self.cfg.geometry
        n_blocks = self.n_pos // geo.n_dists
        prj = self.stager().rows(0, np.arange(0, self.n_pos, n_blocks))
        kappa = (10.0 ** float(self.params['ctf_lg_kappa'][0])
                 if 'ctf_lg_kappa' in self.params
                 else self.cfg.train.ctf_kappa)
        phase = multidistance_ctf(
            prj, np.asarray(geo.free_prop_cm), geo.energy_ev, geo.psize_cm,
            kappa=kappa, prj_affine_ls=self.params.get('prj_affine_ls'),
            device=self.device)
        obj = self.params['obj'].clone()
        obj[..., 0] = self._own_rows(phase)[..., None]
        self.params['obj'] = obj

    @torch.no_grad()
    def accum_step(self, acc: Dict[str, Any], i_theta: int, inds, measured,
                   last_of_angle: bool) -> torch.Tensor:
        """One batch of the accumulate-then-update loop: its gradient adds
        into ``acc['grads']`` (the epoch's running state), and the sum is
        applied as one update at the angle's last batch ('per angle') or
        after ``n_batch_per_update`` batches ('immediate'; every batch at
        the default of 1, the generic immediate step).  With the
        rotation out of the loop the gradient is taken at the object
        rotated when the angle began (``acc['obj_rot']``, stale within the
        angle after an update), and only the object's sum is rotated back
        before the update.  Returns the batch's loss, on the device."""
        t = self.cfg.train
        theta = float(self.theta_ls[i_theta])
        obj_rot = None
        if self._rol:
            if acc.get('angle') != i_theta:
                acc['obj_rot'] = rotate(self.params['obj'], theta,
                                        method=t.interpolation)
                acc['angle'] = i_theta
            obj_rot = acc['obj_rot']
        loss, grads = self._grad_step(i_theta, inds, measured, obj_rot)
        if acc.get('grads') is None:
            acc['grads'], acc['n'] = grads, 0
        else:
            for k, g in grads.items():
                acc['grads'][k].add_(g)
        acc['n'] += 1
        if t.update_scheme == 'per angle':
            due = last_of_angle
        else:
            due = last_of_angle or acc['n'] >= t.n_batch_per_update
        if due:
            grads = acc.pop('grads')
            if self._rol and 'obj' in grads:
                # Back in the object's frame: the exact transpose of the
                # rotation, or the rotation by -theta (the reference's).
                g = grads['obj']
                grads['obj'] = (
                    rotate_adjoint(g, theta, method=t.interpolation)
                    if t.exact_grad_rotation
                    else rotate(g, -theta, method=t.interpolation))
            self.apply_step(grads, self.i_opt_batch, self.global_batch)
            self.i_opt_batch += 1
        return loss

    # -- epochs ------------------------------------------------------------
    def epoch_fused(self, batches, i_epoch: int = 0,
                    skip: int = 0) -> torch.Tensor:
        """An epoch of batch-by-batch steps from batch ``skip`` on: the
        immediate scheme's one update a minibatch through
        :meth:`step_band` where the scan table is grid rows (in 3D), else
        the accumulate-then-update loop (:meth:`accum_step`, which updates
        every batch unless the configuration accumulates).  The batches'
        rows of a device-resident dataset are gathered by one index table
        moved to the device once; a host-staged batch is staged while the
        batch before it computes.
        The reweighted-L1 weights refresh every :data:`WEIGHT_L1_INTERVAL`
        batches and the support shrinks every ``shrink_cycle``, both on
        the device.  Checkpoints fall on batches; one in the middle of an
        accumulation does not hold the partial sum, so a resume starts a
        new one (as the JAX package's does).  On a mesh whose immediate
        layout holds the epoch's rows (:func:`.recon_mesh.mc_imm_ok`),
        each batch is :func:`.recon_mesh.mc_imm_step`, fed from the
        layout's own tables.  Returns the per-batch losses, on the
        device."""
        t = self.cfg.train
        n_b = len(batches)
        mesh_rows = mc_lib.mc_imm_ok(self, batches)
        feed = data = None
        if not mesh_rows:
            rows = [inds if self.expand_indices is None
                    else self.expand_indices(inds, self.n_pos, self.cfg)
                    for _, inds in batches]
            stager = self.stager()
            if stager.resident:
                inds_dev = torch.as_tensor(np.stack(rows),
                                           device=self.device)
                data = stager.dataset()
            else:
                feed = stager.feed([(b[0], r) for b, r in zip(batches,
                                                              rows)])
        acc: Dict[str, Any] = {}
        losses = []
        for i_batch in range(skip, n_b):
            i_theta, inds = batches[i_batch]
            if self._needs_weight_l1 and i_batch % WEIGHT_L1_INTERVAL == 0:
                self.weight_l1 = self._weight_l1_refresh(self.params['obj'],
                                                        self._shard)
            if mesh_rows:
                measured = None
            elif feed is None:
                measured = data[i_theta][inds_dev[i_batch]]
            else:
                measured = feed.take(i_batch)
            if mesh_rows:
                with _prof.span('mesh_step'):
                    losses.append(mc_lib.mc_imm_step(
                        self, i_theta, int(inds[0]) // self._mci['mb']))
            elif self._band:
                with _prof.span('step_band'):
                    losses.append(self.step_band(i_theta, inds, measured))
            elif self.second_order:
                with _prof.span('second_order_step'):
                    losses.append(self.second_order_step(i_theta, inds,
                                                         measured))
            else:
                last = i_batch + 1 == n_b or batches[i_batch + 1][0] != i_theta
                with _prof.span('accum_step'):
                    losses.append(self.accum_step(acc, i_theta, inds,
                                                  measured, last))
            if feed is not None:
                feed.ahead(i_batch + 1)
            if not self._accum:
                # After every update of the immediate steps (not the
                # accumulate loop's), as the JAX package's generic step.
                self._apply_external_algorithm()
            self.global_batch += 1
            if (self.finite_support_mask is not None
                    and t.shrink_cycle is not None and i_batch > 0
                    and i_batch % t.shrink_cycle == 0):
                self._shrink()
            nxt = ((i_epoch + 1, 0) if i_batch + 1 == n_b
                   else (i_epoch, i_batch + 1))
            every = self.cfg.io.n_batch_per_checkpoint
            self._host_visits(i_epoch, i_batch, nxt,
                              (i_batch + 1) % every == 0)
            if self.stop_requested:
                break
        return torch.stack(losses)

    def angles_epoch(self, batches, i_epoch: int = 0, skip: int = 0):
        """A per-angle epoch: one :meth:`angle_step` an angle, skipping the
        whole leading angles of the first ``skip`` batches (a resume;
        checkpoints fall on angle boundaries).  Per angle, before the
        step, the reweighted-L1 weights refresh; after it, the support
        shrinks when the epoch's batch count crossed a multiple of
        ``shrink_cycle``; the next angle's rows are requested once the
        step is queued, so a host-staged angle moves while the one before
        it computes.  On a mesh with a per-angle layout each angle is
        :func:`.recon_mesh.mc_angle_step`, fed from the layout's own
        tables.  Returns ``(losses on the device, the index of the first
        batch run)``."""
        t = self.cfg.train
        groups = self._group_batches(batches)
        n_b_epoch = len(batches)
        done = 0
        while groups and done + len(groups[0][1]) <= skip:
            done += len(groups.pop(0)[1])
        first = done
        losses = []
        mesh_rows = self._mc is not None
        stager = None if mesh_rows else self.stager()
        with _prof.span('stage'):
            nxt_rows = (self._angle_rows(*groups[0])
                        if groups and not mesh_rows else None)
        for j, (i_theta, inds_list) in enumerate(groups):
            with _prof.span('angle'):
                if self._needs_weight_l1:
                    with _prof.span('reg'):
                        self.weight_l1 = self._weight_l1_refresh(
                            self._obj_up(), self._shard)
                if mesh_rows:
                    with _prof.span('mesh_step'):
                        losses.append(mc_lib.mc_angle_step(self, i_theta,
                                                           len(inds_list)))
                else:
                    with _prof.span('stage'):
                        measured = stager.take(nxt_rows)
                    losses.append(self.angle_step(i_theta, inds_list,
                                                  measured))
                    del measured
                    if j + 1 < len(groups):
                        with _prof.span('stage'):
                            nxt_rows = self._angle_rows(*groups[j + 1])
                self._apply_external_algorithm()
                prev, done = done, done + len(inds_list)
                if (self.finite_support_mask is not None
                        and t.shrink_cycle is not None
                        and done // t.shrink_cycle > prev // t.shrink_cycle):
                    self._shrink()
                nxt = ((i_epoch + 1, 0) if done == n_b_epoch
                       else (i_epoch, done))
                every = max(1, self.cfg.io.n_batch_per_checkpoint
                            // max(1, len(inds_list)))
                self._host_visits(i_epoch, done - 1, nxt,
                                  self.i_opt_batch % every == 0)
            if self.stop_requested:
                break
        return torch.cat(losses), first

    def _host_visits(self, i_epoch: int, i_batch: int, nxt, ckpt_due: bool):
        """After a batch (or an angle): the batch-level intermediate dump,
        the checkpoint when ``ckpt_due`` (at ``nxt``, the NEXT (epoch,
        batch) to run), and the ``t_max_min`` wall-time stop, which
        checkpoints first.  Without an output folder only the stop
        applies."""
        io = self.cfg.io
        if self.output_folder is not None:
            if io.save_intermediate and io.save_intermediate_level == 'batch':
                self._save_intermediate(i_epoch, i_batch)
            if io.store_checkpoint and ckpt_due:
                self.save_checkpoint(*nxt)
        over = (io.t_max_min is not None
                and (time.time() - self._t_start) / 60 > io.t_max_min)
        if io.t_max_min is not None and self.mesh is not None:
            # Every rank stops at the same batch.
            over = self.mesh.comm.any(over)
        if over:
            if self.output_folder is not None:
                self.save_checkpoint(*nxt)
            self.stop_requested = True

    def run_epoch(self, i_epoch: int,
                  rng: Optional[np.random.Generator] = None,
                  callback=None) -> float:
        """One epoch over every angle; returns the mean per-batch loss,
        the same number the JAX package's ``run_epoch`` returns.  The
        first epoch after a resume skips the batches the checkpoint had
        finished.  ``callback(i_epoch, i_batch, loss)`` and the loss log
        see each batch once the epoch's losses reach the host."""
        return self._epoch_finish(self._epoch_dispatch(i_epoch, rng),
                                  callback)

    def _epoch_dispatch(self, i_epoch: int,
                        rng: Optional[np.random.Generator] = None):
        """Queue one epoch's steps; returns what :meth:`_epoch_finish`
        needs, the losses still on the device."""
        if rng is None:
            rng = np.random.default_rng(self.cfg.train.seed + i_epoch)
        batches = self.make_batches(rng)
        skip = 0
        if i_epoch == self._start_epoch and self._start_batch:
            skip = min(self._start_batch, len(batches))
            self._start_batch = 0
        t0 = time.perf_counter()
        with _prof.span('epoch', label=i_epoch) as sp:
            if self._angles:
                losses, first = self.angles_epoch(batches, i_epoch, skip)
            else:
                losses, first = self.epoch_fused(batches, i_epoch, skip), skip
        traced = None if sp is None else sp.epoch
        return i_epoch, losses, first, time.perf_counter() - t0, traced

    def _epoch_finish(self, pending, callback=None) -> float:
        """Fetch a dispatched epoch's losses (the epoch's one blocking
        copy), log them and return their mean.  The verbose line's rate
        is over the host wall of the epoch's dispatch and of its fetch;
        an epoch traced (:mod:`.utils.profiling`) adds its spans an
        angle."""
        i_epoch, losses, first, wall, traced = pending
        t0 = time.perf_counter()
        with _prof.span('epoch.fetch', traced):
            losses = losses.double().cpu().numpy()
        wall += time.perf_counter() - t0
        if callback is not None or self._logger is not None:
            for b, loss in enumerate(losses, start=first):
                if callback is not None:
                    callback(i_epoch, b, float(loss))
                if self._logger is not None:
                    self._logger.log(i_epoch, b, float(loss))
        mean_loss = float(np.mean(losses))
        self.loss_history.append(mean_loss)
        if self.verbose and self._writer:
            n_patterns = len(losses) * self.cfg.train.minibatch_size
            mem = _prof.device_memory_stats(self.device)
            mem_s = (f"; device memory {mem['bytes_in_use_mb']:.0f}/"
                     f"{mem['peak_bytes_mb']:.0f} MB peak" if mem else '')
            spans_s = ('' if traced is None
                       else f'; {_prof.REGISTRY.summary(traced)}')
            self._print(f'[epoch {i_epoch}] loss={mean_loss:.4e} '
                        f'{n_patterns / max(wall, 1e-9):.1f} patterns/s'
                        f'{spans_s}{mem_s}')
        return mean_loss

    def run_epochs(self, n_epochs: int, start_epoch: Optional[int] = None,
                   callback=None) -> List[float]:
        """``n_epochs`` epochs from ``start_epoch`` (a restored
        checkpoint's epoch by default), each as :meth:`run_epoch` would run
        it, with epoch ``r + 1`` queued before epoch ``r``'s losses are
        fetched, so the fetch's wait overlaps the next epoch's work.  A
        callback, checkpoints, intermediate dumps or ``t_max_min`` read
        the run's state between epochs, and then every epoch is fetched
        before the next starts.  Returns the mean loss of each epoch."""
        if start_epoch is None:
            start_epoch = self._start_epoch
        io = self.cfg.io
        pipeline = callback is None and (
            self.output_folder is None
            or not (io.store_checkpoint or io.save_intermediate
                    or io.t_max_min is not None))
        out: List[float] = []
        pending = None
        for i_epoch in range(start_epoch, start_epoch + n_epochs):
            if self.stop_requested:
                break
            if not pipeline:
                out.append(self.run_epoch(i_epoch, callback=callback))
                continue
            nxt = self._epoch_dispatch(i_epoch)
            if pending is not None:
                out.append(self._epoch_finish(pending))
            pending = nxt
        if pending is not None:
            out.append(self._epoch_finish(pending))
        return out

    def run(self, n_epochs: Optional[int] = None,
            callback=None) -> Dict[str, Any]:
        """Run the epochs, from a restored checkpoint's position where
        there is one, and return :meth:`results`.  ``n_epochs='auto'`` in
        the config runs up to ``max_nepochs`` and stops once an epoch's
        loss fell by less than ``crit_conv_rate`` of the last.  With an
        output folder: the epoch-level intermediate dumps, then the final
        object and probe TIFFs and the final checkpoint at the next
        epoch."""
        t = self.cfg.train
        io = self.cfg.io
        if n_epochs is None:
            n_epochs = (t.max_nepochs if t.n_epochs == 'auto'
                        else int(t.n_epochs))
        auto = t.n_epochs == 'auto'
        rng = np.random.default_rng(t.seed)
        # A resumed run replays the skipped epochs' draws, so each epoch's
        # shuffle is the uninterrupted run's.
        for _ in range(self._start_epoch):
            self.make_batches(rng)
        i_epoch = self._start_epoch - 1
        for i_epoch in range(self._start_epoch, n_epochs):
            t0 = time.perf_counter()
            loss = self.run_epoch(i_epoch, rng, callback=callback)
            self.epoch_seconds.append(time.perf_counter() - t0)
            if (self.output_folder is not None and io.save_intermediate
                    and io.save_intermediate_level != 'batch'):
                self._save_intermediate(i_epoch, -1)
            if self.stop_requested:
                break
            if auto and len(self.loss_history) >= 2:
                prev = self.loss_history[-2]
                if prev > 0 and (prev - loss) / abs(prev) < t.crit_conv_rate:
                    break
        if self.output_folder is not None:
            obj = self.obj
            if self._writer:
                out_lib.output_object(obj, self.output_folder,
                                      t.unknown_type)
                out_lib.output_probe(self.params['probe'].cpu().numpy(),
                                     self.output_folder)
            if io.store_checkpoint and not self.stop_requested:
                self.save_checkpoint(i_epoch + 1, 0)
        return self.results()

    # -- outputs -----------------------------------------------------------
    def _print(self, msg: str):
        print(msg, flush=True)
        if self._stdout_f is not None:
            self._stdout_f.write(f'[{time.strftime("%H:%M:%S")}] {msg}\n')
            self._stdout_f.flush()

    def _save_intermediate(self, i_epoch: int, i_batch: int):
        """Intermediate object and probe TIFFs under ``intermediate/``:
        with ``save_history`` each dump keeps an ``_{epoch}`` or
        ``_{epoch}_{batch}`` suffix, else the same files are
        overwritten."""
        inter = os.path.join(self.output_folder, 'intermediate')
        if not self.cfg.io.save_history:
            suffix = ''
        elif i_batch < 0:   # epoch-level dump
            suffix = f'_{i_epoch}'
        else:
            suffix = f'_{i_epoch}_{i_batch}'
        obj = self.obj
        if not self._writer:
            return
        out_lib.output_object(obj, inter, self.cfg.train.unknown_type,
                              name_suffix=suffix)
        out_lib.output_probe(self.params['probe'].cpu().numpy(), inter,
                             name_suffix=suffix)
        out_lib.output_refined_params(
            {k: v.detach().cpu().numpy() for k, v in self.params.items()
             if k != 'obj'}, list(self.specs), inter, i_epoch, i_batch)

    def save_checkpoint(self, i_epoch: int, i_batch: int) -> str:
        """Write a checkpoint naming ``(i_epoch, i_batch)``, the NEXT batch
        to run: the parameters, the optimizer state, the step counts and,
        under shrink-wrap, the support mask, once the offloaded slabs'
        copies down are done; every rank of a mesh calls it.  The npz form
        (``checkpoint/checkpoint.npz``) holds offloaded y slabs as slabs
        (``params/obj/s00``, ``state/obj/m/s00``, ..., the JAX package's
        keys) and, under a mesh, the object gathered from the ranks'
        slabs, written by rank 0.  Under ``use_orbax`` the sharded form
        (``checkpoint/dcp/``, :meth:`_save_sharded`) gathers nothing.
        Once checkpoints have taken more than half of the run's wall time
        (and a minute), a warning says so."""
        t0 = time.time()
        self._mover.sync()
        path = os.path.join(self.output_folder, 'checkpoint')
        if self.cfg.io.use_orbax:
            path = self._save_sharded(path, i_epoch, i_batch)
        else:
            path = self._save_npz(path, i_epoch, i_batch)
        self._ckpt_seconds += time.time() - t0
        self._ckpt_count += 1
        if (not self._ckpt_warned and self._ckpt_seconds > 60
                and self._ckpt_seconds > 0.5 * (time.time() - self._t_start)):
            warnings.warn(
                'checkpointing has taken more than half the wall time '
                f'({self._ckpt_seconds:.0f} s): raise n_batch_per_checkpoint '
                'or set store_checkpoint=False (each checkpoint moves the '
                'parameters and the optimizer state to the host)')
            self._ckpt_warned = True
        return path

    def _ckpt_extra(self):
        """The counters every checkpoint holds under ``extra``."""
        return {'i_opt_batch': np.asarray(self.i_opt_batch),
                'global_batch': np.asarray(self.global_batch)}

    def _save_npz(self, path: str, i_epoch: int, i_batch: int) -> str:
        p_all, st_all = self.params, self.opt_state
        mask = self.finite_support_mask
        if self.mesh is not None and self.mesh.n_op > 1:
            # The whole object, its state and its support from the slabs;
            # rank 0 writes them under a single device's keys.
            slab_shape = tuple(self.params['obj'].shape)
            p_all = {**p_all, 'obj': self._gather_rows(p_all['obj'])}
            if 'obj' in st_all:
                st_all = {**st_all, 'obj': {
                    n: (self._gather_rows(a) if tuple(a.shape) == slab_shape
                        else a) for n, a in st_all['obj'].items()}}
            if mask is not None:
                mask = self._gather_rows(mask)
        if not self._writer:
            return path
        params, state = convert.params_to_numpy(p_all, st_all)
        extra = self._ckpt_extra()
        if mask is not None and self.cfg.train.shrink_cycle is not None:
            extra['finite_support_mask'] = mask.cpu().numpy()
        out = ckpt_lib.save_checkpoint(path, params, state, i_epoch,
                                       i_batch, extra=extra)
        # A sharded form left by an earlier run with use_orbax is read
        # first on restore: it would shadow this newer checkpoint.
        ckpt_lib.drop_sharded(path)
        return out

    def _save_sharded(self, path: str, i_epoch: int, i_batch: int) -> str:
        """The sharded form: each rank of dp = 0 writes its rows of the
        object, of its object-shaped state and of the support mask in
        ``offload_slabs`` y slabs (an offloaded object's own slabs, from
        their host blocks; 'dp' holds replicas, of which one is written),
        rank 0 the other leaves, the counters and the slab table; nothing
        is gathered."""
        mesh = self.mesh
        n_op, op = (1, 0) if mesh is None else (mesh.n_op, mesh.op)
        table, mine = off_lib.checkpoint_slabs(
            self.cfg.geometry.obj_size[0], n_op, op,
            self.cfg.parallel.offload_slabs)
        obj = self.params['obj']
        own = None if isinstance(obj, dict) else tuple(obj.shape)

        def slabbed(k, a):
            return k == 'obj' and (isinstance(a, dict)
                                   or tuple(a.shape) == own)
        items = {}
        if mesh is None or mesh.dp == 0:
            leaves = {'params/obj': obj}
            leaves.update({f'state/obj/{n}': a for n, a in
                           self.opt_state.get('obj', {}).items()
                           if slabbed('obj', a)})
            if (self.finite_support_mask is not None
                    and self.cfg.train.shrink_cycle is not None):
                leaves['extra/finite_support_mask'] = self.finite_support_mask
            for name, v in leaves.items():
                for key, a in off_lib.slabs_of(v, mine).items():
                    items[f'{name}/{key}'] = a
        extra = None
        if self._writer:
            items.update({f'params/{k}': v for k, v in self.params.items()
                          if k != 'obj'})
            items.update({f'state/{k}/{n}': a
                          for k, st in self.opt_state.items()
                          for n, a in st.items() if not slabbed(k, a)})
            extra = {**self._ckpt_extra(), 'obj_slab_rows': table}
        return ckpt_lib.save_sharded(path, items, i_epoch, i_batch,
                                     extra=extra,
                                     comm=None if mesh is None else mesh.comm)

    def results(self) -> Dict[str, Any]:
        """The parameters as numpy arrays (the object whole; under a mesh
        every rank calls it) and the per-epoch loss history."""
        out = {k: self.obj if k == 'obj' else v.detach().cpu().numpy()
               for k, v in self.params.items()}
        out['loss_history'] = np.asarray(self.loss_history)
        return out

    @property
    def obj(self) -> np.ndarray:
        """The object ``[y, x, z, 2]`` as a host array (an offloaded one
        joined from its slabs once their copies down are done; under a
        mesh gathered from the ranks' slabs, so every rank calls it)."""
        obj = self.params['obj']
        if isinstance(obj, dict):
            self._mover.sync()
            return np.concatenate([obj[k].numpy() for k in self._slab_keys])
        self._mover.sync()
        return self._gather_rows(obj.detach()).cpu().numpy()

    @property
    def probe(self) -> np.ndarray:
        """The probe as a complex host array ``[n_modes, py, px]``."""
        p = self.params['probe'].detach().cpu().numpy()
        return p[..., 0] + 1j * p[..., 1]
