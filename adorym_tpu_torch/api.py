"""The reference's entry point, ``reconstruct_ptychography(**params)``
(``adorym_tpu/api.py``): the reference's keyword surface mapped onto the
typed config and :class:`~adorym_tpu_torch.recon.Reconstructor`, so a
user of the reference can point a demo's params dict at the port.

The port's own keywords: ``device`` (CUDA unless ``'cpu'`` is passed) and
``dataset``, a :class:`~adorym_tpu_torch.io.data.RawDataset`-like object
read instead of the file (an ``ArrayDataset`` where ``h5py`` is missing).

Multi-distance data (a ``free_prop_cm`` of several distances) pick the
multi-distance model under ``forward_model='auto'``; a model module may
also be passed.  The refined leaves come back in the results dict beside
the object and the probe (``results['probe_pos_correction']``,
``results['free_prop_cm']``, ...).  ``distribution_mode`` follows the JAX
package: ``'distributed_object'`` is the object split over a mesh's
object axis (``parallel_object_axis > 1``; without one it warns and runs
unsharded), an unknown mode warns and is ignored.

``parallel_data_axis`` and ``parallel_object_axis`` run the call on a
device mesh (:mod:`.parallel`): every rank of a ``torch.distributed``
process group of ``data_axis * object_axis`` ranks calls
``reconstruct_ptychography`` with the same parameters (``torchrun
--nproc-per-node=N``, or :func:`.parallel.bootstrap.initialize_distributed`
first); rank 0 writes the outputs.  Without a process group it raises.

The model families and refinables of the reference map as the JAX
package maps them: ``slice_pos_cm_ls`` (sparse multislice, refined with
``optimize_slice_pos``), ``pure_projection`` and ``is_minus_logged``,
``forward_algorithm='ctf'`` with ``ctf_lg_kappa`` (refined with
``optimize_ctf_lg_kappa``, starting at the given value), and
``initial_tilt`` (known tilts, ``tilt_ls`` as given) or ``optimize_tilt``.

``use_epie=True`` runs ePIE (:func:`.conventional.epie_reconstruct`) on
the first view's data with the first probe mode and returns its object
and probe; ``update_using_external_algorithm='ctf'`` replaces the
object's delta channel with the multi-distance CTF retrieval after each
update; ``optimizer='cg'`` or ``'curveball'`` drives the object with a
second-order optimizer (:mod:`.optim.second_order`);
``distribution_mode='shared_file'`` keeps the object's optimizer state on
the host and, past the device's budget where the run qualifies, the
object too (``offload_optimizer_state=True``, ``offload_object='auto'``).

``use_orbax=True`` writes the sharded checkpoint form (``checkpoint/dcp/``
through ``torch.distributed.checkpoint``, each rank its own slab, nothing
gathered) in place of the npz form, and a resume reads either form; a JAX
orbax folder raises, naming its converter (``tools/orbax_to_npz.py``).

Not ported, raising ``NotImplementedError`` that names its ROADMAP item:
model families passed by name (``forward_model`` other than ``'auto'`` or
a module).  Reference keywords that have no meaning here are ignored;
unknown ones warn.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Dict

import numpy as np

from .config import (Geometry, IOConfig, LossConfig, ParallelConfig,
                     ReconConfig, RefineConfig, TrainConfig)
from .constants import PI
from .models import regularizers as regs_mod
from .recon import Reconstructor

_IGNORED = {
    # Backend and device selection and the reference's MPI / HDF5
    # plumbing: one implementation, no lookup tables or caches.
    'backend', 'cpu_only', 'gpu_index', 'xpu', 'core_parallelization',
    'precalculate_rotation_coords', 'cache_dtype', 'n_split_mpi_ata',
    'dist_mode_n_batch_per_update',
    # Read nowhere in the reference's body.
    'dynamic_dropping', 'dropping_threshold', 'fourier_disparity', 'debug',
    'probe_circ_mask', 'n_epoch_final_pass', 'fix_object', 'dynamic_rate',
    # The step counter advances once an update (the reference's 'batch'
    # under immediate updates, 'angle' under per-angle ones).
    'optimizer_batch_number_increment',
    'n_dp_batch', 'run_float64',
}

#: Keywords the probe initialization reads.
_PROBE_KWARGS = {'probe_mag_sigma', 'probe_phase_sigma', 'probe_phase_max',
                 'probe_mag_max', 'aperture_radius', 'beamstop_radius',
                 'probe_defocus_cm'}

_A5 = 'ROADMAP A.5, remaining model families and refinables'


def _optimizer_kind(value, kwarg_name):
    """A reference per-parameter optimizer (an object or a kind string)
    as an ``OptSpec`` kind."""
    if value is None:
        return 'adam'
    if isinstance(value, str):
        return value.lower()
    name = type(value).__name__.lower().replace('optimizer', '')
    if name in ('adam', 'gd', 'momentum'):
        return name
    warnings.warn(f'{kwarg_name}: cannot map {type(value).__name__} onto a '
                  f'first-order kind; using adam')
    return 'adam'


def _regularizers(regularizers, unknown_type):
    """The port's regularizers for a list of the port's, the JAX
    package's or the reference's (matched by class name and their
    ``alpha_d`` / ``alpha_b`` / ``gamma``)."""
    out = []
    for r in regularizers:
        if isinstance(r, regs_mod.Regularizer):
            out.append(r)
            continue
        name = type(r).__name__
        ours = getattr(regs_mod, name, None)
        if ours is None:
            warnings.warn(f'unknown regularizer {name!r} ignored')
            continue
        kw = {f: getattr(r, f) for f in ('alpha_d', 'alpha_b', 'gamma')
              if hasattr(r, f)}
        out.append(ours(getattr(r, 'unknown_type', unknown_type), **kw))
    return out


def reconstruct_ptychography(
        fname, obj_size, probe_pos=None, theta_st=0.0, theta_end=PI,
        n_theta=None, theta_downsample=None, energy_ev=None, psize_cm=None,
        free_prop_cm=None, raw_data_type='magnitude', is_minus_logged=False,
        slice_pos_cm_ls=None,
        n_epochs='auto', crit_conv_rate=0.03, max_nepochs=200,
        regularizers=None, alpha_d=None, alpha_b=None, gamma=1e-6,
        minibatch_size=None, multiscale_level=1, initial_guess=None,
        random_guess_means_sigmas=(8.7e-7, 5.1e-8, 1e-7, 1e-8),
        n_batch_per_update=1, reweighted_l1=False,
        update_scheme='immediate', unknown_type='delta_beta',
        optimize_object=True, optimizer='adam', learning_rate=1e-5,
        finite_support_mask_path=None, shrink_cycle=None,
        shrink_threshold=1e-9, object_type='normal', non_negativity=False,
        forward_model='auto', forward_algorithm='fresnel', ctf_lg_kappa=1.7,
        binning=1, fresnel_approx=True, pure_projection=False,
        two_d_mode=False, probe_type='gaussian', probe_initial=None,
        probe_extra_defocus_cm=None, n_probe_modes=1,
        rescale_probe_intensity=False, loss_function_type='lsq',
        poisson_multiplier=1.0, beamstop=None, normalize_fft=False,
        safe_zone_width=0, scale_ri_by_k=True, sign_convention=1,
        save_path='.', output_folder=None, save_intermediate=False,
        store_checkpoint=True, use_checkpoint=True,
        force_to_use_checkpoint=False, n_batch_per_checkpoint=10,
        rotate_out_of_loop=False,
        optimize_probe=False, probe_learning_rate=1e-5, optimizer_probe=None,
        probe_update_delay=0, probe_update_limit=None,
        optimize_probe_defocusing=False, probe_defocusing_learning_rate=1e-5,
        optimizer_probe_defocusing=None,
        optimize_probe_pos_offset=False, probe_pos_offset_learning_rate=1e-2,
        optimizer_probe_pos_offset=None,
        optimize_prj_pos_offset=False, prj_pos_offset_learning_rate=1e-2,
        optimizer_prj_pos_offset=None,
        optimize_all_probe_pos=False, all_probe_pos_learning_rate=1e-2,
        optimizer_all_probe_pos=None,
        optimize_slice_pos=False, slice_pos_learning_rate=1e-4,
        optimizer_slice_pos=None,
        optimize_free_prop=False, free_prop_learning_rate=1e-2,
        optimizer_free_prop=None,
        optimize_prj_affine=False, prj_affine_learning_rate=1e-3,
        optimizer_prj_affine=None,
        optimize_tilt=False, tilt_learning_rate=1e-3, optimizer_tilt=None,
        initial_tilt=None,
        optimize_ctf_lg_kappa=False, ctf_lg_kappa_learning_rate=1e-3,
        optimizer_ctf_lg_kappa=None,
        other_params_update_delay=0,
        randomize_probe_pos=False,
        save_intermediate_level='batch', save_history=False,
        common_probe_pos=True, shared_probe_among_angles=True,
        update_using_external_algorithm=None,
        use_epie=False, epie_alpha=0.8, pupil_function=None,
        t_max_min=None, run_bfloat16=False, save_stdout=False,
        distribution_mode=None,
        parallel_data_axis=1, parallel_object_axis=1, use_orbax=False,
        device=None, dataset=None, **kwargs) -> Dict[str, Any]:
    """Run a reconstruction from a reference-layout HDF5 file (or from
    ``dataset``) and return the results: the parameters and the per-epoch
    loss history."""
    interpolation = kwargs.pop('interpolation', 'bilinear')
    if interpolation not in ('bilinear', 'nearest'):
        raise ValueError(f'unknown interpolation {interpolation!r}')
    for k in kwargs:
        if k not in _IGNORED and k not in _PROBE_KWARGS:
            warnings.warn(f'reconstruct_ptychography: ignoring unsupported '
                          f'kwarg {k!r}')
    if isinstance(forward_model, str) and forward_model != 'auto':
        raise NotImplementedError(
            f'forward_model={forward_model!r}: pass \'auto\' or a model '
            f'module (other model families: {_A5})')
    # distribution_mode='shared_file' keeps the object's optimizer state
    # on the host, and the object too where it outgrows the device and the
    # run qualifies ('auto'), as the JAX package maps it.
    shared_file = distribution_mode == 'shared_file'
    if distribution_mode == 'distributed_object':
        if parallel_object_axis <= 1:
            warnings.warn("distribution_mode='distributed_object' maps "
                          'onto object sharding over a mesh: pass '
                          'parallel_object_axis>1 (z-slab analog) — '
                          'running unsharded')
    elif distribution_mode not in (None, 'shared_file'):
        warnings.warn(f'unknown distribution_mode {distribution_mode!r} '
                      'ignored')

    if dataset is None:
        from .io.data import RawDataset
        dataset = RawDataset(os.path.join(save_path, fname))
    ds = dataset
    data = ds.all_magnitudes()
    energy_ev = ds.energy_ev(energy_ev)
    psize_cm = ds.psize_cm(psize_cm)
    if free_prop_cm is None:
        free_prop_cm = ds.free_prop_cm(None)
    theta_ls = ds.theta_ls(theta_st, theta_end)
    if obj_size[-1] == 1:
        two_d_mode = True
    # The original angle indices that survive the selection, for the
    # per-angle metadata.
    theta_idx = np.arange(len(theta_ls))
    if two_d_mode:
        theta_idx = theta_idx[:1]
    if theta_downsample:
        theta_idx = theta_idx[::theta_downsample]
    if n_theta is not None and not two_d_mode:
        theta_idx = theta_idx[:n_theta]
    theta_ls = theta_ls[theta_idx]
    data = data[theta_idx]

    if not common_probe_pos:
        # Per-angle scan tables, ragged counts padded by repeating the
        # last position.
        per_angle = [ds.probe_pos_per_angle(int(i)) for i in theta_idx]
        n_max = max(len(p) for p in per_angle)
        probe_pos = np.stack([
            np.concatenate([p, np.repeat(p[-1:], n_max - len(p), axis=0)])
            for p in per_angle])
    elif probe_pos is None:
        probe_pos = ds.probe_pos()
    if probe_pos is None:
        probe_pos = np.array([[0.0, 0.0]])
    probe_pos = np.asarray(probe_pos, dtype=np.float64)

    fp = free_prop_cm
    is_multi_dist = (fp is not None and not isinstance(fp, str)
                     and np.size(fp) > 1)
    n_dists = int(np.size(fp)) if is_multi_dist else 1
    if fp is None or isinstance(fp, str):
        fp_cfg = fp
    elif np.size(fp) == 1:
        fp_cfg = float(np.ravel(fp)[0])
    else:
        fp_cfg = tuple(float(x) for x in np.ravel(fp))
    # A multi-distance probe is the full field.
    probe_size = (tuple(obj_size[:2]) if is_multi_dist
                  else tuple(data.shape[-2:]))

    reg_list = (None if regularizers is None
                else _regularizers(regularizers, unknown_type))
    geometry = Geometry(
        obj_size=tuple(obj_size), probe_size=probe_size,
        energy_ev=energy_ev, psize_cm=psize_cm, free_prop_cm=fp_cfg,
        binning=binning, fresnel_approx=fresnel_approx,
        sign_convention=sign_convention, two_d_mode=two_d_mode,
        pure_projection=pure_projection, is_minus_logged=is_minus_logged,
        scale_ri_by_k=scale_ri_by_k,
        slice_pos_cm_ls=(tuple(slice_pos_cm_ls)
                         if slice_pos_cm_ls is not None
                         and np.size(slice_pos_cm_ls) > 1 else None),
        n_dists=n_dists,
        safe_zone_width=safe_zone_width if safe_zone_width else (
            None if is_multi_dist else 0))
    loss_cfg = LossConfig(
        loss_function_type=loss_function_type, raw_data_type=raw_data_type,
        poisson_multiplier=poisson_multiplier, normalize_fft=normalize_fft,
        alpha_d=alpha_d or 0.0, alpha_b=alpha_b or 0.0, gamma=gamma or 0.0,
        reweighted_l1=reweighted_l1)

    kind = _optimizer_kind
    refine = RefineConfig(
        optimize_probe=optimize_probe, probe_learning_rate=probe_learning_rate,
        probe_optimizer=kind(optimizer_probe, 'optimizer_probe'),
        probe_update_delay=probe_update_delay,
        probe_update_limit=probe_update_limit,
        optimize_probe_defocusing=optimize_probe_defocusing,
        probe_defocusing_learning_rate=probe_defocusing_learning_rate,
        probe_defocusing_optimizer=kind(optimizer_probe_defocusing,
                                        'optimizer_probe_defocusing'),
        optimize_probe_pos_offset=optimize_probe_pos_offset,
        probe_pos_offset_learning_rate=probe_pos_offset_learning_rate,
        probe_pos_offset_optimizer=kind(optimizer_probe_pos_offset,
                                        'optimizer_probe_pos_offset'),
        optimize_prj_pos_offset=optimize_prj_pos_offset,
        prj_pos_offset_learning_rate=prj_pos_offset_learning_rate,
        prj_pos_offset_optimizer=kind(optimizer_prj_pos_offset,
                                      'optimizer_prj_pos_offset'),
        optimize_all_probe_pos=optimize_all_probe_pos,
        all_probe_pos_learning_rate=all_probe_pos_learning_rate,
        all_probe_pos_optimizer=kind(optimizer_all_probe_pos,
                                     'optimizer_all_probe_pos'),
        optimize_slice_pos=optimize_slice_pos,
        slice_pos_learning_rate=slice_pos_learning_rate,
        slice_pos_optimizer=kind(optimizer_slice_pos, 'optimizer_slice_pos'),
        optimize_free_prop=optimize_free_prop,
        free_prop_learning_rate=free_prop_learning_rate,
        free_prop_optimizer=kind(optimizer_free_prop, 'optimizer_free_prop'),
        optimize_tilt=optimize_tilt, tilt_learning_rate=tilt_learning_rate,
        tilt_optimizer=kind(optimizer_tilt, 'optimizer_tilt'),
        fixed_tilt=initial_tilt is not None,
        optimize_prj_affine=optimize_prj_affine,
        prj_affine_learning_rate=prj_affine_learning_rate,
        prj_affine_optimizer=kind(optimizer_prj_affine,
                                  'optimizer_prj_affine'),
        optimize_ctf_lg_kappa=optimize_ctf_lg_kappa,
        ctf_lg_kappa_learning_rate=ctf_lg_kappa_learning_rate,
        ctf_lg_kappa_optimizer=kind(optimizer_ctf_lg_kappa,
                                    'optimizer_ctf_lg_kappa'),
        other_params_update_delay=other_params_update_delay)
    train = TrainConfig(
        n_epochs=n_epochs, crit_conv_rate=crit_conv_rate,
        max_nepochs=max_nepochs,
        minibatch_size=minibatch_size or len(probe_pos),
        learning_rate=learning_rate, optimizer=optimizer,
        optimize_object=optimize_object, update_scheme=update_scheme,
        unknown_type=unknown_type, object_type=object_type,
        non_negativity=non_negativity, shrink_cycle=shrink_cycle,
        shrink_threshold=shrink_threshold,
        randomize_probe_pos=randomize_probe_pos,
        multiscale_level=multiscale_level,
        theta_downsample=theta_downsample,
        n_batch_per_update=n_batch_per_update,
        rotate_out_of_loop=rotate_out_of_loop,
        interpolation=interpolation, n_probe_modes=n_probe_modes,
        forward_algorithm=forward_algorithm,
        ctf_kappa=10.0 ** ctf_lg_kappa, run_bfloat16=run_bfloat16)
    io_cfg = IOConfig(
        fname=fname, save_path=save_path,
        output_folder=output_folder or 'recon',
        finite_support_mask_path=finite_support_mask_path,
        save_intermediate=save_intermediate,
        save_intermediate_level=save_intermediate_level,
        save_history=save_history,
        store_checkpoint=store_checkpoint, use_checkpoint=use_checkpoint,
        use_orbax=use_orbax,
        force_to_use_checkpoint=force_to_use_checkpoint,
        n_batch_per_checkpoint=n_batch_per_checkpoint, t_max_min=t_max_min,
        save_stdout=save_stdout)
    cfg = ReconConfig(geometry=geometry, loss=loss_cfg, refine=refine,
                      train=train,
                      parallel=ParallelConfig(
                          data_axis=parallel_data_axis,
                          object_axis=parallel_object_axis,
                          offload_optimizer_state=shared_file,
                          offload_object='auto' if shared_file else False),
                      io=io_cfg)
    mesh = None
    if parallel_data_axis * parallel_object_axis > 1:
        from .parallel.mesh import make_mesh
        mesh = make_mesh(cfg.parallel, device=device)
    if forward_model == 'auto':
        from .models import multidist, ptychography
        model = multidist if is_multi_dist else ptychography
    else:
        model = forward_model

    from .utils.initialize import initialize_object, initialize_probe
    obj_init = initialize_object(
        tuple(obj_size), unknown_type=unknown_type, object_type=object_type,
        initial_guess=initial_guess,
        random_guess_means_sigmas=random_guess_means_sigmas,
        non_negativity=non_negativity, seed=0)
    probe_init = initialize_probe(
        probe_size, probe_type, probe_initial=probe_initial,
        pupil_function=pupil_function, n_probe_modes=n_probe_modes,
        energy_ev=energy_ev, psize_cm=psize_cm,
        sign_convention=sign_convention,
        extra_defocus_cm=probe_extra_defocus_cm,
        data_for_ifft=data[0] if probe_type == 'ifft' else None,
        data_for_rescale=data[0:1] if rescale_probe_intensity else None,
        raw_data_type=raw_data_type, normalize_fft=normalize_fft,
        rescale_intensity=rescale_probe_intensity, seed=0, **kwargs)
    if not shared_probe_among_angles:
        # An independent probe for each angle.
        probe_init = np.tile(probe_init[None], (len(theta_ls), 1, 1, 1, 1))

    mask = None
    if finite_support_mask_path is not None:
        from .io.output import read_tiff
        mask = read_tiff(finite_support_mask_path)
        if mask.ndim == 2 and len(obj_size) == 3 and obj_size[2] > 1:
            mask = np.repeat(mask[:, :, None], obj_size[2], axis=2)
        elif mask.ndim == 3 and mask.shape[0] == obj_size[2]:
            mask = np.moveaxis(mask, 0, -1)
    out_folder = (os.path.join(save_path, output_folder) if output_folder
                  else None)

    if use_epie:
        from .conventional import epie_reconstruct
        probe_c = probe_init[0, ..., 0] + 1j * probe_init[0, ..., 1]
        obj_c = (obj_init[..., 0, 0] + 1j * obj_init[..., 0, 1]
                 if unknown_type == 'real_imag'
                 else np.ones(obj_size[:2], np.complex64))
        # Positions shifted to be non-negative.
        pad = np.maximum(-probe_pos.min(axis=0), 0).astype(int)
        obj_rec, probe_rec = epie_reconstruct(
            data[0], probe_c, probe_pos.astype(int) + pad, obj_c,
            energy_ev=energy_ev, psize_cm=psize_cm, alpha=epie_alpha,
            n_epochs=max_nepochs if n_epochs == 'auto' else int(n_epochs),
            raw_data_type=raw_data_type, device=device)
        ds.close()
        return {'obj': obj_rec.cpu().numpy(), 'probe': probe_rec.cpu().numpy()}
    # The refined kappa starts at the user's ctf_lg_kappa; known tilts
    # are taken as given.
    aux_init = {}
    if optimize_ctf_lg_kappa:
        aux_init['ctf_lg_kappa'] = float(ctf_lg_kappa)
    if initial_tilt is not None:
        aux_init['tilt_ls'] = np.asarray(initial_tilt, np.float32)

    # The multiscale schedule: coarse levels first, each starting from the
    # previous one's result upsampled.
    results = None
    prev_pass = None
    init_kw = dict(unknown_type=unknown_type, object_type=object_type,
                   random_guess_means_sigmas=random_guess_means_sigmas,
                   non_negativity=non_negativity, seed=0)
    for level in range(multiscale_level - 1, -1, -1):
        ds_level = 2 ** level
        if ds_level > 1:
            small = tuple(max(1, s // ds_level) for s in obj_size[:2]) + (
                max(1, obj_size[2] // ds_level) if obj_size[2] > 1 else 1,)
            g = dataclasses.replace(
                geometry, obj_size=small,
                probe_size=tuple(max(1, p // ds_level) for p in probe_size),
                psize_cm=psize_cm * ds_level)
            cfg_l = dataclasses.replace(cfg, geometry=g)
            data_l = data[:, :, ::ds_level, ::ds_level]
            pos_l = probe_pos / ds_level
            obj_l = initialize_object(small, previous_pass=prev_pass,
                                      **init_kw)
            probe_l = probe_init[..., ::ds_level, ::ds_level, :]
        else:
            cfg_l, data_l, pos_l, probe_l = cfg, data, probe_pos, probe_init
            obj_l = obj_init if prev_pass is None else initialize_object(
                tuple(obj_size), previous_pass=prev_pass, **init_kw)
        rec = Reconstructor(
            cfg_l, data=data_l, probe_pos=pos_l, theta_ls=theta_ls,
            obj_init=obj_l, probe_init=probe_l, beamstop=beamstop,
            finite_support_mask=mask if ds_level == 1 else None,
            reg_list=reg_list, model=model,
            output_folder=out_folder if ds_level == 1 else None,
            aux_init=aux_init or None,
            external_algorithm=update_using_external_algorithm,
            device=device, mesh=mesh)
        results = rec.run()
        obj = results['obj']
        prev_pass = (obj[..., 0], obj[..., 1])
    ds.close()
    return results
