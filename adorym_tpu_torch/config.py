"""Typed configuration for reconstruction runs.

The same frozen dataclasses as the JAX package's ``config.py``, with the
same field names and defaults, so one configuration describes a run in
either package.  Fields whose meaning on CUDA differs from the TPU's are
noted below; fields outside the ported slice are accepted here and
rejected by :class:`adorym_tpu_torch.recon.Reconstructor` with a
``NotImplementedError`` that names the ROADMAP item porting them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Beam/object geometry (reference kwargs: ``obj_size, energy_ev,
    psize_cm, free_prop_cm, binning, slice_pos_cm_ls`` ...)."""
    obj_size: Tuple[int, int, int]          # (y, x, z) voxels
    probe_size: Tuple[int, int]             # detector/probe pixels
    energy_ev: float = 5000.0
    psize_cm: float = 1e-7
    slice_spacing_cm: Optional[float] = None  # reference ``delta_cm``
    free_prop_cm: Union[str, float, Sequence[float], None] = 'inf'
    binning: int = 1
    fresnel_approx: bool = True
    sign_convention: int = 1
    two_d_mode: bool = False
    pure_projection: bool = False
    is_minus_logged: bool = False
    scale_ri_by_k: bool = True
    # Sparse multislice: explicit slice z positions (cm); None = regular grid.
    slice_pos_cm_ls: Optional[Tuple[float, ...]] = None
    # Multi-distance holography: number of propagation distances.
    n_dists: int = 1
    # Safe-zone width for near-field models (None = auto).
    safe_zone_width: Optional[int] = None

    @property
    def n_slices(self) -> int:
        return self.obj_size[2]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    loss_function_type: str = 'lsq'         # 'lsq' | 'poisson'
    raw_data_type: str = 'magnitude'        # 'magnitude' | 'intensity'
    poisson_multiplier: float = 1.0
    normalize_fft: bool = False
    # Regularizer weights (0 disables):
    alpha_d: float = 0.0
    alpha_b: float = 0.0
    gamma: float = 0.0
    reweighted_l1: bool = False
    corr_reg: float = 0.0
    grad_corr_reg: float = 0.0


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Which auxiliary parameters are optimized, and their learning rates."""
    optimize_probe: bool = False
    probe_learning_rate: float = 1e-3
    probe_optimizer: str = 'adam'
    probe_update_delay: int = 0             # global batches before updating
    probe_update_limit: Optional[int] = None
    optimize_probe_defocusing: bool = False
    probe_defocusing_learning_rate: float = 1e-5
    probe_defocusing_optimizer: str = 'adam'
    optimize_probe_pos_offset: bool = False
    probe_pos_offset_learning_rate: float = 1e-2
    probe_pos_offset_optimizer: str = 'adam'
    optimize_prj_pos_offset: bool = False
    prj_pos_offset_learning_rate: float = 1e-2
    prj_pos_offset_optimizer: str = 'adam'
    optimize_all_probe_pos: bool = False
    all_probe_pos_learning_rate: float = 1e-2
    all_probe_pos_optimizer: str = 'adam'
    optimize_slice_pos: bool = False
    slice_pos_learning_rate: float = 1e-4
    slice_pos_optimizer: str = 'adam'
    optimize_free_prop: bool = False
    free_prop_learning_rate: float = 1e-2
    free_prop_optimizer: str = 'adam'
    optimize_tilt: bool = False
    tilt_learning_rate: float = 1e-3
    tilt_optimizer: str = 'adam'
    fixed_tilt: bool = False
    optimize_prj_affine: bool = False
    prj_affine_learning_rate: float = 1e-3
    prj_affine_optimizer: str = 'adam'
    optimize_ctf_lg_kappa: bool = False
    ctf_lg_kappa_learning_rate: float = 1e-3
    ctf_lg_kappa_optimizer: str = 'adam'
    # Gate ALL auxiliary updates (everything but obj/probe) until this many
    # global batches have run.
    other_params_update_delay: int = 0

    @property
    def tilt_active(self) -> bool:
        return self.optimize_tilt or self.fixed_tilt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_epochs: Union[int, str] = 'auto'
    crit_conv_rate: float = 0.03
    max_nepochs: int = 200
    minibatch_size: int = 23
    randomize_probe_pos: bool = False
    learning_rate: float = 1e-5
    optimizer: str = 'adam'                  # adam | gd | momentum | cg | curveball
    optimize_object: bool = True
    update_scheme: str = 'immediate'         # 'immediate' | 'per angle'
    unknown_type: str = 'delta_beta'
    object_type: str = 'normal'              # normal | phase_only | absorption_only
    non_negativity: bool = False
    shrink_cycle: Optional[int] = None
    shrink_threshold: float = 1e-9
    multiscale_level: int = 1
    theta_downsample: Optional[int] = None
    n_batch_per_update: int = 1
    rotate_out_of_loop: bool = False
    n_probe_modes: int = 1
    shared_probe_among_angles: bool = True
    common_probe_pos: bool = True
    forward_algorithm: str = 'fresnel'       # 'fresnel' | 'ctf'
    ctf_kappa: float = 50.0
    # bf16 storage of the object patches, the multislice records and the
    # patch cotangents (reference ``run_bfloat16``); the kernels compute in
    # f32 and the gradient accumulator stays f32.
    run_bfloat16: bool = False
    # Multislice kernel (ops/cuda_multislice.py): 'auto' runs it whenever
    # the tensors are on CUDA | 'on' (on the CPU: its plain version) |
    # 'off' (the plain FFT scan).
    fused_multislice: str = 'auto'
    # Fold the object-to-detector propagation into the multislice
    # kernel's last step: 'auto' | 'off'.
    fuse_farfield: str = 'auto'
    # Patch-granular gradient accumulation for scan tables that are not
    # constant-stride grids (not ported: ROADMAP A, the rest of the
    # per-angle path).
    patch_grad: bool = False
    # Bin the rotated object in z once per angle and move patches at
    # binned depth: 'auto' | 'off'.
    prebin_z: str = 'auto'
    # Streaming rotation for objects too large for the bulk rotate
    # (not ported: ROADMAP A, the rest of the per-angle path): 'auto' |
    # 'on' | 'off'.
    stream_rotation: str = 'auto'
    # Gradient rotate-back under rotate_out_of_loop: False interpolates at
    # -theta like the reference; True is the exact transpose (the
    # accumulate-then-update loop; on the per-angle path not ported:
    # ROADMAP A, the rest of the per-angle path).
    exact_grad_rotation: bool = False
    # Immediate-scheme band rotate-back (ROADMAP A, the immediate scheme):
    # 'exact' | 'interp'.
    imm_grad_rotation: str = 'exact'
    # Extract patches z-major, born in the multislice kernel's
    # [zb, 2, N, py, px] layout: 'auto' (on for CUDA) | 'on' | 'off'.
    zmajor_extract: str = 'auto'
    # Rotation resampling: 'bilinear' | 'nearest'.
    interpolation: str = 'bilinear'
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device layout (multi-GPU is ROADMAP A, multi-GPU and out-of-core)."""
    data_axis: int = 1
    object_axis: int = 1
    axis_names: Tuple[str, str] = ('dp', 'op')
    use_halo_gather: Union[bool, str] = 'auto'
    offload_optimizer_state: bool = False
    offload_slabs: int = 8
    offload_object: Union[bool, str] = False


@dataclasses.dataclass(frozen=True)
class IOConfig:
    fname: str = 'data.h5'
    save_path: str = '.'
    output_folder: str = 'recon'
    finite_support_mask_path: Optional[str] = None
    save_intermediate: bool = False
    save_intermediate_level: str = 'epoch'   # 'epoch' | 'batch'
    save_history: bool = False
    store_checkpoint: bool = True
    use_checkpoint: bool = True
    use_orbax: bool = False
    force_to_use_checkpoint: bool = False
    n_batch_per_checkpoint: int = 10
    save_stdout: bool = False
    t_max_min: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ReconConfig:
    geometry: Geometry
    loss: LossConfig = LossConfig()
    refine: RefineConfig = RefineConfig()
    train: TrainConfig = TrainConfig()
    parallel: ParallelConfig = ParallelConfig()
    io: IOConfig = IOConfig()

    def replace(self, **kw) -> 'ReconConfig':
        return dataclasses.replace(self, **kw)
