"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero):
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel of the main paths from ``adorym_tpu_torch/csrc``
     (one nvcc per source, all at once);
  3. each kernel against its plain PyTorch version at the shapes its path
     gives it, f32 and bf16 (forward and backward for the multislice
     pairs), with kernel, plain and library times and the bound of each:
     K1 at the delta_beta flagship, on its FFT route and on its dense
     route (the folded step mats), checked and timed beside it; K3 at the
     real_imag flagship; K2 at C = 64 (the delta_beta chunk) and C = 512
     (the real_imag and multi-mode chunks), each in both layouts, its
     vector instantiation held bit-equal to its scalar one and timed beside
     it; K5 (with a non-paraxial transfer function) on both routes at one
     and three modes; K1 at three probe modes; K4 at the multi-mode
     flagship's chunk (256 steps, three modes, physical absorption) on its
     FFT route, also against K1's plain version on 64 of its patches, and
     on its dense route, checked and timed beside it; K6
     (``csrc/rowgrid_scatter.cu``) on 23 patch-major rows of 32 slices,
     one at a time, and at each row shape below, held to its plain
     version, bit for bit to K2's kernel at one row and to its scalar
     instantiation, with its device time (torch.profiler, or a CUDA
     graph's replay where the profiler reports none) beside the time of
     its calls; the immediate path's shapes:
     K1 at one grid row (N = 23), K6 on the row's z-major gradient, and
     the band's exact backward in both forms (the tap gather and the
     autograd transpose), held to each other and timed; K1 at the adhesin
     configuration's shape (one 64^2 patch through 64 steps, no far field
     folded in); then both routes
     of K1, K4 and K5 and their plain versions against a complex128 sweep
     on 64 patches (K5 over five draws, with each route's gain bias over
     one step);
  4. the delta_beta flagship epoch (256^3 object, 23x23 scan of 72^2
     patterns at stride 8, binning 8, Fraunhofer, Adam, per-angle updates
     with the rotation out of the loop; 4 angles of random data) through
     ``Reconstructor``, f32 and bf16: a warmup epoch and 3 timed epochs,
     with each kernel's launch count (by route and instantiation: K2's
     and K6's vector one on every path) read after the run, then one f32
     epoch under torch.profiler for the device time by kernel;
  4b. the same for the real_imag flagship (the object starts as vacuum,
     1 in the real channel and 0 in the imaginary one), through K3, K5 on
     its FFT route and K2; its profile must show no product backward (the
     z binning is one autograd Function);
  4c. the same for the multi-mode flagship (three probe modes refined with
     the object, binning 1, so 256 steps), through K4 on its FFT route and
     K2; then, f32 only, one warmup and one timed epoch at binning 8,
     through K1 at three modes;
  4d. the same for the immediate flagship (the flagship's geometry with
     the reference's default scheme: one Adam update a grid row with the
     rotation in the loop, 92 updates an epoch), through the band step:
     K1 at 23 patches and K6 once a row, 23 of each an angle;
  5. a small configuration trained on CUDA and on the CPU (through K1's
     FFT route at 16^2): the per-epoch losses must agree;
  5b. the same for a small real_imag configuration and for a delta_beta
     one with a non-paraxial transfer function at a finite distance;
  5c. the same for a small multi-mode configuration (three refined probe
     modes, binning 1), with K4 forced (on its FFT route at 16^2) and then
     through K1;
  5d. the same for the immediate scheme: the band step and the generic
     step (a jittered table), each delta_beta and real_imag;
  5e. the same with regularizers, a support cylinder and shrink-wrap: the
     band step, the generic step and the per-angle step, delta_beta and
     real_imag, and a 2D run;
  6a. the immediate flagship with the adhesin demo's regularizers scaled
     to 256^3, a support cylinder, shrink-wrap, an output folder and
     checkpoints every 10 batches, through ``Reconstructor.run()``: a
     warmup and a timed epoch (patterns/s, peak memory, seconds a
     checkpoint, launches), then a resume from a mid-epoch checkpoint,
     held to the uninterrupted run at 1e-5 (its epochs, without
     checkpoints, timed), and the reference's output file names;
  6b. the adhesin demo's reconstruction (``demos/multislice_tomography_64.
     py``, the reference's CI configuration) through
     ``reconstruct_ptychography``, 3 epochs on CUDA and on the CPU, the
     per-epoch losses within 1e-4, with the phantom correlation;
  6c. the per-angle flagship with the same regularizers and support: a
     warmup and 2 timed epochs;
  7b. the immediate flagship with the per-spot probe positions refined
     (K1 at N=23 with per-spot waves, K6), f32, a warmup and 2 timed
     epochs, beside 4d's plain cell;
  7c. the per-angle flagship with the positions and the projection offset
     refined (K1 at N=529 with the far field left out, K2), f32, a warmup,
     2 timed epochs and a profiled one, beside 4's plain cell;
  7. small configurations of each new path on CUDA and on the CPU (2-D
     positions with two refined probe modes; the band step and the
     per-angle step with positions; the multi-distance model with its
     distances, affines and shifts refined): losses within 1e-4;
  7a. BASELINE #2 (``demos/2d_ptychography_experimental_data.py``) at the
     demo's size through ``reconstruct_ptychography``, 30 epochs, with the
     mean position residual before and after; 3 epochs of it held against
     the CPU (losses and refined positions); 200 epochs with the position
     updates held back 50, the residual falling below its start;
  7d. BASELINE #4 (``demos/2d_multidist_holography_w_affine.py``) at the
     demo's size, 200 epochs, with the distance error before and after;
  8. small configurations of each path of the accumulate-then-update loop
     and each new forward model on CUDA and on the CPU (the rotation
     inside autodiff per angle, with tilt, immediate with the rotation
     out of the loop, two batches an update, the band step under a
     refined kappa, sparse slices, line projections, the multi-distance
     CTF): losses within 1e-4;
  8a-8d. the flagship geometry (two angles) through the accumulate loop:
     per angle with the rotation inside autodiff (8a) and with the tilts
     refined (8b), immediate with the rotation out of the loop (8c) and
     with four batches an update (8d): a warmup and a timed epoch, one
     angle under the profiler, K1's launches an angle;
  8e. sparse slices at [0, 10e-4] cm over a [256, 256, 2] object at the
     flagship's probe and scan, the positions refined (the band step: K6
     on each row's patch-major gradient of the two slices);
  8f. line-projection tomography of a 256^3 object (minus-logged, 16
     angles of 256^2);
  8g. 7d's configuration with the CTF forward algorithm and kappa
     refined;
  9. small configurations of each new branch of the per-angle path on
     CUDA and on the CPU (chunks padded at weight 0, staggered rows, a
     jittered table through the whole object and under patch_grad, a
     randomized one, per-angle tables on the per-angle, accumulate and
     immediate paths, the streaming rotation, the exact rotate-back, a
     model without a patch-granular form): losses within 1e-4;
  9a-9f. the flagship's geometry per angle with the scan tables and
     options the per-angle path takes besides one complete grid, each a
     warmup and 2 timed epochs (patterns/s, peak memory, launches by
     route; one f32 epoch profiled): a jittered table through the
     whole-object branch and under patch_grad, f32 and bf16, with the
     any-table scatter's device time (9a); per-angle ragged tables through
     ``reconstruct_ptychography(common_probe_pos=False)`` (9b);
     ``randomize_probe_pos`` without and with patch_grad (9c); staggered
     rows, K6 on each chunk row read in place, f32 and bf16 (9d); the
     streaming rotation 'on' against 'off' at 256^3, then a 1024^3 object
     (one angle, 40x40 spots at stride 24) where 'auto' streams, with the
     peak memory of 'auto' and 'off' (9e); the exact rotate-back, its
     device time beside the interp form's (9f);
  10. small configurations of each path of this slice on CUDA and on the
     CPU: CG and Curveball on a 32^3 delta_beta (K1) and real_imag (K5)
     object (losses within 1e-4, each batch's launches of the pair and of
     the multislice tangent checked); K1's and K5's forward-mode rules at
     10a's shapes against forward mode through the plain FFT scan (1e-5 of
     the largest value), timed beside K1's forward kernel; ePIE, the
     multi-distance CTF retrieval, the external CTF update and the scipy
     bridge (Newton-CG), each within 1e-4;
  10a. CG and Curveball at the flagship's width (the immediate scheme,
     minibatch 23, 2 angles): a warmup and a timed epoch each, with
     patterns/s, peak memory, K1's and the tangent's launches a batch and
     CG's line-search evaluations a batch;
  10b. ePIE through ``reconstruct_ptychography(use_epie=True)`` on
     BASELINE #2's data (256^2, 256 spots of 72^2): seconds an epoch and
     the phase correlation with the star;
  10c. BASELINE #4's holograms through ``reconstruct_ptychography`` with
     ``update_using_external_algorithm='ctf'``, and ``multidistance_ctf``
     alone on them (ms a call, the phase correlation);
  10d. ``scipy_minimize_object`` (Newton-CG, the Gauss-Newton ``hessp``)
     on a full-batch 2-D problem at 128^2, 10 iterations: the loss before
     and after, and the time;
  11. out-of-core on the card: the page-locked host link's rates (the
     bound of each offloaded run), then
  11a. the per-angle flagship (4 angles, f32) with its data read through
     a ``FastLoader`` over a raw file in the work dir, beside the
     device-resident run: equal losses, patterns/s of each;
  11b. the per-angle and the immediate flagship with Adam's moments on
     the host in 8 slabs, against their resident runs (losses within
     1e-6 relative, the object within 1e-6 of its largest value),
     patterns/s and peak memory;
  11c. 9e's 1024^3 configuration (one angle, 40x40 spots at stride 24,
     minibatch 40) with the object and its moments on the host, against
     9e's resident 'auto' run (losses within 1e-6 relative): peak device
     memory, ``fuse_g``, host memory, patterns/s and the link's bound;
  11d. a 1280^3 object (16.8 GB, with 33.6 GB of moments, on the host; no
     resident budget holds it), 50x50 spots at stride 24, minibatch 50,
     one warmup and one timed angle, K1f, K1b and K2 (or K6) launched;
  11e. ``run_epochs(3)`` against three ``run_epoch`` calls on the
     immediate flagship: equal losses, the wall time of each;
  12. device meshes, as gloo ranks that share the one card (started by
     this script; NCCL refuses two ranks on one card): which collectives
     gloo takes on CUDA tensors, then
  12a. the per-angle flagship (2 angles, f32) on the mesh path at
     (dp, op) = (2, 1), (1, 2) and (2, 2), against the one-rank run on the
     card: every grid row's loss within 1e-5 relative, the first update's
     object gradient, assembled from the ranks' slabs, within 1e-5 of its
     largest value; at (2, 2) also under GD at rate 0 (the object stays
     at its start), both angles' gradients;
  12b. the immediate flagship at (2, 2), one epoch, against the one-rank
     run (the same checks; at rate 0, one angle, the gradients of its
     first row, its first band across the slab boundary and its last);
  12c. BASELINE #5 (``demos/multislice_ptycho_256_theta.py``: 256^3,
     24x24 spots, minibatch 24) through ``reconstruct_ptychography(
     distribution_mode='distributed_object', parallel_object_axis=2)``
     with random data, 2 angles, one epoch;
  12d. 12a at (2, 2) with Adam's moments on the host, bit-equal to 12a's
     resident mesh run;
  12e. ``sharded_patch_gather`` and its VJP at the flagship's binned
     padded object and 529 windows, against the dense gather.
     Each run prints the backend and ranks a card, each rank's K1f, K1b,
     K6 and K2 launches, peak memory, collectives by kind (count, bytes,
     seconds) and patterns/s (wiring on one shared card, not scaling).
     Then K1 and K6 at the shapes 12a (2, 2) and 12b give them (a rank's
     chunk of 17 row slots of 12 spots; 6 spots of a row into the band),
     against their plain versions, with those runs' launches;
  13. the port's demos and user tools (``adorym_tpu_torch/demos``,
     ``adorym_tpu_torch/tools``) on the card, each demo through its
     ``main`` with its data simulated on the card (no h5py there):
  13a. BASELINE #5, the cone demo at full width (256^3, 20 angles of
     24x24 72^2 patterns, binning 8, per angle, 2 epochs): the simulation's
     seconds, each epoch's loss and patterns/s, peak memory, the phantom
     correlation and K1f/K1b/K2's launches an angle; held: the loss falls,
     one K1 pair and one K2 a gradient chunk, and the first angle's loss
     within 1e-4 of the same angle's on the CPU from the same data and
     start;
  13b. the seven demos at the sizes and epoch counts of
     ``tests/test_demos.py`` (the cone demo at scale 4), each held to that
     file's threshold, with its wall, patterns/s and kernels launched;
  13c. the tools' computations against the CPU: the ER probe retrieval
     (with ``tests/test_tools.py``'s assertions), the multi-distance CTF
     retrieval, the affine warp and the registration, and
     ``profiler_trace`` recording the card's kernels.
  14. sharded checkpoints (``use_orbax=True``, ``torch.distributed.
     checkpoint``): the write rate of the output folder's disk (1 GB,
     fsync), then
  14a. the per-angle flagship (4 angles, f32) with a checkpoint after each
     angle, in the sharded and in the npz form: seconds a checkpoint,
     bytes written, K1f, K1b and K2 launched; a resume from the sharded
     checkpoint after angle 2, its row losses and object within 1e-6 of
     the uninterrupted run's;
  14b. 12a's flagship at (2, 2) (gloo ranks on the card): each rank's
     bytes written and all-gather bytes during the sharded checkpoint
     (none) beside the npz form's, K1 and K6 launched; the checkpoint
     restored onto (1, 2) and onto one rank, each resumed epoch within
     1e-5 of the uninterrupted (2, 2) run's;
  14c. a 512^3 object and its moments on the host: seconds a sharded
     checkpoint beside bytes / the disk's rate, the host's RSS before and
     during the write (growth under half the object), a resume equal to
     the uninterrupted run (1e-6).
Phase 3 also holds K1 under ``beta = kappa delta`` and in -z (the
branches of ``multislice_propagate`` that phase 8 adds), K6 on the rows
of a per-angle chunk's z-major gradient [32, 2, 529, 72, 72] read in
place (9d's layout; bit for bit to the copy route too), K6 at 8e's
patch-major row of two slices and at the real_imag band step's row
(C = 512), and K1 with
per-spot waves (made by position refinement's
phase ramps; N=23 with the far field folded, N=529 without), and K1, K4
and K5 on their global route at planes no shared-memory route takes (96^2,
96^2 at three modes, 128^2) against their plain versions, then runs those
planes through ``multislice_propagate`` under ``fused='auto'`` against the
plain FFT scan, with the launches counted.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

#: H100 SXM data sheet: HBM3 bandwidth and f32 rate outside tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

#: The card's name and power limit, as nvidia-smi prints them (set by
#: main); the phase 7 summaries print it beside their numbers.
CARD = ''

FLAGSHIP = dict(n_obj=256, n_probe=72, mb=23, binning=8, stride=8,
                energy_ev=5000.0, psize_cm=1e-7, n_theta=4)


def log(*a):
    print(*a, flush=True)


#: perf_counter at the start of main; :func:`stamp` logs the time since.
T0 = time.perf_counter()


def stamp(what):
    """Log the seconds since the script started, at the end of a phase."""
    log(f'time: {what} done at {time.perf_counter() - T0:.1f} s')


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after one warmup call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def rel_err(a, b):
    a, b = a.detach(), b.detach()
    a = torch.view_as_real(a) if a.is_complex() else a.float()
    b = torch.view_as_real(b) if b.is_complex() else b.float()
    return float((a - b).abs().max()), float((a - b).abs().max()
                                             / b.abs().max())


def flagship_positions():
    xs = np.arange(23) * 8 - 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    return np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)


# -- phase 3 -----------------------------------------------------------------

def check_multislice(dtype, tol_fwd, tol_bwd, M=1, N=529, path=None,
                     label=''):
    """K1 forward and backward against the plain version at one flagship
    gradient chunk: S=32 binned steps, N patches of 72x72, M probe modes
    (M=1 on the delta_beta flagship, 3 on the binned multi-mode one; N=529,
    a whole angle, on the per-angle paths, and N=23, one grid row, on the
    immediate one; ``path`` and ``label`` name another path that gives K1
    N patches, a mesh rank's).  The shape takes K1's FFT route (72 = 8 x
    9), which the main path runs; the dense route (the folded step mats),
    forced, is held against the same plain version with the same
    tolerances and timed beside it in turns (fft, dense, dense, fft); at
    the flagships' shapes the FFT route must be the faster."""
    from adorym_tpu_torch.ops import cuda_multislice as cm
    from adorym_tpu_torch.ops import propagate as prop
    S, n = 32, 72
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(
        (0 if M == 1 else 10 + M) + (N != 529))
    db = (torch.rand((S, 2, N, n, n), device=dev, generator=gen)
          * 0.01).to(dtype)
    wave = torch.randn((M, N, n, n), dtype=torch.complex64, device=dev,
                       generator=gen)
    g = torch.randn((M, N, n, n), dtype=torch.complex64, device=dev,
                    generator=gen)
    lmbda = 1240.0 / FLAGSHIP['energy_ev']
    voxel = (1.0, 1.0, 1.0)
    k1 = 2 * np.pi * 1.0 / lmbda
    h = prop.fresnel_kernel((n, n), voxel, lmbda, 8.0, device=dev)
    fay, fax = prop.final_prop_mats((n, n), voxel, lmbda, 'inf',
                                    device=dev)[:2]

    def run(fn):
        d = db.detach().requires_grad_()
        w = wave.detach().requires_grad_()
        out = fn(d, w, h, k1, 1.0, fay, fax)
        gd, gw = torch.autograd.grad(out, (d, w), g, retain_graph=True)
        return out, gd, gw, (lambda: torch.autograd.grad(
            out, (d, w), g, retain_graph=True))

    tag = str(dtype).split('.')[-1]
    modes = ((f' M={M}' if M > 1 else '') + (f' N={N}' if N != 529 else '')
             + label)
    route = cm.k1_route(n, n)
    if route != 'fft':
        raise AssertionError(f'K1 takes the {route} route at {n}x{n}')
    r0 = dict(cm.K1_ROUTE_LAUNCHES)
    out_k, gd_k, gw_k, bwd_k = run(cm.multislice_db_stored_packed)
    took = {r: cm.K1_ROUTE_LAUNCHES[r] - r0[r] for r in r0}
    mats_d = cm.prop_mats(h, fay, fax, route='dense')

    def dense(d, w, h_, k1_, s_, *_):
        return cm.MultisliceDbStored.apply(d, w, mats_d, k1_, s_)
    out_d, gd_d, gw_d, bwd_d = run(dense)
    out_p, gd_p, gw_p, bwd_p = run(cm.multislice_db_stored_plain)
    torch.cuda.synchronize()
    if took != {'fft': 2, 'dense': 0, 'global': 0}:
        raise AssertionError(f'K1{modes} {tag}: launches by route {took}')
    errs = {}
    for name, (out_r, gd_r, gw_r) in (('fft', (out_k, gd_k, gw_k)),
                                      ('dense', (out_d, gd_d, gw_d))):
        e_fwd, r_fwd = rel_err(out_r, out_p)
        e_gd, r_gd = rel_err(gd_r, gd_p)
        e_gw, r_gw = rel_err(gw_r, gw_p)
        errs[name] = (e_fwd, r_fwd, max(e_gd, e_gw), max(r_gd, r_gw))
        log(f'K1{modes} {tag} {name} route: fwd max_abs {e_fwd:.3e} rel '
            f'{r_fwd:.3e} (tol {tol_fwd}); gdb max_abs {e_gd:.3e} rel '
            f'{r_gd:.3e}; gw max_abs {e_gw:.3e} rel {r_gw:.3e} (tol '
            f'{tol_bwd})')
        if not (r_fwd < tol_fwd and r_gd < tol_bwd and r_gw < tol_bwd):
            raise AssertionError(f'K1{modes} {tag} {name} route disagrees '
                                 'with its plain version')
    e_fwd, r_fwd, e_bwd, r_bwd = errs['fft']
    mats = cm.prop_mats(h, fay, fax, route='fft')

    def launch(m):
        # The launch alone: the step vectors or mats are built once.
        return lambda: cm.MultisliceDbStored.apply(db, wave, m, k1, 1.0)
    with torch.no_grad():
        # The routes in turns: fft, dense, dense, fft.
        ms_f = time_ms(launch(mats), 10)
        dense_f = (time_ms(launch(mats_d), 10)
                   + time_ms(launch(mats_d), 10)) / 2
        ms_f = (ms_f + time_ms(launch(mats), 10)) / 2
        plain_f = time_ms(lambda: cm.multislice_db_stored_plain(
            db, wave, h, k1, 1.0, fay, fax), 5)
    ms_b = time_ms(bwd_k, 10)
    dense_b = (time_ms(bwd_d, 10) + time_ms(bwd_d, 10)) / 2
    ms_b = (ms_b + time_ms(bwd_k, 10)) / 2
    plain_b = time_ms(bwd_p, 5)
    log(f'K1{modes} {tag}: forward fft route {ms_f:.3f} ms, dense route '
        f'{dense_f:.3f} ms; backward fft route {ms_b:.3f} ms, dense route '
        f'{dense_b:.3f} ms')
    if not label and not (ms_f < dense_f and ms_b < dense_b):
        raise AssertionError(f'K1{modes} {tag}: the FFT route is not faster '
                             'than the dense route at the flagship shape')
    isz = db.element_size()
    b_f, by_f = bound(cm.bytes_moved(S, M, N, n, n, isz),
                      cm.flops(S, M, N, n, n))
    b_b, by_b = bound(cm.bytes_moved(S, M, N, n, n, isz, backward=True),
                      cm.flops(S, M, N, n, n, backward=True))
    src = 'adorym_tpu_torch/csrc/multislice_db_stored.cu'
    path = path or ('immediate' if N != 529 else 'delta_beta' if M == 1
                    else 'multimode_binned')
    recs = [
        record(f'K1f multislice_db_stored forward{modes} ({tag})', src,
               'adorym_tpu/ops/pallas_multislice.py:353', e_fwd, r_fwd,
               tol_fwd, ms_f, plain_f, b_f, by_f, None, 'K1_FWD', path),
        record(f'K1b multislice_db_stored backward{modes} ({tag})', src,
               'adorym_tpu/ops/pallas_multislice.py:422', e_bwd, r_bwd,
               tol_bwd, ms_b, plain_b, b_b, by_b, None, 'K1_BWD', path),
    ]
    add_dense_route(recs, route, dense_f, dense_b, errs['dense'])
    return recs


def check_multislice_unfolded():
    """K1 forward and backward against the plain version at the adhesin
    configuration's shape (phase 6b): one patch (minibatch 1) of 64x64
    through 64 steps, with no far field folded in (``free_prop_cm=0``),
    f32, on its FFT route (64 = 8 x 8): one block on one SM.  Tolerances
    as at the flagship shape."""
    from adorym_tpu_torch.ops import cuda_multislice as cm
    from adorym_tpu_torch.ops import propagate as prop
    S, N, n = 64, 1, 64
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(23)
    db = torch.rand((S, 2, N, n, n), device=dev, generator=gen) * 1e-3
    wave = torch.randn((1, N, n, n), dtype=torch.complex64, device=dev,
                       generator=gen)
    g = torch.randn((1, N, n, n), dtype=torch.complex64, device=dev,
                    generator=gen)
    lmbda = 1240.0 / 800.0
    psize_nm = 0.67
    k1 = 2 * np.pi * psize_nm / lmbda
    h = prop.fresnel_kernel((n, n), (psize_nm,) * 3, lmbda, psize_nm,
                            device=dev)

    def run(fn):
        d = db.detach().requires_grad_()
        w = wave.detach().requires_grad_()
        out = fn(d, w, h, k1, 1.0)
        gd, gw = torch.autograd.grad(out, (d, w), g, retain_graph=True)
        return out, gd, gw, (lambda: torch.autograd.grad(
            out, (d, w), g, retain_graph=True))

    if cm.k1_route(n, n) != 'fft':
        raise AssertionError(f'K1 takes the {cm.k1_route(n, n)} route at '
                             f'{n}x{n}')
    r0 = dict(cm.K1_ROUTE_LAUNCHES)
    out_k, gd_k, gw_k, bwd_k = run(cm.multislice_db_stored_packed)
    took = {r: cm.K1_ROUTE_LAUNCHES[r] - r0[r] for r in r0}
    out_p, gd_p, gw_p, bwd_p = run(cm.multislice_db_stored_plain)
    torch.cuda.synchronize()
    if took != {'fft': 2, 'dense': 0, 'global': 0}:
        raise AssertionError(f'K1 N=1 S=64: launches by route {took}')
    tol_fwd, tol_bwd = 1e-4, 1e-3
    e_fwd, r_fwd = rel_err(out_k, out_p)
    e_gd, r_gd = rel_err(gd_k, gd_p)
    e_gw, r_gw = rel_err(gw_k, gw_p)
    log(f'K1 N=1 S=64 64x64 unfolded float32: fwd max_abs {e_fwd:.3e} rel '
        f'{r_fwd:.3e} (tol {tol_fwd}); gdb max_abs {e_gd:.3e} rel '
        f'{r_gd:.3e}; gw max_abs {e_gw:.3e} rel {r_gw:.3e} (tol {tol_bwd})')
    if not (r_fwd < tol_fwd and r_gd < tol_bwd and r_gw < tol_bwd):
        raise AssertionError('K1 N=1 S=64 disagrees with its plain version')
    # Both the kernel and the CPU run's arithmetic (the FFT scan on the
    # host) against a complex128 sweep: at this depth and with no far
    # field, how far f32 puts each from the function.
    from adorym_tpu_torch.ops.fourier import fft2, ifft2
    eye = torch.eye(n, dtype=torch.complex128, device=dev)
    with torch.no_grad():
        truth = truth_sweep(db, wave, h, k1, 1.0, (eye, eye))
        w_cpu = wave.cpu()
        h_cpu = h.cpu()
        for z in range(S):
            d, b = db[z, 0].cpu(), db[z, 1].cpu()
            w_cpu = w_cpu * torch.polar(torch.exp(-k1 * b), -k1 * d)
            if z < S - 1:
                w_cpu = ifft2(fft2(w_cpu) * h_cpu)
    t_k = rel_err(out_k.to(torch.complex128), truth)[1]
    t_c = rel_err(w_cpu.to(dev).to(torch.complex128), truth)[1]
    log(f'K1 N=1 S=64 against complex128 (of the largest value): kernel '
        f'{t_k:.3e}, the CPU FFT scan {t_c:.3e}')
    del truth
    mats = cm.prop_mats(h, route='fft')
    with torch.no_grad():
        ms_f = time_ms(lambda: cm.MultisliceDbStored.apply(
            db, wave, mats, k1, 1.0), 20)
        plain_f = time_ms(lambda: cm.multislice_db_stored_plain(
            db, wave, h, k1, 1.0), 5)
    ms_b = time_ms(bwd_k, 20)
    plain_b = time_ms(bwd_p, 5)
    b_f, by_f = bound(cm.bytes_moved(S, 1, N, n, n, 4),
                      cm.flops(S, 1, N, n, n, final=False))
    b_b, by_b = bound(cm.bytes_moved(S, 1, N, n, n, 4, backward=True),
                      cm.flops(S, 1, N, n, n, final=False, backward=True))
    log(f'K1 N=1 S=64: forward {ms_f:.4f} ms (plain {plain_f:.3f}, bound '
        f'{b_f:.4f}), backward {ms_b:.4f} ms (plain {plain_b:.3f}, bound '
        f'{b_b:.4f})')
    src = 'adorym_tpu_torch/csrc/multislice_db_stored.cu'
    tag = ' N=1 S=64 64x64 unfolded'
    recs = [
        record(f'K1f multislice_db_stored forward{tag} (float32)', src,
               'adorym_tpu/ops/pallas_multislice.py:353', e_fwd, r_fwd,
               tol_fwd, ms_f, plain_f, b_f, by_f, None, 'K1_FWD', 'adhesin'),
        record(f'K1b multislice_db_stored backward{tag} (float32)', src,
               'adorym_tpu/ops/pallas_multislice.py:422', e_gd if e_gd > e_gw
               else e_gw, max(r_gd, r_gw), tol_bwd, ms_b, plain_b, b_b, by_b,
               None, 'K1_BWD', 'adhesin'),
    ]
    recs[0]['truth_rel_err'] = {'fft': t_k, 'cpu_fft_scan': t_c}
    return recs


def add_dense_route(recs, route, dense_f, dense_b, errs):
    """The step route of a multislice pair's ``ms`` (the main path's), and
    the dense route's time and error in the same process."""
    for rec, dense_ms, i in ((recs[0], dense_f, 0), (recs[1], dense_b, 2)):
        rec.update(step_route=route, dense_ms=dense_ms,
                   dense_max_abs_err=errs[i], dense_rel_err=errs[i + 1])


def check_invertible(dtype):
    """K4 forward and backward against its plain version (which rebuilds
    the waves op by op) at the multi-mode flagship's chunk: S=256 steps
    (binning 1), M=3 modes, N=529 patches of 72x72, with the Fraunhofer far
    field and its exact inverse.  The absorption is physical (b up to 1e-4,
    k1 b up to 2.5e-3 per 1 nm slice), since the rebuilt waves carry
    roundoff grown by exp(k1 b) per step.  In f32 the kernel's gradients
    are also held against the truth, autograd through K1's plain version
    (which keeps every step), on the first 64 patches, where that fits.

    The shape takes K4's FFT route (72 = 8 x 9), which the main path runs;
    the dense route (the folded step mats), forced, is held against the
    same plain version with the same tolerances and timed beside it.

    Tolerances, relative to the largest value: the forward 1e-4 and the
    gradients 1e-3 (256 steps of sums in other orders than cuBLAS and
    cuFFT); in bf16 the gradient on db, which each rounds once to bf16,
    to 2 bf16 ulps of its largest value."""
    from adorym_tpu_torch.ops import cuda_multislice as cm
    from adorym_tpu_torch.ops import propagate as prop
    S, M, N, n = 256, 3, 529, 72
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(5)
    db = torch.empty((S, 2, N, n, n), device=dev)
    db[:, 0].uniform_(0, 1e-3, generator=gen)
    db[:, 1].uniform_(0, 1e-4, generator=gen)
    db = db.to(dtype)
    wave = torch.randn((M, N, n, n), dtype=torch.complex64, device=dev,
                       generator=gen)
    g = torch.randn((M, N, n, n), dtype=torch.complex64, device=dev,
                    generator=gen)
    lmbda = 1240.0 / FLAGSHIP['energy_ev']
    voxel = (1.0, 1.0, 1.0)
    k1 = 2 * np.pi * 1.0 / lmbda
    h = prop.fresnel_kernel((n, n), voxel, lmbda, 1.0, device=dev)
    fm = prop.final_prop_mats((n, n), voxel, lmbda, 'inf', device=dev)

    def run(fn, d_in, w_in, g_in, mats):
        d = d_in.detach().requires_grad_()
        w = w_in.detach().requires_grad_()
        out = fn(d, w, h, k1, 1.0, *mats)
        gd, gw = torch.autograd.grad(out, (d, w), g_in, retain_graph=True)
        return out.detach(), gd, gw, (lambda: torch.autograd.grad(
            out, (d, w), g_in, retain_graph=True))

    tag = str(dtype).split('.')[-1]
    route = cm.k4_route(n, n)
    if route != 'fft':
        raise AssertionError(f'K4 takes the {route} route at {n}x{n}')
    r0 = dict(cm.K4_ROUTE_LAUNCHES)
    out_k, gd_k, gw_k, bwd_k = run(cm.multislice_db_packed, db, wave, g, fm)
    took = {r: cm.K4_ROUTE_LAUNCHES[r] - r0[r] for r in r0}
    mats_d = cm.prop_mats(h, *fm, route='dense')

    def dense(d, w, h_, k1_, s_, *_):
        return cm.MultisliceDb.apply(d, w, mats_d, k1_, s_)
    out_d, gd_d, gw_d, bwd_d = run(dense, db, wave, g, fm)
    out_p, gd_p, gw_p, bwd_p = run(cm.multislice_db_plain, db, wave, g, fm)
    torch.cuda.synchronize()
    if took != {'fft': 2, 'dense': 0, 'global': 0}:
        raise AssertionError(f'K4 {tag}: launches by route {took}')
    tol_fwd, tol_bwd = 1e-4, 1e-3
    tol_gd = tol_bwd
    if dtype == torch.bfloat16:
        top = float(gd_p.float().abs().max())
        tol_gd = 2 * 2.0 ** (np.floor(np.log2(top)) - 7) / top
    errs = {}
    for name, (out_r, gd_r, gw_r) in (('fft', (out_k, gd_k, gw_k)),
                                      ('dense', (out_d, gd_d, gw_d))):
        e_fwd, r_fwd = rel_err(out_r, out_p)
        e_gd, r_gd = rel_err(gd_r, gd_p)
        e_gw, r_gw = rel_err(gw_r, gw_p)
        errs[name] = (e_fwd, r_fwd, max(e_gd, e_gw), max(r_gd, r_gw))
        log(f'K4 {tag} (S={S}, M={M}) {name} route: fwd max_abs {e_fwd:.3e} '
            f'rel {r_fwd:.3e} (tol {tol_fwd}); gdb max_abs {e_gd:.3e} rel '
            f'{r_gd:.3e} (tol {tol_gd:.3e}); gw max_abs {e_gw:.3e} rel '
            f'{r_gw:.3e} (tol {tol_bwd})')
        if not (r_fwd < tol_fwd and r_gd <= tol_gd and r_gw < tol_bwd):
            raise AssertionError(f'K4 {tag} {name} route disagrees with its '
                                 'plain version')
    e_fwd, r_fwd, e_bwd, r_bwd = errs['fft']
    del out_p, gd_p, gw_p, gd_k, gw_k, out_d, gd_d, gw_d
    if dtype == torch.float32:
        # The truth keeps all 256 steps' intermediates: 64 patches fit.
        sub = (db[:, :, :64], wave[:, :64], g[:, :64])
        _, gd_t, gw_t, _ = run(cm.multislice_db_stored_plain, *sub, fm[:2])
        _, gd_s, gw_s, _ = run(cm.multislice_db_packed, *sub, fm)
        torch.cuda.synchronize()
        t_gd, t_rgd = rel_err(gd_s, gd_t)
        t_gw, t_rgw = rel_err(gw_s, gw_t)
        log(f'K4 {tag} against the truth (K1 plain, autograd, S={S}, N=64):'
            f' gdb max_abs {t_gd:.3e} rel {t_rgd:.3e}; gw max_abs '
            f'{t_gw:.3e} rel {t_rgw:.3e} (tol {tol_bwd})')
        if not (t_rgd < tol_bwd and t_rgw < tol_bwd):
            raise AssertionError('K4 disagrees with the stored truth')
        del gd_t, gw_t, gd_s, gw_s
    mats = cm.prop_mats(h, *fm, route='fft')
    with torch.no_grad():
        # The routes in turns: fft, dense, dense, fft.
        ms_f = time_ms(lambda: cm.MultisliceDb.apply(db, wave, mats, k1,
                                                     1.0), 3)
        dense_f = (time_ms(lambda: cm.MultisliceDb.apply(db, wave, mats_d,
                                                         k1, 1.0), 3)
                   + time_ms(lambda: cm.MultisliceDb.apply(
                       db, wave, mats_d, k1, 1.0), 3)) / 2
        ms_f = (ms_f + time_ms(lambda: cm.MultisliceDb.apply(
            db, wave, mats, k1, 1.0), 3)) / 2
        plain_f = time_ms(lambda: cm.multislice_db_stored_plain(
            db, wave, h, k1, 1.0, *fm[:2]), 2)
    ms_b = time_ms(bwd_k, 3)
    dense_b = (time_ms(bwd_d, 3) + time_ms(bwd_d, 3)) / 2
    ms_b = (ms_b + time_ms(bwd_k, 3)) / 2
    plain_b = time_ms(bwd_p, 2)
    log(f'K4 {tag}: forward fft route {ms_f:.3f} ms, dense route '
        f'{dense_f:.3f} ms; backward fft route {ms_b:.3f} ms, dense route '
        f'{dense_b:.3f} ms; resident blocks an SM {cm.K4_BLOCKS_PER_SM}')
    if not (ms_f < dense_f and ms_b < dense_b):
        raise AssertionError(f'K4 {tag}: the FFT route is not faster than '
                             'the dense route at the flagship shape')
    isz = db.element_size()
    b_f, by_f = bound(cm.bytes_moved(S, M, N, n, n, isz, records=False),
                      cm.flops(S, M, N, n, n))
    b_b, by_b = bound(cm.bytes_moved(S, M, N, n, n, isz, backward=True,
                                     records=False),
                      cm.flops(S, M, N, n, n, backward=True,
                               invertible=True))
    src = 'adorym_tpu_torch/csrc/multislice_db.cu'
    recs = [
        record(f'K4f multislice_db forward ({tag})', src,
               'adorym_tpu/ops/pallas_multislice.py:294', e_fwd, r_fwd,
               tol_fwd, ms_f, plain_f, b_f, by_f, None, 'K4_FWD',
               'multimode'),
        record(f'K4b multislice_db backward ({tag})', src,
               'adorym_tpu/ops/pallas_multislice.py:495', e_bwd, r_bwd,
               max(tol_gd, tol_bwd), ms_b, plain_b, b_b, by_b, None,
               'K4_BWD', 'multimode'),
    ]
    add_dense_route(recs, route, dense_f, dense_b, errs['dense'])
    return recs


def truth_sweep(db, wave, h, k1, s, far):
    """The multislice function of K1 and K4 in complex128, differentiable
    by autograd: the transmission in f64, each step the folded ``P = G
    diag(h) F`` of each axis built in f64 from the f32 transfer function
    upcast (the operator both routes apply, without their roundoff), and
    the exact Fraunhofer pair ``far`` at the last step."""
    from adorym_tpu_torch.ops.fourier import dft_matrix
    dev = db.device
    h = h.to(torch.complex128)

    def mats(n):
        return (torch.from_numpy(dft_matrix(n, dtype=np.complex128)).to(dev),
                torch.from_numpy(dft_matrix(n, inverse=True,
                                            dtype=np.complex128)).to(dev))

    (fy, gy), (fx, gx) = mats(h.shape[0]), mats(h.shape[1])
    py = (gy * (h[:, 0] / h[0, 0])[None, :]) @ fy
    px = (gx * h[0, :][None, :]) @ fx
    w = wave.to(torch.complex128)
    n_steps = db.shape[0]
    for z in range(n_steps):
        d, b = db[z, 0].double(), db[z, 1].double()
        w = w * torch.polar(torch.exp(-k1 * b), -s * k1 * d)
        if z < n_steps - 1:
            w = py @ w @ px.transpose(0, 1)
        else:
            w = far[0] @ w @ far[1].transpose(0, 1)
    return w


def fraunhofer_f64(n, dev):
    """The unnormalised Fraunhofer matrix of one axis (fftshift after the
    DFT) in complex128."""
    from adorym_tpu_torch.ops.fourier import dft_matrix
    shift = np.fft.fftshift(np.eye(n), axes=0)
    return torch.from_numpy(shift @ dft_matrix(n, dtype=np.complex128)).to(
        dev)


def check_truth():
    """Both step routes of K1 and K4 and their plain version (the folded
    complex64 mats, the arithmetic of the JAX package's kernels) against
    the complex128 sweep (:func:`truth_sweep`), forward and gradients, on
    64 patches of 72x72 with the Fraunhofer far field: K4 at the
    multi-mode chunk's depth (S=256 steps of 1 nm, M=3, physical
    absorption), K1 at the delta_beta chunk's (S=32 binned steps of 8 nm,
    M=1).  Errors relative to the truth's largest value; each is held to
    the kernels' tolerances (1e-4 forward, 1e-3 gradients).  Returns
    {kernel: {form: (fwd, gdb, gw)}}."""
    from adorym_tpu_torch.ops import cuda_multislice as cm
    from adorym_tpu_torch.ops import propagate as prop
    dev = torch.device('cuda')
    n, N = 72, 64
    lmbda = 1240.0 / FLAGSHIP['energy_ev']
    voxel = (1.0, 1.0, 1.0)
    k1 = 2 * np.pi * 1.0 / lmbda
    fm = prop.final_prop_mats((n, n), voxel, lmbda, 'inf', device=dev)
    far = (fraunhofer_f64(n, dev),) * 2
    out = {}
    for kernel, S, M, dist, hi, seed in (('K4', 256, 3, 1.0, (1e-3, 1e-4), 5),
                                         ('K1', 32, 1, 8.0, (1e-2, 1e-2), 0)):
        gen = torch.Generator(device=dev).manual_seed(seed)
        db = torch.empty((S, 2, N, n, n), device=dev)
        db[:, 0].uniform_(0, hi[0], generator=gen)
        db[:, 1].uniform_(0, hi[1], generator=gen)
        wave = torch.randn((M, N, n, n), dtype=torch.complex64, device=dev,
                           generator=gen)
        g = torch.randn((M, N, n, n), dtype=torch.complex64, device=dev,
                        generator=gen)
        h = prop.fresnel_kernel((n, n), voxel, lmbda, dist, device=dev)

        def grads(fn, dtype=torch.float32, cdtype=torch.complex64):
            d = db.to(dtype).requires_grad_()
            w = wave.to(cdtype).requires_grad_()
            o = fn(d, w)
            gd, gw = torch.autograd.grad(o, (d, w), g.to(cdtype))
            return o.detach(), gd, gw

        truth = grads(lambda d, w: truth_sweep(d, w, h, k1, 1.0, far),
                      torch.float64, torch.complex128)
        if kernel == 'K4':
            forms = {r: (lambda d, w, m=cm.prop_mats(h, *fm, route=r):
                         cm.MultisliceDb.apply(d, w, m, k1, 1.0))
                     for r in ('fft', 'dense')}
        else:
            forms = {r: (lambda d, w, m=cm.prop_mats(h, *fm[:2], route=r):
                         cm.MultisliceDbStored.apply(d, w, m, k1, 1.0))
                     for r in ('fft', 'dense')}
        forms['plain'] = lambda d, w: cm.multislice_db_stored_plain(
            d, w, h, k1, 1.0, *fm[:2])
        out[kernel] = {}
        for form, fn in forms.items():
            got = grads(fn)
            torch.cuda.synchronize()
            errs = tuple(rel_err(a.to(b.dtype), b)[1]
                         for a, b in zip(got, truth))
            rms = tuple(float((a.to(b.dtype) - b).norm() / b.norm())
                        for a, b in zip(got, truth))
            out[kernel][form] = errs
            log(f'{kernel} (S={S}, M={M}, N={N}) {form} against complex128: '
                f'fwd {errs[0]:.3e} gdb {errs[1]:.3e} gw {errs[2]:.3e} of '
                f'the largest values; rms {rms[0]:.3e} / {rms[1]:.3e} / '
                f'{rms[2]:.3e} of the rms values')
            if not (errs[0] < 1e-4 and max(errs[1:]) < 1e-3):
                raise AssertionError(f'{kernel} {form} disagrees with the '
                                     'complex128 sweep')
            del got
        del truth, db
        torch.cuda.empty_cache()
    out['K5'] = check_truth_fused()
    return out


#: The draws of K5's check against the complex128 sweep (C.2: its largest
#: error is one element of one draw, so the routes are compared by the
#: median over draws).
C2_SEEDS = (8, 9, 10, 11, 12)


def check_truth_fused():
    """Both step routes of K5 and its plain version (cuFFT in complex64)
    against the same sweep in complex128 (``w <- IFFT2(FFT2(w t) H)`` with
    the f32 transmissions and H upcast), forward and gradients, at the
    real_imag chunk's depth: S=32 steps (31 propagations) of 8 nm with the
    non-paraxial H, M=1, on 64 patches of 72x72; the transmissions of a
    delta_beta-like object (t = exp(-k1 b - i k1 d), d and b up to 1e-2).
    Over the draws of :data:`C2_SEEDS`, each form's errors relative to the
    truth's largest value are held to the kernels' tolerances (1e-4
    forward, 1e-3 gradients), and the FFT route's error over the dense
    route's is logged per draw and as the median, whose gt must stay
    within 1.2x (ROADMAP C.2).  Then one step of each
    route (a sweep of two steps through t = 1) against the complex128 step
    on the same 64 planes: the gain bias, which adds up over the steps, and
    the rms error.  Returns {form: (fwd, gt, gw)}, each the median over the
    draws."""
    from adorym_tpu_torch.ops import cuda_multislice_fused as cmf
    from adorym_tpu_torch.ops import propagate as prop
    dev = torch.device('cuda')
    S, M, N, n = 32, 1, 64, 72
    lmbda = 1240.0 / FLAGSHIP['energy_ev']
    k1 = 2 * np.pi * 1.0 / lmbda
    h = prop.fresnel_kernel((n, n), (1.0, 1.0, 1.0), lmbda, 8.0,
                            fresnel_approx=False, device=dev)
    h64 = h.to(torch.complex128)
    forms = {r: (lambda tt, w, m=cmf.step_mats(h, r):
                 cmf.MultisliceFused.apply(tt, w, m))
             for r in ('fft', 'dense')}
    forms['plain'] = lambda tt, w: cmf.multislice_fused_plain(tt, w, h)
    per_seed = {form: [] for form in forms}
    for seed in C2_SEEDS:
        gen = torch.Generator(device=dev).manual_seed(seed)
        db = torch.rand((S, 2, N, n, n), device=dev, generator=gen) * 1e-2
        t = torch.polar(torch.exp(-k1 * db[:, 1]), -k1 * db[:, 0])
        wave = torch.randn((M, N, n, n), dtype=torch.complex64, device=dev,
                           generator=gen)
        g = torch.randn((M, N, n, n), dtype=torch.complex64, device=dev,
                        generator=gen)

        def truth_fn(tt, w):
            for z in range(S - 1):
                w = torch.fft.ifft2(torch.fft.fft2(w * tt[z]) * h64)
            return w * tt[-1]

        def grads(fn, cdtype=torch.complex64):
            tt = t.to(cdtype).requires_grad_()
            w = wave.to(cdtype).requires_grad_()
            o = fn(tt, w)
            gt, gw = torch.autograd.grad(o, (tt, w), g.to(cdtype))
            return o.detach(), gt, gw

        truth = grads(truth_fn, torch.complex128)
        for form, fn in forms.items():
            got = grads(fn)
            torch.cuda.synchronize()
            errs = tuple(rel_err(a.to(b.dtype), b)[1]
                         for a, b in zip(got, truth))
            rms = tuple(float((a.to(b.dtype) - b).norm() / b.norm())
                        for a, b in zip(got, truth))
            per_seed[form].append(errs + rms)
            log(f'K5 (S={S}, M={M}, N={N}, non-paraxial, seed {seed}) {form} '
                f'against complex128: fwd {errs[0]:.3e} gt {errs[1]:.3e} gw '
                f'{errs[2]:.3e} of the largest values; rms {rms[0]:.3e} / '
                f'{rms[1]:.3e} / {rms[2]:.3e} of the rms values')
            if not (errs[0] < 1e-4 and max(errs[1:]) < 1e-3):
                raise AssertionError(f'K5 {form} disagrees with the '
                                     'complex128 sweep')
            del got
        ratio = [a / b for a, b in zip(per_seed['fft'][-1],
                                       per_seed['dense'][-1])]
        log(f'K5 against complex128, seed {seed}: FFT route / dense route '
            'error ' + ' '.join(f'{r:.3f}' for r in ratio)
            + ' (fwd, gt, gw largest; fwd, gt, gw rms)')
        del truth, db, t
    errs = {form: np.array(v) for form, v in per_seed.items()}
    median = np.median(errs['fft'] / errs['dense'], axis=0)
    log(f'K5 against complex128 over seeds {C2_SEEDS}: median FFT route / '
        'dense route error ' + ' '.join(f'{r:.3f}' for r in median)
        + ' (fwd, gt, gw largest; fwd, gt, gw rms)')
    if median[1] > 1.2:
        raise AssertionError('K5: the FFT route\'s gt is more than 1.2x the '
                             'dense route\'s error at the median (C.2)')
    # One step P (forward) and P^T (through the backward) of each route.
    gen = torch.Generator(device=dev).manual_seed(C2_SEEDS[0])
    x = torch.randn((1, N, n, n), dtype=torch.complex64, device=dev,
                    generator=gen)
    ones = torch.ones((2, N, n, n), dtype=torch.complex64, device=dev)
    x64 = x.to(torch.complex128)
    exact = {'P': torch.fft.ifft2(torch.fft.fft2(x64) * h64),
             'PT': torch.fft.fft2(torch.fft.ifft2(x64) * h64)}
    for form, fn in forms.items():
        w = torch.zeros_like(x).requires_grad_()
        step = {'P': fn(ones, x)}
        out = fn(ones, w)
        # JAX's transpose of the step: conj of the gradient of conj(x).
        step['PT'] = torch.autograd.grad(out, w, x.conj())[0].conj()
        for kind, y in step.items():
            y, ref = y.detach().to(torch.complex128), exact[kind]
            gain = complex((ref.conj() * y).sum() / (ref.abs() ** 2).sum()) - 1
            log(f'K5 {form} one step {kind} against complex128: gain bias '
                f'{gain.real:+.3e} rms error '
                f'{float((y - ref).norm() / ref.norm()):.3e}')
    return {form: tuple(np.median(e[:, :3], axis=0))
            for form, e in errs.items()}


def record(name, source, replaces, err, rel, tol, ms, plain_ms, bound_ms,
           bound_by, library_ms, counter, path='delta_beta'):
    """One kernel's entry of the JSON line.  ``ms`` and ``kernel_ms`` are
    the same time; ``rel_err`` (max abs error over the plain version's
    largest value) is what was held against ``tol``.  ``counter`` and
    ``path`` name the launch counter and the flagship run whose launches
    the entry reports; both are dropped before printing."""
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                max_abs_err=err, rel_err=rel, tol=tol, ms=ms, kernel_ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, counter=counter, path=path)


#: K2's shapes: (channels C, z-major, the flagship path that gives the
#: kernel this shape or None, seed).  C = 64 is the delta_beta chunk's
#: binned [32, 2] trailing width, C = 512 the [256, 2] of the real_imag
#: and multi-mode chunks.
K2_CASES = ((64, True, 'delta_beta', 1), (64, False, None, 1),
            (512, False, 'real_imag', 4), (512, True, 'multimode', 6))


def check_grid_scatter(dtype, C, zmajor, path, seed, rows=23, size=260,
                       label=''):
    """K2 against its plain version at one flagship chunk: 529 patch
    cotangents on a 23x23 grid at stride 8 into the padded accumulator
    [260, 260, C/2, 2] (``rows`` x ``rows`` into [``size``, ``size``,
    C/2, 2] where ``label`` names another path's chunk).  z-major: the
    multislice kernel's gradient [C/2, 2, 529, 72, 72] viewed as [529, 72,
    72, C/2, 2], which the kernel reads in
    place (delta_beta, multi-mode); patch-major: contiguous [529, 72, 72,
    C/2, 2] (the layout autograd gives the grid gather's patches on the
    real_imag path; at C = 64 on no path).  The wrapper's instantiation
    (the vector one at every flagship shape) and the scalar one, forced,
    must agree bit for bit (the same sums in the same order); both are
    held to the plain version at 1e-5.  Times: the kernel, its scalar
    instantiation, the plain version and ``F.fold``, one PyTorch call of
    the same overlap-add (channels first, on a pre-permuted f32 input;
    never called by the port)."""
    from adorym_tpu_torch.ops import cuda_scatter_grid as csg
    dev = torch.device('cuda')
    s, n, zb = 8, 72, C // 2
    gen = torch.Generator(device=dev).manual_seed(seed)
    if zmajor:
        cot = torch.randn((zb, 2, rows * rows, n, n), device=dev,
                          generator=gen).to(dtype).permute(2, 3, 4, 0, 1)
        if not csg._channel_major(cot):
            raise AssertionError('K2: the z-major view is not read in place')
    else:
        cot = torch.randn((rows * rows, n, n, zb, 2), device=dev,
                          generator=gen).to(dtype)
    acc0 = torch.randn((size, size, zb, 2), device=dev, generator=gen)
    routes = csg.K2_ROUTE_LAUNCHES
    r0 = dict(routes)
    got = csg.scatter_grid2d_add(acc0.clone(), cot, 0, 0, s, rows)
    took = {r: routes[r] - r0[r] for r in routes}
    inst = 'vec' if took['vec'] else 'scalar'

    def scalar(acc):
        return csg._launch_scatter(acc, cot, 0, 0, s, rows, vec=1)
    got_s = scalar(acc0.clone())
    ref = csg.scatter_grid2d_add_plain(acc0.clone(), cot, 0, 0, s, rows)
    torch.cuda.synchronize()
    tag = str(dtype).split('.')[-1]
    layout = 'z-major' if zmajor else 'patch-major'
    name = f'K2 C={C} {layout}{label} {tag}'
    if took != {'vec': 1, 'scalar': 0}:
        raise AssertionError(f'{name}: instantiations launched {took}, '
                             'expected the vector one')
    equal = torch.equal(got, got_s)
    err, rel = rel_err(got, ref)
    err_s, rel_s = rel_err(got_s, ref)
    del got, got_s, ref
    # Both sum the same f32 values (bf16 upcast exactly), <= 81 terms, in
    # other orders.
    tol = 1e-5
    log(f'{name}: {inst} max_abs {err:.3e} rel {rel:.3e}; scalar max_abs '
        f'{err_s:.3e} rel {rel_s:.3e} (tol {tol}); vec and scalar '
        f'bit-equal: {equal}')
    if not (equal and rel < tol and rel_s < tol):
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             'version or its scalar instantiation')
    acc = acc0.clone()
    reps = 20 if C == 64 else 10
    ms = time_ms(lambda: csg.scatter_grid2d_add(acc, cot, 0, 0, s, rows),
                 reps)
    ms_s = time_ms(lambda: scalar(acc), reps)
    ms = (ms + time_ms(lambda: csg.scatter_grid2d_add(acc, cot, 0, 0, s,
                                                      rows), reps)) / 2
    plain = time_ms(lambda: csg.scatter_grid2d_add_plain(acc, cot, 0, 0, s,
                                                         rows), 3)
    ty, tx = csg.tile_shape(cot.shape, s, rows)
    cols_in = cot.float().reshape(rows * rows, n * n, C).permute(
        2, 1, 0).reshape(1, C * n * n, rows * rows).contiguous()
    lib = time_ms(lambda: torch.nn.functional.fold(
        cols_in, (ty, tx), (n, n), stride=s), reps)
    del cols_in
    b, by = bound(csg.bytes_moved(cot.shape, s, rows, cot.element_size()),
                  float(cot.numel()))
    log(f'{name}: {inst} {ms:.4f} ms, scalar {ms_s:.4f} ms, bound {b:.4f} '
        f'ms ({100 * b / ms:.1f}%), F.fold {lib:.4f} ms')
    rec = record(f'K2 grid_scatter C={C} {layout}{label} ({tag})',
                 'adorym_tpu_torch/csrc/grid_scatter.cu',
                 'adorym_tpu/ops/pallas_scatter_grid.py:44', err, rel, tol,
                 ms, plain, b, by, lib, 'K2', path)
    rec.update(instantiation=inst, scalar_ms=ms_s)
    if path is None:
        rec['launches_note'] = ('no flagship path gives K2 patch-major '
                                'cotangents at C = 64 (delta_beta reads '
                                'the z-major gradient): checked here '
                                'against its plain version only')
    return [rec]


def check_grid_extract(dtype):
    """K3 against its plain version at the real_imag flagship chunk: 529
    patches of [72, 72, 256, 2] on the 23x23 grid at stride 8, gathered
    from the padded object [260, 260, 256, 2] at the origin (0, 0).  A pure
    copy: the two must be equal."""
    from adorym_tpu_torch.ops import cuda_scatter_grid as csg
    dev = torch.device('cuda')
    rows, s, n, nz = 23, 8, 72, 256
    gen = torch.Generator(device=dev).manual_seed(2)
    obj = torch.randn((260, 260, nz, 2), device=dev, generator=gen).to(dtype)
    ty, tx = csg.tile_shape((rows * rows, n, n), s, rows)
    tile = obj[:ty, :tx]
    got = csg.extract_grid2d(obj, 0, 0, s, rows, rows, (n, n))
    ref = csg.grid2d_extract_plain(tile, s, rows, rows, (n, n))
    torch.cuda.synchronize()
    tag = str(dtype).split('.')[-1]
    equal = torch.equal(got, ref)
    err, rel = rel_err(got, ref)
    log(f'K3 {tag}: equal to the plain version: {equal} (max_abs {err:.3e})')
    if not equal:
        raise AssertionError(f'K3 {tag} kernel disagrees with its plain '
                             'version')
    del got, ref
    ms = time_ms(lambda: csg.extract_grid2d(obj, 0, 0, s, rows, rows,
                                            (n, n)), 10)
    plain = time_ms(lambda: csg.grid2d_extract_plain(tile, s, rows, rows,
                                                     (n, n)), 3)
    # One PyTorch call for the same gather, in the same layout: unfold's
    # windows made contiguous.  Timed here only; the port never calls it.
    lib = time_ms(lambda: tile.unfold(0, n, s).unfold(1, n, s).permute(
        0, 1, 4, 5, 2, 3).contiguous(), 10)
    b, by = bound(csg.extract_bytes_moved((rows * rows, n, n, nz, 2), s,
                                          rows, obj.element_size()), 0.0)
    return [record(f'K3 grid_extract ({tag})',
                   'adorym_tpu_torch/csrc/grid_extract.cu',
                   'adorym_tpu/ops/pallas_scatter_grid.py:110', err, rel, 0.0,
                   ms, plain, b, by, lib, 'K3', 'real_imag')]


def fused_inputs(S, M, N, n, seed):
    """K5's operands at one real_imag chunk: transmissions near 1, random
    waves and cotangents, and the non-paraxial transfer function of one
    8-voxel step (not separable)."""
    from adorym_tpu_torch.ops import propagate as prop
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = 1.0 + 0.05 * torch.randn((S, N, n, n), dtype=torch.complex64,
                                 device=dev, generator=gen)
    wave = torch.randn((M, N, n, n), dtype=torch.complex64, device=dev,
                       generator=gen)
    g = torch.randn((M, N, n, n), dtype=torch.complex64, device=dev,
                    generator=gen)
    lmbda = 1240.0 / FLAGSHIP['energy_ev']
    h = prop.fresnel_kernel((n, n), (1.0, 1.0, 1.0), lmbda, 8.0,
                            fresnel_approx=False, device=dev)
    return t, wave, g, h


def check_fused_multislice(tol_fwd, tol_bwd, M=1):
    """K5 forward and backward against the plain version at one real_imag
    flagship chunk: S=32 binned steps, N=529 patches of 72x72, M probe
    modes (1 on the real_imag flagship; 3, which no flagship path runs,
    for the FFT route's cluster mode sum), with the non-paraxial transfer
    function of one 8-voxel step, in f32 (the kernels compute in f32 in
    both storage modes).  The shape takes K5's FFT route (72 = 8 x 9),
    which the main path runs; the dense route (four DFT matmuls a step),
    forced, is held against the same plain version with the same
    tolerances and timed beside it in turns (fft, dense, dense, fft)."""
    from adorym_tpu_torch.ops import cuda_multislice_fused as cmf
    S, N, n = 32, 529, 72
    t, wave, g, h = fused_inputs(S, M, N, n, 3 if M == 1 else 13)

    def run(fn):
        tt = t.detach().requires_grad_()
        w = wave.detach().requires_grad_()
        out = fn(tt, w, h)
        gt, gw = torch.autograd.grad(out, (tt, w), g, retain_graph=True)
        return out, gt, gw, (lambda: torch.autograd.grad(
            out, (tt, w), g, retain_graph=True))

    modes = f' M={M}' if M > 1 else ''
    route = cmf.k5_route(n, n)
    if route != 'fft':
        raise AssertionError(f'K5 takes the {route} route at {n}x{n}')
    r0 = dict(cmf.K5_ROUTE_LAUNCHES)
    out_k, gt_k, gw_k, bwd_k = run(cmf.multislice_fused)
    took = {r: cmf.K5_ROUTE_LAUNCHES[r] - r0[r] for r in r0}
    mats = cmf.step_mats(h, 'fft')
    mats_d = cmf.step_mats(h, 'dense')
    out_d, gt_d, gw_d, bwd_d = run(
        lambda tt, w, _: cmf.MultisliceFused.apply(tt, w, mats_d))
    out_p, gt_p, gw_p, bwd_p = run(cmf.multislice_fused_plain)
    torch.cuda.synchronize()
    if took != {'fft': 2, 'dense': 0, 'global': 0}:
        raise AssertionError(f'K5{modes}: launches by route {took}')
    errs = {}
    for name, (out_r, gt_r, gw_r) in (('fft', (out_k, gt_k, gw_k)),
                                      ('dense', (out_d, gt_d, gw_d))):
        e_fwd, r_fwd = rel_err(out_r, out_p)
        e_gt, r_gt = rel_err(gt_r, gt_p)
        e_gw, r_gw = rel_err(gw_r, gw_p)
        errs[name] = (e_fwd, r_fwd, max(e_gt, e_gw), max(r_gt, r_gw))
        log(f'K5{modes} float32 (non-paraxial H) {name} route: fwd max_abs '
            f'{e_fwd:.3e} rel {r_fwd:.3e} (tol {tol_fwd}); gt max_abs '
            f'{e_gt:.3e} rel {r_gt:.3e}; gw max_abs {e_gw:.3e} rel '
            f'{r_gw:.3e} (tol {tol_bwd})')
        if not (r_fwd < tol_fwd and r_gt < tol_bwd and r_gw < tol_bwd):
            raise AssertionError(f'K5{modes} {name} route disagrees with its '
                                 'plain version')
    e_fwd, r_fwd, e_bwd, r_bwd = errs['fft']
    del out_k, gt_k, gw_k, out_d, gt_d, gw_d, out_p, gt_p, gw_p

    def launch(m):
        # The launch alone: the step table or DFT mats are built once.
        return lambda: cmf.MultisliceFused.apply(t, wave, m)
    with torch.no_grad():
        # The routes in turns: fft, dense, dense, fft.
        ms_f = time_ms(launch(mats), 10)
        dense_f = (time_ms(launch(mats_d), 10)
                   + time_ms(launch(mats_d), 10)) / 2
        ms_f = (ms_f + time_ms(launch(mats), 10)) / 2
        plain_f = time_ms(lambda: cmf.multislice_fused_plain(t, wave, h), 5)
    ms_b = time_ms(bwd_k, 10)
    dense_b = (time_ms(bwd_d, 10) + time_ms(bwd_d, 10)) / 2
    ms_b = (ms_b + time_ms(bwd_k, 10)) / 2
    plain_b = time_ms(bwd_p, 5)
    log(f'K5{modes}: forward fft route {ms_f:.3f} ms, dense route '
        f'{dense_f:.3f} ms; backward fft route {ms_b:.3f} ms, dense route '
        f'{dense_b:.3f} ms')
    if not (ms_f < dense_f and ms_b < dense_b):
        raise AssertionError(f'K5{modes}: the FFT route is not faster than '
                             'the dense route at the flagship shape')
    b_f, by_f = bound(cmf.bytes_moved(S, M, N, n, n),
                      cmf.flops(S, M, N, n, n))
    b_b, by_b = bound(cmf.bytes_moved(S, M, N, n, n, backward=True),
                      cmf.flops(S, M, N, n, n, backward=True))
    src = 'adorym_tpu_torch/csrc/multislice_fused.cu'
    path = 'real_imag' if M == 1 else None
    recs = [
        record(f'K5f multislice_fused forward{modes} (float32)', src,
               'adorym_tpu/ops/pallas_multislice.py:184', e_fwd, r_fwd,
               tol_fwd, ms_f, plain_f, b_f, by_f, None, 'K5_FWD', path),
        record(f'K5b multislice_fused backward{modes} (float32)', src,
               'adorym_tpu/ops/pallas_multislice.py:222', e_bwd, r_bwd,
               tol_bwd, ms_b, plain_b, b_b, by_b, None, 'K5_BWD', path),
    ]
    add_dense_route(recs, route, dense_f, dense_b, errs['dense'])
    if path is None:
        for rec in recs:
            rec['launches_note'] = ('no flagship path runs K5 at three modes '
                                    '(the real_imag flagship has one): '
                                    'checked here against its plain version '
                                    'only')
    return recs


def device_ms(fn, reps):
    """Device time a call of ``fn`` (every kernel and memory operation it
    runs on the card), over ``reps`` calls after a warmup call, without
    the host's pace: torch.profiler's device time, asked twice (it has
    lost a window's events in this script); where it reports none both
    times, CUDA events around the replay of a CUDA graph that captured
    ``reps`` calls; where ``fn`` cannot be captured, CUDA events around
    ``reps`` calls (the host's pace where a call costs more than its
    kernels).  Returns ``(ms, how)``, ``how`` 'profiler', 'graph' or
    'events'."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if str(getattr(e, 'device_type', '')).endswith('CUDA'))
        if total > 0:
            return total / 1e3 / reps, 'profiler'
    log('device_ms: the profiler reported no device time twice; timing a '
        'CUDA graph of the calls instead')
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as e:
        log(f'device_ms: the calls cannot be captured ({e}); timing them '
            'with CUDA events')
        del graph
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, 'events'
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps, 'graph'


def check_k6(name, cot, acc0, rows, path, reps, note=None, in_place=False):
    """K6 at one of its row shapes: ``rows`` grid rows of ``cot``'s
    patches (rows x cols of them), row r at (r * 8, 0) of ``acc0``.
    ``in_place``: each row is a slice of a z-major chunk gradient, which
    K6 must read where it lies (its ``'channel'`` layout, no copy): held
    bit for bit to the copy route too (each row made contiguous, then the
    patch-major kernel), whose call time is ``copy_ms``.  Held three ways:
    to its plain version at 1e-5 (the same f32 values, <= 9 terms, other
    orders), bit for bit to K2's kernel
    at ``rows=1`` (K6's route before it had a kernel of its own, which
    sums in the same order), and bit for bit to its own scalar
    instantiation, forced; the path's vector instantiation must be the one
    launched.  Times, each for the ``rows`` rows: ``ms``, CUDA events
    around a loop of calls (the host's pace where the call costs more than
    the kernel, as in earlier records); ``device_ms``, the device time
    (:func:`device_ms`; ``device_by`` says how each of the three device
    times was taken); the same two for K2's route (``parent_ms``,
    ``parent_device_ms``) and for ``F.fold`` of each row on a pre-permuted
    f32 input (``library_ms``, ``library_device_ms``; never called by the
    port); the scalar instantiation's and the plain version's ``ms``."""
    from adorym_tpu_torch.ops import cuda_scatter_grid as csg
    s, n = 8, cot.shape[1]
    cols = cot.shape[0] // rows
    row_cots = [cot[r * cols:(r + 1) * cols] for r in range(rows)]

    def by_rows(fn):
        def run(acc):
            for r, c in enumerate(row_cots):
                fn(acc, c, r * s, 0, s)
            return acc
        return run

    k6 = by_rows(csg.scatter_rowgrid_add_kernel)
    scalar = by_rows(lambda a, c, y0, x0, s_: csg._launch_rowgrid(
        a, c, y0, x0, s_, vec=1))
    parent = by_rows(lambda a, c, y0, x0, s_: csg.scatter_grid2d_add(
        a, c, y0, x0, s_, 1))
    plain = by_rows(csg.scatter_rowgrid_add)
    routes = csg.K6_ROUTE_LAUNCHES
    r0, l0 = dict(routes), dict(csg.K6_LAYOUT_LAUNCHES)
    got = k6(acc0.clone())
    took = {r: routes[r] - r0[r] for r in routes}
    layouts = {k: v - l0[k] for k, v in csg.K6_LAYOUT_LAUNCHES.items()}
    copy_route = by_rows(lambda a, c, y0, x0, s_:
                         csg.scatter_rowgrid_add_kernel(a, c.contiguous(),
                                                        y0, x0, s_))
    if in_place:
        if layouts != {'channel': rows, 'patch': 0, 'copy': 0}:
            raise AssertionError(f'{name}: layouts {layouts}, expected the '
                                 'rows read in place')
        if not torch.equal(got, copy_route(acc0.clone())):
            raise AssertionError(f'{name}: in place and copied rows differ')
        log(f'{name}: every row read in place ({layouts}), bit-equal to the '
            'copy route')
    equal_s = torch.equal(got, scalar(acc0.clone()))
    equal_p = torch.equal(got, parent(acc0.clone()))
    err, rel = rel_err(got, plain(acc0.clone()))
    torch.cuda.synchronize()
    del got
    tol = 1e-5
    log(f'{name}: max_abs {err:.3e} rel {rel:.3e} (tol {tol}); '
        f'instantiations launched {took}; bit-equal to its scalar '
        f'instantiation {equal_s}, to K2 at rows=1 {equal_p}')
    if took != {'vec': rows, 'scalar': 0}:
        raise AssertionError(f'{name}: instantiations launched {took}, '
                             'expected the vector one')
    if not (rel < tol and equal_s and equal_p):
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             'version, its scalar instantiation or K2')
    acc = acc0.clone()
    ms = time_ms(lambda: k6(acc), reps)
    dev_ms, dev_by = device_ms(lambda: k6(acc), reps)
    ms_s = time_ms(lambda: scalar(acc), reps)
    par_ms = time_ms(lambda: parent(acc), reps)
    par_dev, par_by = device_ms(lambda: parent(acc), reps)
    ms = (ms + time_ms(lambda: k6(acc), reps)) / 2
    copy_ms = time_ms(lambda: copy_route(acc), reps) if in_place else None
    plain_ms = time_ms(lambda: plain(acc), 5)
    tx = (cols - 1) * s + n
    fold_in = [c.float().reshape(cols, n * n, -1).permute(2, 1, 0).reshape(
        1, -1, cols).contiguous() for c in row_cots]

    def fold():
        return [torch.nn.functional.fold(f, (n, tx), (n, n), stride=s)
                for f in fold_in]
    lib = time_ms(fold, reps)
    lib_dev, lib_by = device_ms(fold, reps)
    del fold_in
    b, by = bound(rows * csg.bytes_moved(row_cots[0].shape, s, 1,
                                         cot.element_size()),
                  float(cot.numel()))
    copy_s = '' if copy_ms is None else f'; copy route {copy_ms:.4f}'
    log(f'{name}: ms {ms:.4f} device {dev_ms:.4f} ({dev_by}; scalar '
        f'{ms_s:.4f}{copy_s}); K2 at rows=1 {par_ms:.4f} device '
        f'{par_dev:.4f}; F.fold {lib:.4f} device {lib_dev:.4f}; plain '
        f'{plain_ms:.4f}; bound {b:.5f} ms '
        f'({100 * b / dev_ms:.1f}% of the device time); {CARD}')
    rec = record(name, 'adorym_tpu_torch/csrc/rowgrid_scatter.cu',
                 'adorym_tpu/ops/pallas_scatter_grid.py:193', err, rel, tol,
                 ms, plain_ms, b, by, lib, 'K6', path)
    rec.update(instantiation='vec', scalar_ms=ms_s, device_ms=dev_ms,
               parent_ms=par_ms, parent_device_ms=par_dev,
               library_device_ms=lib_dev,
               device_by=[dev_by, par_by, lib_by])
    if in_place:
        rec.update(layout='channel', copy_ms=copy_ms)
    if note:
        rec['launches_note'] = note
    return [rec]


def check_rowgrid_scatter():
    """K6 at the delta_beta flagship's chunk, one grid row at a time: 23
    rows of 23 patch cotangents [72, 72, 32, 2] (patch-major, so each
    row's patches are contiguous) into the padded accumulator [260, 260,
    32, 2].  No path gives K6 this layout (the immediate path gives it the
    z-major gradient, :func:`check_rowgrid_scatter_zmajor`; phase 8e
    patch-major rows of 2 slices, :func:`check_rowgrid_scatter_sparse`):
    this is its only run."""
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(7)
    cot = torch.randn((529, 72, 72, 32, 2), device=dev, generator=gen)
    acc0 = torch.randn((260, 260, 32, 2), device=dev, generator=gen)
    return check_k6('K6 scatter_rowgrid (float32)', cot, acc0, 23, None, 10,
                    'patch-major rows of 32 binned slices are on no path '
                    '(the immediate path gives K6 the z-major gradient; 8e '
                    'gives it patch-major rows of 2 slices, its own '
                    'record): checked here against its plain version only')


#: The immediate flagship's band: the 23x23 grid's x table padded by 4 on
#: the left (its first column sits at x = -4), so the band accumulator is
#: [72, 256 + 4, *tr].
BAND_X, BAND_PAD = 256, 4


def band_acc(tr, gen):
    return torch.randn((72, BAND_X + BAND_PAD) + tr, device='cuda',
                       generator=gen)


def check_rowgrid_scatter_zmajor(dtype):
    """K6 at the immediate flagship's layout: one grid row of 23 patch
    cotangents, the multislice kernel's z-major gradient [32, 2, 23, 72,
    72] read in place, into the band accumulator [72, 260, 32, 2] at x = 0
    (the row's first window)."""
    from adorym_tpu_torch.ops import cuda_scatter_grid as csg
    gen = torch.Generator(device='cuda').manual_seed(17)
    cot = torch.randn((32, 2, 23, 72, 72), device='cuda',
                      generator=gen).to(dtype).permute(2, 3, 4, 0, 1)
    if not csg._channel_major(cot):
        raise AssertionError('K6: the z-major view is not read in place')
    tag = str(dtype).split('.')[-1]
    return check_k6(f'K6 scatter_rowgrid z-major ({tag})', cot,
                    band_acc((32, 2), gen), 1, 'immediate', 50)


def check_rowgrid_scatter_chunk_rows(dtype):
    """K6 at the per-angle path's chunk row (phase 9d): the whole angle's
    z-major gradient [32, 2, 529, 72, 72] (23 staggered grid rows of 23
    patches in one chunk), each row the slice of 23 patches read in
    place, into the padded accumulator [260, 264, 32, 2]."""
    from adorym_tpu_torch.ops import cuda_scatter_grid as csg
    gen = torch.Generator(device='cuda').manual_seed(47)
    cot = torch.randn((32, 2, 529, 72, 72), device='cuda',
                      generator=gen).to(dtype).permute(2, 3, 4, 0, 1)
    if csg.channel_stride(cot[23:46]) != 529 * 72 * 72:
        raise AssertionError('K6: a chunk row is not channel-major')
    acc0 = torch.randn((260, 264, 32, 2), device='cuda', generator=gen)
    tag = str(dtype).split('.')[-1]
    return check_k6(f'K6 scatter_rowgrid per-angle chunk row ({tag})', cot,
                    acc0, 23, '9d', 10, in_place=True)


def check_rowgrid_scatter_sparse():
    """K6 at phase 8e's layout: one grid row of 23 patch-major cotangents
    [23, 72, 72, 2, 2] (the two sparse slices; the band step extracts
    patch-major there) into the band accumulator [72, 260, 2, 2] at
    x = 0."""
    gen = torch.Generator(device='cuda').manual_seed(27)
    cot = torch.randn((23, 72, 72, 2, 2), device='cuda', generator=gen)
    return check_k6('K6 scatter_rowgrid patch-major 2 slices (float32)', cot,
                    band_acc((2, 2), gen), 1, 'sparse', 50)


def check_rowgrid_scatter_real_imag():
    """K6 at the real_imag immediate band step's row: 23 patch-major
    cotangents [23, 72, 72, 256, 2] (the band is not binned in z on
    real_imag, so C = 512) into the band accumulator [72, 260, 256, 2] at
    x = 0.  That step launches K6 23 times an angle; no phase runs it at
    this width."""
    gen = torch.Generator(device='cuda').manual_seed(37)
    cot = torch.randn((23, 72, 72, 256, 2), device='cuda', generator=gen)
    return check_k6('K6 scatter_rowgrid real_imag band row (float32)', cot,
                    band_acc((256, 2), gen), 1, None, 20,
                    'the real_imag immediate band step launches K6 on this '
                    'row 23 times an angle; no phase runs that step at the '
                    'flagship width')


def check_band_adjoint():
    """The immediate flagship band's exact backward in its two forms: the
    9-tap gather (``rotate_adjoint_taps``, reading the binned accumulator)
    and the transpose through autograd (the bins expanded, then the
    rotation's gathers differentiated, their backward sorting the indices).
    A random band accumulator [72, 256, 32, 2] (the x padding cropped) at
    theta = 0.7 to [72, 256, 256, 2]; the two held to each other at 1e-5 of
    the largest value, and timed in turns (taps, transpose, transpose,
    taps).  Returns {form: ms}."""
    from adorym_tpu_torch.ops import rotate as rot
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(19)
    acc = torch.randn((72, BAND_X + BAND_PAD, 32, 2), device=dev,
                      generator=gen)
    gb = acc[:, BAND_PAD:]
    theta, binning, nz = 0.7, 8, 256

    def taps():
        return rot.rotate_adjoint_taps(gb, theta, binning=binning,
                                       nz_full=nz)

    def transpose():
        full = torch.repeat_interleave(gb, binning, dim=2)[:, :, :nz]
        return rot.rotate_adjoint(full, theta)
    a, b = taps(), transpose()
    torch.cuda.synchronize()
    err, rel = rel_err(a, b)
    tol = 1e-5
    log(f'band adjoint (72 x 256 x 256 x 2, binning 8): taps against the '
        f'autograd transpose max_abs {err:.3e} rel {rel:.3e} (tol {tol})')
    if not rel < tol:
        raise AssertionError('band adjoint: the tap gather and the autograd '
                             'transpose disagree')
    del a, b
    ms = {'taps': time_ms(taps, 10), 'transpose': time_ms(transpose, 10)}
    ms['transpose'] = (ms['transpose'] + time_ms(transpose, 10)) / 2
    ms['taps'] = (ms['taps'] + time_ms(taps, 10)) / 2
    log(f"band adjoint: taps {ms['taps']:.3f} ms, autograd transpose "
        f"{ms['transpose']:.3f} ms")
    return ms


# -- phase 4 -----------------------------------------------------------------

#: The flagship paths: the object's kind, probe modes (refined with the
#: object when more than one), z binning and update scheme of each.  The
#: per-angle paths rotate the object out of the autodiff loop; the
#: immediate one (the reference's default) updates after every grid row
#: with the rotation in the loop, through the band step.
PATHS = {'delta_beta': dict(unknown_type='delta_beta', n_modes=1, binning=8),
         'real_imag': dict(unknown_type='real_imag', n_modes=1, binning=8),
         'multimode': dict(unknown_type='delta_beta', n_modes=3, binning=1),
         'multimode_binned': dict(unknown_type='delta_beta', n_modes=3,
                                  binning=8),
         'immediate': dict(unknown_type='delta_beta', n_modes=1, binning=8,
                           immediate=True),
         # Phase 7b and 7c: the immediate and the per-angle flagship with
         # the per-spot positions refined (and, per angle, the projection
         # offset, which leaves the far field out of K1).
         'immediate_pos': dict(unknown_type='delta_beta', n_modes=1,
                               binning=8, immediate=True,
                               refine=dict(optimize_all_probe_pos=True)),
         'delta_beta_pos': dict(unknown_type='delta_beta', n_modes=1,
                                binning=8,
                                refine=dict(optimize_all_probe_pos=True,
                                            optimize_prj_pos_offset=True))}


def probe_modes(n, n_modes, seed=11):
    """``n_modes`` distinct probe modes ``[n_modes, n, n, 2]``: a Gaussian
    spot at decreasing weights, each with its own noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n] - (n - 1) / 2
    spot = np.exp(-(yy ** 2 + xx ** 2) / (2 * (n / 4) ** 2))
    modes = [np.stack([w * spot + rng.normal(0, 0.02, spot.shape),
                       rng.normal(0, 0.02, spot.shape)], -1)
             for w in (1.0, 0.4, 0.15, 0.06, 0.02)[:n_modes]]
    return np.stack(modes).astype(np.float32)


def flagship_config(bf16, path='delta_beta'):
    import adorym_tpu_torch as pt
    f = FLAGSHIP
    p = PATHS[path]
    return pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(f['n_obj'],) * 3,
                             probe_size=(f['n_probe'],) * 2,
                             energy_ev=f['energy_ev'], psize_cm=f['psize_cm'],
                             free_prop_cm='inf', binning=p['binning']),
        train=pt.TrainConfig(minibatch_size=f['mb'], learning_rate=1e-7,
                             optimizer='adam',
                             rotate_out_of_loop=not p.get('immediate'),
                             update_scheme=('immediate' if p.get('immediate')
                                            else 'per angle'),
                             run_bfloat16=bf16,
                             unknown_type=p['unknown_type'],
                             n_probe_modes=p['n_modes']),
        refine=pt.RefineConfig(optimize_probe=p['n_modes'] > 1,
                               **p.get('refine', {})))


def counters():
    from adorym_tpu_torch.ops import cuda_multislice as cm
    from adorym_tpu_torch.ops import cuda_multislice_fused as cmf
    from adorym_tpu_torch.ops import cuda_scatter_grid as csg
    return {'K1_FWD': cm.K1_FWD, 'K1_BWD': cm.K1_BWD, 'K2': csg.K2,
            'K3': csg.K3, 'K4_FWD': cm.K4_FWD, 'K4_BWD': cm.K4_BWD,
            'K5_FWD': cmf.K5_FWD, 'K5_BWD': cmf.K5_BWD, 'K6': csg.K6}


def route_counters():
    from adorym_tpu_torch.ops import cuda_multislice as cm
    from adorym_tpu_torch.ops import cuda_multislice_fused as cmf
    from adorym_tpu_torch.ops import cuda_scatter_grid as csg
    return {'K1': cm.K1_ROUTE_LAUNCHES, 'K4': cm.K4_ROUTE_LAUNCHES,
            'K5': cmf.K5_ROUTE_LAUNCHES, 'K2': csg.K2_ROUTE_LAUNCHES,
            'K6': csg.K6_ROUTE_LAUNCHES, 'TANGENT': cm.TANGENT_LAUNCHES}


def reset_counts():
    for c in counters().values():
        c.launches = 0
    for routes in route_counters().values():
        for r in routes:
            routes[r] = 0


def launch_counts():
    """Each kernel's launches, K1's, K4's and K5's (forward and backward
    together) by step route as ``K1_FFT``, ``K1_DENSE``, ``K1_GLOBAL``
    and the same for K4 and K5, K2's and K6's by instantiation as
    ``K2_VEC``, ``K2_SCALAR``, ``K6_VEC`` and ``K6_SCALAR``, and the
    multislice tangent's calls from K1's and K5's forward-mode rules as
    ``TANGENT_K1`` and ``TANGENT_K5``."""
    counts = {k: c.launches for k, c in counters().items()}
    for name, routes in route_counters().items():
        counts.update({f'{name}_{r.upper()}': v for r, v in routes.items()})
    return counts


#: The kernels each flagship path launches once per gradient chunk; the
#: others must not launch on it.  A per-angle path's chunk is the whole
#: angle; the immediate path's is one grid row (23 an angle), scattered by
#: K6, which no per-angle path launches; the adhesin configuration's is
#: one pattern (the generic step: K1 alone).  K1, K4 and K5 take their FFT
#: route (K1_FFT, K4_FFT and K5_FFT count the forward and backward
#: launches together), K2 and K6 their vector instantiation.
PATH_KERNELS = {'delta_beta': ('K1_FWD', 'K1_BWD', 'K2', 'K2_VEC', 'K1_FFT'),
                'real_imag': ('K3', 'K5_FWD', 'K5_BWD', 'K2', 'K2_VEC',
                              'K5_FFT'),
                'multimode': ('K4_FWD', 'K4_BWD', 'K2', 'K2_VEC', 'K4_FFT'),
                'multimode_binned': ('K1_FWD', 'K1_BWD', 'K2', 'K2_VEC',
                                     'K1_FFT'),
                'immediate': ('K1_FWD', 'K1_BWD', 'K6', 'K6_VEC', 'K1_FFT'),
                'adhesin': ('K1_FWD', 'K1_BWD', 'K1_FFT')}
PATH_KERNELS['immediate_pos'] = PATH_KERNELS['immediate']
PATH_KERNELS['delta_beta_pos'] = PATH_KERNELS['delta_beta']
#: Gradient chunks an angle, where more than one.
CHUNKS_PER_ANGLE = {'immediate': 23, 'immediate_pos': 23}


def run_flagship(bf16, path='delta_beta', n_timed=3, profile=True):
    """Warmup + timed epochs of the flagship through Reconstructor on the
    card, then (f32, ``profile``) one epoch under the profiler; returns
    (median patterns/s, launches per counter)."""
    import adorym_tpu_torch as pt
    f = FLAGSHIP
    p = PATHS[path]
    pos = flagship_positions()
    rng = np.random.default_rng(0)
    data = rng.random((f['n_theta'], len(pos), f['n_probe'], f['n_probe']),
                      dtype=np.float32)
    theta = np.linspace(0, np.pi, f['n_theta'], endpoint=False)
    obj0 = np.zeros((f['n_obj'],) * 3 + (2,), np.float32)
    if p['unknown_type'] == 'real_imag':
        obj0[..., 0] = 1.0                  # vacuum
    # A refined position needs a probe with structure: a plane wave does
    # not move under a shift.
    probe0 = (probe_modes(f['n_probe'], p['n_modes'])
              if p['n_modes'] > 1 or 'refine' in p else None)
    rec = pt.Reconstructor(flagship_config(bf16, path), data=data,
                           probe_pos=pos, theta_ls=theta, obj_init=obj0,
                           probe_init=probe0)
    del obj0
    if rec.device.type != 'cuda':
        raise AssertionError('flagship: not on CUDA')
    if p.get('immediate') and rec._rowgrid_stride != 8:
        raise AssertionError('immediate flagship: not the band step')
    from adorym_tpu_torch.models import ptychography
    if (p.get('refine', {}).get('optimize_prj_pos_offset')
            and not ptychography.unfolded_far_field(rec.cfg)):
        raise AssertionError('flagship: the far field is folded')
    if not p.get('immediate') and rec._grid_scatter_rows != 23:
        raise AssertionError('flagship: not one whole-angle chunk')
    tag = f"{path} {'bf16' if bf16 else 'f32'}"
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    losses = [rec.run_epoch(0)]
    warm = time.perf_counter() - t0
    walls = []
    for ep in range(1, 1 + n_timed):
        t0 = time.perf_counter()
        losses.append(rec.run_epoch(ep))     # ends in a device->host fetch
        walls.append(time.perf_counter() - t0)
    launches = launch_counts()
    n_epochs = 1 + n_timed
    patterns = f['n_theta'] * len(pos)
    rates = [patterns / w for w in walls]
    log(f'flagship {tag}: losses {losses}; warmup {warm:.3f} s; epoch walls '
        f'{[round(w, 4) for w in walls]} s; patterns/s {rates}; median '
        f'{statistics.median(rates):.1f}; peak memory '
        f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; '
        f'launches {launches}')
    if not all(np.isfinite(losses)):
        raise AssertionError(f'flagship {tag}: non-finite loss {losses}')
    want = n_epochs * f['n_theta'] * CHUNKS_PER_ANGLE.get(path, 1)
    expect = {k: want if k in PATH_KERNELS[path] else 0 for k in launches}
    for k in ('K1_FFT', 'K4_FFT', 'K5_FFT'):
        expect[k] *= 2                       # forward and backward
    if launches != expect:
        raise AssertionError(f'flagship {tag}: launches {launches}, '
                             f'expected {expect}')
    if 'probe_pos_correction' in rec.params:
        ppc = rec.params['probe_pos_correction']
        log(f'flagship {tag}: refined positions {tuple(ppc.shape)}, largest '
            f'{float(ppc.abs().max()):.3e} px, mean '
            f'{float(ppc.mean()):.1e}')
    if not bf16 and profile:
        ops = profile_epoch(rec, n_epochs)
        # The real_imag z binning is one autograd Function: no product
        # backward or cumulative product runs on the device.
        glue = sorted(ops & {'ProdBackward0', 'aten::cumprod'})
        if path == 'real_imag' and glue:
            raise AssertionError(f'flagship {tag}: the z binning ran {glue}')
    del rec
    torch.cuda.empty_cache()
    return statistics.median(rates), launches


def profile_epoch(rec, i_epoch):
    return profile_call(lambda: rec.run_epoch(i_epoch), 'epoch')[0]


def profile_call(fn, what):
    """Run ``fn`` (which ends in a device-to-host fetch) under
    torch.profiler, print its device time by kernel, the glue ops and the
    host's waits, and return ``(the ops that ran on the device, the
    device-busy share of the wall time)``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()       # slow on a long trace: once
    events = [e for e in averages
              if getattr(e, 'device_type', None) is not None
              and str(e.device_type).endswith('CUDA')]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f'profile: {what} wall {wall * 1e3:.2f} ms, device busy {busy:.2f} '
        f'ms ({100 * busy / (wall * 1e3):.1f}%)')
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        log(f'  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x '
            f'{e.key[:90]}')
    # Device time under the autograd nodes and the forward ops of the glue
    # around the kernels (for real_imag: the z binning's product, its
    # zero-safe backward, the channel selects); nested ops count in both.
    ops = [e for e in averages
           if (e.key.endswith(('Backward0', 'Backward1', 'Backward'))
               or e.key in ('aten::prod', 'aten::copy_', 'aten::contiguous',
                            'aten::reshape', 'aten::complex', 'aten::mul',
                            'aten::add_', 'aten::fill_', 'aten::eq',
                            'aten::sum', 'aten::cumprod', 'aten::flip',
                            'aten::cat', 'aten::index'))
           and e.device_time_total >= 1e3]
    for e in sorted(ops, key=lambda e: -e.device_time_total):
        log(f'  op {e.key}: device {e.device_time_total / 1e3:8.3f} ms '
            f'host {e.cpu_time_total / 1e3:8.3f} ms {e.count:5d}x')
    # Host-side waits and copies: each blocking host-to-device copy drains
    # the stream, so the device idles until the host queues more work.
    for e in averages:
        if any(w in e.key for w in ('Memcpy', 'memcpy', 'Synchronize')):
            log(f'  host {e.cpu_time_total / 1e3:9.3f} ms device '
                f'{e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x '
                f'{e.key[:80]}')
    # The host's own time by op (self time, outside its children): where
    # the gaps between the device's work come from.
    for e in sorted(averages,
                    key=lambda e: -e.self_cpu_time_total)[:12]:
        log(f'  host self {e.self_cpu_time_total / 1e3:9.3f} ms '
            f'{e.count:6d}x {e.key[:80]}')
    return ({e.key for e in averages if e.device_time_total > 0},
            busy / (wall * 1e3))


# -- phase 5 -----------------------------------------------------------------

def small_support(shape):
    """A support cylinder along y (the rotation axis) of radius 0.4 of the
    object's width; in 2D a disk."""
    y, x, z = shape
    if z == 1:
        yy, xx = np.mgrid[:y, :x] - (np.array([y, x]) - 1)[:, None, None] / 2
        return (yy ** 2 + xx ** 2 <= (0.4 * min(y, x)) ** 2)[..., None].astype(
            np.float32)
    xx, zz = np.mgrid[:x, :z] - (np.array([x, z]) - 1)[:, None, None] / 2
    disk = xx ** 2 + zz ** 2 <= (0.4 * min(x, z)) ** 2
    return np.broadcast_to(disk[None], shape).astype(np.float32)


def small_config_agrees(unknown_type='delta_beta', fresnel_approx=True,
                        free_prop_cm='inf', expect=None, n_modes=1,
                        binning=2, lr=1e-3, force_invertible=False,
                        immediate=False, jitter=False, regs=False,
                        two_d=False):
    """32^3 object, 3 angles, a 4x4 grid of 16^2 patterns, GD: 2 epochs on
    CUDA (kernels) and on the CPU (plain FFT path).  A real_imag object
    starts near vacuum.  With ``n_modes`` > 1 the distinct probe modes are
    refined too, and ``force_invertible`` sets the stored/invertible
    switch so that both runs take K4.  ``immediate``: the immediate scheme
    (one update a grid row) with the rotation in the loop, through the band
    step, or with ``jitter`` (the grid's positions moved by up to 2 pixels,
    so no longer grid rows) through the generic step.  ``regs``: TV and
    reweighted L1 (plain L1 for real_imag, whose reweighted form squares
    weights of 1/|imag| and diverges), a support cylinder and shrink-wrap
    every 4 batches (2 in 2D).  ``two_d``: a 32x32 object of one slice in
    2D mode, one angle (the generic step with nothing rotated; one slice,
    so no kernel).  ``expect`` maps launch counters to the launches the two runs
    must make (the CPU run makes none)."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.ops import propagate as prop
    rng = np.random.default_rng(0)
    xs = np.arange(4) * 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    if jitter:
        pos += np.random.default_rng(1).integers(-2, 3, pos.shape)
    n_theta = 1 if two_d else 3
    data = rng.random((n_theta, 16, 16, 16)).astype(np.float32)
    theta = np.linspace(0, np.pi, n_theta, endpoint=False)
    size = (32, 32, 1) if two_d else (32, 32, 32)
    obj0 = (rng.random(size + (2,)) * 1e-3).astype(np.float32)
    if unknown_type == 'real_imag':
        obj0[..., 0] += 1.0
    loss = {}
    mask = None
    if regs:
        loss = dict(gamma=1e-2, alpha_d=1e-2, alpha_b=1e-3,
                    reweighted_l1=unknown_type == 'delta_beta')
        mask = small_support(size)
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=size, probe_size=(16, 16),
                             energy_ev=5000., psize_cm=1e-7,
                             free_prop_cm=free_prop_cm,
                             binning=1 if two_d else binning,
                             fresnel_approx=fresnel_approx,
                             two_d_mode=two_d),
        loss=pt.LossConfig(**loss),
        train=pt.TrainConfig(minibatch_size=4, learning_rate=lr,
                             optimizer='gd', rotate_out_of_loop=not immediate,
                             update_scheme=('immediate' if immediate
                                            else 'per angle'),
                             unknown_type=unknown_type,
                             n_probe_modes=n_modes,
                             shrink_cycle=((2 if two_d else 4) if regs
                                           else None),
                             shrink_threshold=(
                                 0.9 if unknown_type == 'real_imag'
                                 else 3e-4)),
        refine=pt.RefineConfig(optimize_probe=n_modes > 1,
                               probe_optimizer='gd',
                               probe_learning_rate=1e-2))
    probe0 = probe_modes(16, n_modes) if n_modes > 1 else None
    out = {}
    reset_counts()
    switch = prop._db_stored_max_bytes
    if force_invertible:
        prop._db_stored_max_bytes = lambda device: -1.0
    try:
        for dev in ('cuda', 'cpu'):
            rec = pt.Reconstructor(cfg, data=data, probe_pos=pos,
                                   theta_ls=theta, obj_init=obj0.copy(),
                                   probe_init=probe0, device=dev,
                                   finite_support_mask=mask)
            out[dev] = [rec.run_epoch(e) for e in range(2)]
            if regs and unknown_type == 'delta_beta':
                kept = float(rec.finite_support_mask.sum())
                if not kept < mask.sum():
                    raise AssertionError('small run: the support did not '
                                         'shrink')
    finally:
        prop._db_stored_max_bytes = switch
    launches = launch_counts()
    name = (f'small {unknown_type} fresnel_approx={fresnel_approx} '
            f'free_prop_cm={free_prop_cm} modes={n_modes} '
            f'binning={binning} invertible={force_invertible} '
            f'immediate={immediate} jitter={jitter} regs={regs} '
            f'two_d={two_d}')
    if expect and any(launches[k] != v for k, v in expect.items()):
        raise AssertionError(f'{name}: launches {launches}, expected '
                             f'{expect}')
    # Kernels (DFT matmuls) vs the CPU's FFTs: f32 noise only.
    tol = 1e-4
    rel = np.max(np.abs(np.subtract(out['cuda'], out['cpu']))
                 / np.abs(out['cpu']))
    log(f'{name}: losses cuda {out["cuda"]} cpu {out["cpu"]} rel {rel:.3e} '
        f'(tol {tol}); launches {launches}')
    if not rel < tol:
        raise AssertionError(f'{name}: CUDA and CPU losses disagree')


# -- phase 6 -----------------------------------------------------------------

#: The adhesin demo's reconstruction (``demos/multislice_tomography_64.py``,
#: the reference's CI configuration) as ``reconstruct_ptychography``
#: keywords; 36 angles of one 64x64 pattern.
ADHESIN = dict(obj_size=(64, 64, 64), learning_rate=5e-6,
               alpha_d=1e-9 * 64 ** 3, alpha_b=1e-10 * 64 ** 3,
               reweighted_l1=True, energy_ev=800, psize_cm=0.67e-7,
               minibatch_size=1, free_prop_cm=0, probe_type='plane',
               probe_pos=[(0, 0)], optimizer='adam', use_checkpoint=False)
#: The demo's docstring: phantom delta correlation after 10 epochs of the
#: JAX package on the CPU.
ADHESIN_DOC_CORR = 0.46


def adhesin_phantom():
    """The adhesin demo's phantom (``make_phantom`` of
    ``demos/multislice_tomography_64.py``): six Gaussian blobs, delta up
    to 1e-3, beta up to 3e-5."""
    n = 64
    rng = np.random.default_rng(0)
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(np.float32)
    vol = np.zeros((n, n, n), np.float32)
    for _ in range(6):
        c = rng.uniform(0.3 * n, 0.7 * n, 3)
        r = rng.uniform(0.06 * n, 0.16 * n)
        vol += np.exp(-(((zz - c[0]) ** 2 + (yy - c[1]) ** 2
                         + (xx - c[2]) ** 2) / (2 * r ** 2)))
    vol /= vol.max()
    return np.stack([vol * 1e-3, vol * 3e-5], -1).astype(np.float32)


def flagship_regularized_config(path, n_epochs=3, **io):
    """The f32 flagship of ``path`` ('immediate' or 'delta_beta') with the
    adhesin demo's regularizers scaled to the object (reweighted L1,
    alpha_d = 1e-9 N^3 and alpha_b = 1e-10 N^3 with N = 256, and the
    reference API's default TV weight 1e-6), shrink-wrap every 10 batches,
    ``n_epochs`` epochs and the given IO settings."""
    import dataclasses
    import adorym_tpu_torch as pt
    cfg = flagship_config(False, path)
    n = FLAGSHIP['n_obj']
    return cfg.replace(
        loss=pt.LossConfig(alpha_d=1e-9 * n ** 3, alpha_b=1e-10 * n ** 3,
                           gamma=1e-6, reweighted_l1=True),
        train=dataclasses.replace(cfg.train, n_epochs=n_epochs,
                                  shrink_cycle=10),
        io=pt.IOConfig(**io))


def flagship_inputs():
    """The flagship's scan, random data (``bench.py``'s), angles, the
    reference's default initial object (Gaussian-random delta and beta,
    seed 0) and a support cylinder along y of radius 0.45 N."""
    from adorym_tpu_torch.utils.initialize import initialize_object
    f = FLAGSHIP
    pos = flagship_positions()
    rng = np.random.default_rng(0)
    data = rng.random((f['n_theta'], len(pos), f['n_probe'], f['n_probe']),
                      dtype=np.float32)
    theta = np.linspace(0, np.pi, f['n_theta'], endpoint=False)
    n = f['n_obj']
    xx, zz = np.mgrid[:n, :n] - (n - 1) / 2
    mask = np.broadcast_to((xx ** 2 + zz ** 2 <= (0.45 * n) ** 2)[None],
                           (n, n, n)).astype(np.float32)
    return dict(data=data, probe_pos=pos, theta_ls=theta,
                obj_init=initialize_object((n,) * 3, seed=0),
                finite_support_mask=mask)


def expect_launches(launches, path, want, tag):
    expect = {k: want if k in PATH_KERNELS[path] else 0 for k in launches}
    for k in ('K1_FFT', 'K4_FFT', 'K5_FFT'):
        expect[k] *= 2                       # forward and backward
    if launches != expect:
        raise AssertionError(f'{tag}: launches {launches}, expected '
                             f'{expect}')


def run_immediate_api(work):
    """Phase 6a: the immediate flagship with regularizers, support,
    shrink-wrap, an output folder and checkpoints at the reference's
    default cadence (every 10 batches: 9 an epoch of 92, and the final
    one), through ``Reconstructor.run()``: a warmup and a timed epoch.
    The folder's state after epoch 0's last mid-epoch checkpoint (the next
    batch 90) is copied, as a run killed there would leave it; a new
    Reconstructor resumes from the copy without checkpoints and must end
    where the uninterrupted run ends (losses at rtol 1e-5, the object to
    1e-5 of its largest entry); its whole epoch is the epoch wall without
    checkpoints.  Returns {metric: value}."""
    import shutil
    import adorym_tpu_torch as pt
    f = FLAGSHIP
    kw = flagship_inputs()
    a_dir, b_dir = work / 'imm_a', work / 'imm_b'
    cfg = flagship_regularized_config(
        'immediate', n_epochs=2, store_checkpoint=True, use_checkpoint=False,
        n_batch_per_checkpoint=10)
    rec = pt.Reconstructor(cfg, output_folder=str(a_dir), **kw)
    if rec.device.type != 'cuda' or not rec._band:
        raise AssertionError('6a: not the band step on CUDA')

    def copy_mid_epoch(i_epoch, i_batch, loss):
        if (i_epoch, i_batch) == (0, 0):
            shutil.copytree(a_dir / 'checkpoint', b_dir / 'checkpoint')
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = rec.run(callback=copy_mid_epoch)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    walls = rec.epoch_seconds
    patterns = f['n_theta'] * len(kw['probe_pos'])
    ckpt_s = rec._ckpt_seconds / rec._ckpt_count
    log(f'6a immediate flagship + regularizers + support + checkpoints, '
        f'run(): losses {list(res["loss_history"])}; epoch walls '
        f'{[round(w, 4) for w in walls]} s (warmup first); patterns/s '
        f'{[patterns / w for w in walls[1:]]}; checkpoints '
        f'{rec._ckpt_count} in {rec._ckpt_seconds:.3f} s ({ckpt_s:.3f} s '
        f'each); peak memory {peak:.2f} GB; launches {launches}')
    if not np.all(np.isfinite(res['loss_history'])):
        raise AssertionError('6a: non-finite loss')
    expect_launches(launches, 'immediate', 2 * f['n_theta'] * 23, '6a')
    names = {str(p.relative_to(a_dir)) for p in a_dir.rglob('*')
             if p.is_file()}
    want = {'summary.txt', 'convergence/loss_rank_0.txt', 'delta_ds_1.tiff',
            'beta_ds_1.tiff', 'probe_mag_ds_1.tiff', 'probe_phase_ds_1.tiff',
            'checkpoint/checkpoint.npz'}
    if names != want:
        raise AssertionError(f'6a: output tree {sorted(names)}')
    kept = float(rec.finite_support_mask.sum()) / kw[
        'finite_support_mask'].sum()
    ref_obj, ref_losses = rec.obj, rec.loss_history
    del rec
    torch.cuda.empty_cache()

    cfg_b = cfg.replace(io=pt.IOConfig(store_checkpoint=False,
                                       use_checkpoint=True))
    rec = pt.Reconstructor(cfg_b, output_folder=str(b_dir), **kw)
    if (rec._start_epoch, rec._start_batch) != (0, 90):
        raise AssertionError('6a: the copied checkpoint is not (0, 90)')
    rec.run()
    walls_b = rec.epoch_seconds[1:]
    obj_err = float(np.max(np.abs(rec.obj - ref_obj))
                    / np.max(np.abs(ref_obj)))
    loss_err = float(np.max(np.abs(np.subtract(rec.loss_history[1:],
                                               ref_losses[1:]))
                            / np.abs(ref_losses[1:])))
    rows = {}
    for d in (a_dir, b_dir):
        r = np.genfromtxt(d / 'convergence' / 'loss_rank_0.txt',
                          delimiter=',', names=True)
        rows[d] = {(int(e), int(b)): l for e, b, l in
                   zip(r['i_epoch'], r['i_batch'], r['loss'])}
    common = sorted(rows[b_dir])
    batch_err = max(abs(rows[b_dir][k] - rows[a_dir][k]) / abs(rows[a_dir][k])
                    for k in common)
    log(f'6a resume from (0, 90): losses {rec.loss_history} against '
        f'{ref_losses}; rel {loss_err:.3e}, per batch over {len(common)} '
        f'batches {batch_err:.3e}, object {obj_err:.3e} (tol 1e-5); '
        f'epoch walls without checkpoints {[round(w, 4) for w in walls_b]} '
        f's, patterns/s {[patterns / w for w in walls_b]}; support kept '
        f'{kept:.4f}')
    if not (loss_err < 1e-5 and batch_err < 1e-5 and obj_err < 1e-5):
        raise AssertionError('6a: the resumed run does not end where the '
                             'uninterrupted one ends')
    # The regularizers' share: their value and gradient on the whole
    # object (each batch) and the weights' refresh (every 10), by events;
    # then one epoch without checkpoints under the profiler.
    obj = rec.params['obj']
    reg_ms = time_ms(lambda: rec._reg_value_and_grad(obj), 10)
    wl1_ms = time_ms(lambda: rec._weight_l1_refresh(obj), 10)
    log(f'6a regularizers on the 256^3 object: value and gradient '
        f'{reg_ms:.3f} ms a batch, reweighted-L1 weights {wl1_ms:.3f} ms '
        f'every 10 batches')
    profile_epoch(rec, 2)
    del rec, obj
    torch.cuda.empty_cache()
    return {'patterns_s': [patterns / w for w in walls[1:]],
            'patterns_s_no_ckpt': [patterns / w for w in walls_b],
            'ckpt_s': ckpt_s, 'peak_gb': peak, 'launches': launches,
            'reg_ms': reg_ms}


def run_adhesin(work):
    """Phase 6b: the adhesin demo's reconstruction through
    ``reconstruct_ptychography``, 3 epochs on CUDA and then on the CPU,
    and once more on the CPU from a start perturbed by 1e-7 (relative, in
    delta): the CPU's own spread.  The data come from the in-repo file
    where ``h5py`` imports, else (an earlier line says so) from the port's
    ``simulate`` of the demo's phantom on the card, handed over as an
    ``ArrayDataset``.  The minibatch of 1 takes the generic step: K1 at
    one patch of 64x64 through 64 unfolded steps, 36 an epoch.

    The loss is the square of a difference of magnitudes near 1, so an
    f32 difference in the forward (K1's FFT route against the host's FFT
    scan, phase 3) moves it by about 2 eps / |pred - meas|, and Adam with
    reweighted L1 steps entries near zero on the sign of f32 noise from
    there on.  Held: the first epoch's losses within 1e-2 and the
    phantom correlations within 5e-3; every epoch's difference is
    printed beside the CPU's own spread.  Returns the CUDA run's
    launches."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.io import data as io_data
    from adorym_tpu_torch.utils.initialize import initialize_probe
    root = Path(__file__).resolve().parent
    fname = 'data_adhesin_64_theta_36.h5'
    phantom = adhesin_phantom()
    try:
        import h5py  # noqa: F401
        save_path, dataset = str(root / 'demos' / 'adhesin'), None
        log('6b: the in-repo adhesin file, read with h5py')
    except ImportError:
        theta = np.linspace(0, 2 * np.pi, 36, endpoint=False)
        cfg = pt.ReconConfig(geometry=pt.Geometry(
            obj_size=(64, 64, 64), probe_size=(64, 64), energy_ev=800.0,
            psize_cm=0.67e-7, free_prop_cm=None))
        data = pt.simulate(cfg, phantom, initialize_probe((64, 64), 'plane'),
                           np.array([[0.0, 0.0]]), theta)
        dataset = io_data.ArrayDataset(
            data, theta=theta, probe_pos_px=np.array([[0.0, 0.0]]),
            energy_ev=800.0, psize_cm=0.67e-7)
        save_path = str(work)
        log('6b: h5py does not import here; the adhesin data are the '
            "port's simulate of the demo's phantom on the card (the file "
            'itself is read by the CPU tests only), as an ArrayDataset')
    from adorym_tpu_torch.utils.initialize import initialize_object
    start = initialize_object((64, 64, 64), seed=0)
    perturbed = (start[..., 0] * np.float32(1 + 1e-7), start[..., 1])
    out, corr = {}, {}
    for run, dev, guess in (('cuda', 'cuda', None), ('cpu', 'cpu', None),
                            ('cpu perturbed', 'cpu', perturbed)):
        reset_counts()
        t0 = time.perf_counter()
        res = pt.reconstruct_ptychography(
            fname=fname, save_path=save_path,
            output_folder=str(work / f'adhesin_{run.replace(" ", "_")}'),
            n_epochs=3, save_stdout=run != 'cpu perturbed', device=dev,
            dataset=dataset, initial_guess=guess, **ADHESIN)
        wall = time.perf_counter() - t0
        if dev == 'cuda':
            launches = launch_counts()
        corr[run] = float(np.corrcoef(res['obj'][..., 0].ravel(),
                                      phantom[..., 0].ravel())[0, 1])
        out[run] = res['loss_history']
        log(f'6b adhesin on {run}: loss history '
            f'{list(res["loss_history"])}; phantom delta correlation '
            f'{corr[run]:.4f} after 3 epochs (the demo\'s docstring: '
            f'{ADHESIN_DOC_CORR} after 10, JAX package on the CPU); call '
            f'wall {wall:.2f} s')
    rel = np.abs(out['cuda'] - out['cpu']) / np.abs(out['cpu'])
    own = np.abs(out['cpu perturbed'] - out['cpu']) / np.abs(out['cpu'])
    d_corr = abs(corr['cuda'] - corr['cpu'])
    log(f'6b adhesin: cuda against cpu per-epoch losses rel {list(rel)} '
        f'(first epoch tol 1e-2); the CPU against itself from a start '
        f'1e-7 away {list(own)}; phantom correlation difference '
        f'{d_corr:.2e} (tol 5e-3); launches {launches}')
    expect_launches(launches, 'adhesin', 3 * 36, '6b')
    if not (rel[0] < 1e-2 and d_corr < 5e-3):
        raise AssertionError('6b: CUDA and CPU runs disagree')
    return launches


def run_per_angle_regularized():
    """Phase 6c: the per-angle delta_beta flagship, f32, with the same
    regularizers, support and shrink-wrap (the fused rotate-back is off:
    the binned gradient expands by repeat before the rotate-back): a
    warmup and 2 timed epochs.  Returns (median patterns/s, peak GB)."""
    import adorym_tpu_torch as pt
    f = FLAGSHIP
    kw = flagship_inputs()
    rec = pt.Reconstructor(flagship_regularized_config('delta_beta'), **kw)
    if rec._grid_scatter_rows != 23 or rec.device.type != 'cuda':
        raise AssertionError('6c: not one whole-angle chunk on CUDA')
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = [rec.run_epoch(0)]
    walls = []
    for ep in (1, 2):
        t0 = time.perf_counter()
        losses.append(rec.run_epoch(ep))
        walls.append(time.perf_counter() - t0)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    rates = [f['n_theta'] * len(kw['probe_pos']) / w for w in walls]
    log(f'6c per-angle flagship + regularizers + support: losses {losses}; '
        f'epoch walls {[round(w, 4) for w in walls]} s; patterns/s {rates};'
        f' peak memory {peak:.2f} GB; launches {launches}')
    if not np.all(np.isfinite(losses)):
        raise AssertionError('6c: non-finite loss')
    expect_launches(launches, 'delta_beta', 3 * f['n_theta'], '6c')
    # The rotate-back with the regularizers (the binned gradient expanded
    # by repeat, then rotated) against the fused gather without them, at
    # the flagship's [256, 256, 32, 2] binned gradient; and the
    # regularizers on the rotated object.
    from adorym_tpu_torch.ops.rotate import (rotate,
                                             rotate_expanded_from_binned_z)
    gen = torch.Generator(device='cuda').manual_seed(29)
    n = f['n_obj']
    g = torch.randn((n, n, n // 8, 2), device='cuda', generator=gen)

    def expanded():
        return rotate(torch.repeat_interleave(g, 8, dim=2)[:, :, :n], -0.7)

    def fused():
        return rotate_expanded_from_binned_z(g, -0.7, 8, n)
    ms = {'repeat + rotate': time_ms(expanded, 10),
          'fused gather': time_ms(fused, 10)}
    ms['repeat + rotate'] = (ms['repeat + rotate'] + time_ms(expanded,
                                                             10)) / 2
    reg_ms = time_ms(lambda: rec._reg_value_and_grad(rec.params['obj']), 10)
    log(f"6c rotate-back of the binned gradient: repeat + rotate "
        f"{ms['repeat + rotate']:.3f} ms, fused gather "
        f"{ms['fused gather']:.3f} ms; regularizers on the rotated object "
        f"{reg_ms:.3f} ms an angle")
    del rec, g
    torch.cuda.empty_cache()
    return statistics.median(rates), peak



def check_per_spot_multislice(N, folded):
    """K1f/K1b with distinct per-spot waves, as position refinement makes
    them: the waves come from ``models.ptychography.shifted_probes`` (the
    probe's spectrum times each spot's phase ramp), so the wave gradient
    flows on into the probe and each spot's shift.  N=23 with the far field
    folded in (the immediate path with positions, 7b) or N=529 with it left
    out (the per-angle path with the projection offset, 7c).  Kernel and
    plain version held on the real leaves (db, the probe's [.., 2] pairs,
    the shifts) at K1's tolerances; the launch timed alone at the shape."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.models import ptychography as pm
    from adorym_tpu_torch.ops import cuda_multislice as cm
    from adorym_tpu_torch.ops import propagate as prop
    S, n = 32, 72
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(40 + N + folded)
    db = torch.rand((S, 2, N, n, n), device=dev, generator=gen) * 0.01
    probe = torch.from_numpy(probe_modes(n, 1)).to(dev)
    shifts = (torch.rand((1, N, 2), device=dev, generator=gen) - 0.5) * 3
    g = torch.randn((1, N, n, n), dtype=torch.complex64, device=dev,
                    generator=gen)
    cfg = pt.ReconConfig(geometry=pt.Geometry(obj_size=(n, n, S),
                                              probe_size=(n, n)),
                         refine=pt.RefineConfig(optimize_all_probe_pos=True))
    batch = {'i_theta': 0, 'ind_batch': np.arange(N)}
    lmbda = 1240.0 / FLAGSHIP['energy_ev']
    voxel = (1.0, 1.0, 1.0)
    k1 = 2 * np.pi * 1.0 / lmbda
    h = prop.fresnel_kernel((n, n), voxel, lmbda, 8.0, device=dev)
    far = (prop.final_prop_mats((n, n), voxel, lmbda, 'inf', device=dev)[:2]
           if folded else ())

    def run(fn):
        d = db.detach().requires_grad_()
        p = probe.detach().requires_grad_()
        s = shifts.detach().requires_grad_()
        wave = pm.shifted_probes(pm.complex_probe(p),
                                 {'probe_pos_correction': s}, batch,
                                 cfg).transpose(0, 1)
        out = fn(d, wave, h, k1, 1.0, *far)
        return (out,) + torch.autograd.grad(out, (d, p, s), g)

    r0 = dict(cm.K1_ROUTE_LAUNCHES)
    got_k = run(cm.multislice_db_stored_packed)
    took = {r: cm.K1_ROUTE_LAUNCHES[r] - r0[r] for r in r0}
    got_p = run(cm.multislice_db_stored_plain)
    torch.cuda.synchronize()
    if took != {'fft': 2, 'dense': 0, 'global': 0}:
        raise AssertionError(f'K1 per-spot N={N}: launches by route {took}')
    errs = [rel_err(a, b) for a, b in zip(got_k, got_p)]
    tag = f" per-spot waves N={N}{' far field folded' if folded else ''}"
    tol_fwd, tol_bwd = 1e-4, 1e-3
    log(f'K1{tag} float32: fwd rel {errs[0][1]:.3e} (tol {tol_fwd}); gdb rel '
        f'{errs[1][1]:.3e}, probe gradient rel {errs[2][1]:.3e}, shift '
        f'gradient rel {errs[3][1]:.3e} (tol {tol_bwd})')
    if not (errs[0][1] < tol_fwd
            and max(e[1] for e in errs[1:]) < tol_bwd):
        raise AssertionError(f'K1{tag} disagrees with its plain version')
    with torch.no_grad():
        wave = pm.shifted_probes(pm.complex_probe(probe),
                                 {'probe_pos_correction': shifts}, batch,
                                 cfg).transpose(0, 1).contiguous()
        mats = cm.prop_mats(h, *far, route='fft')
        ms_f = time_ms(lambda: cm.MultisliceDbStored.apply(
            db, wave, mats, k1, 1.0), 10)
        plain_f = time_ms(lambda: cm.multislice_db_stored_plain(
            db, wave, h, k1, 1.0, *far), 5)
    d = db.detach().requires_grad_()
    w = wave.detach().requires_grad_()
    out = cm.MultisliceDbStored.apply(d, w, mats, k1, 1.0)
    ms_b = time_ms(lambda: torch.autograd.grad(out, (d, w), g,
                                               retain_graph=True), 10)
    out_p = cm.multislice_db_stored_plain(d, w, h, k1, 1.0, *far)
    plain_b = time_ms(lambda: torch.autograd.grad(out_p, (d, w), g,
                                                  retain_graph=True), 5)
    b_f, by_f = bound(cm.bytes_moved(S, 1, N, n, n, 4),
                      cm.flops(S, 1, N, n, n, final=folded))
    b_b, by_b = bound(cm.bytes_moved(S, 1, N, n, n, 4, backward=True),
                      cm.flops(S, 1, N, n, n, final=folded, backward=True))
    log(f'K1{tag}: forward {ms_f:.4f} ms (plain {plain_f:.3f}, bound '
        f'{b_f:.4f}), backward {ms_b:.4f} ms (plain {plain_b:.3f}, bound '
        f'{b_b:.4f})')
    src = 'adorym_tpu_torch/csrc/multislice_db_stored.cu'
    path = 'immediate_pos' if N == 23 else 'delta_beta_pos'
    e_b = max(errs[1:], key=lambda e: e[1])
    return [
        record(f'K1f multislice_db_stored forward{tag} (float32)', src,
               'adorym_tpu/ops/pallas_multislice.py:353', errs[0][0],
               errs[0][1], tol_fwd, ms_f, plain_f, b_f, by_f, None, 'K1_FWD',
               path),
        record(f'K1b multislice_db_stored backward{tag} (float32)', src,
               'adorym_tpu/ops/pallas_multislice.py:422', e_b[0], e_b[1],
               tol_bwd, ms_b, plain_b, b_b, by_b, None, 'K1_BWD', path)]


#: The large planes of ROADMAP B.12: (pair, plane side, probe modes, its
#: ``multislice_propagate`` keywords).  No shared-memory route of the pair
#: fits the plane, so it takes its global route: K1 and K4 (the invertible
#: switch forced) on 96^2 delta_beta planes, K5 on 128^2 real_imag ones.
LARGE_PLANES = (('K1', 96, 1, {}), ('K4', 96, 3, {}),
                ('K5', 128, 1, {'unknown_type': 'real_imag'}))
#: Patches, z slices and binning of each large-plane chunk (16 steps).
LARGE_N, LARGE_NZ, LARGE_BIN = 64, 32, 2


def large_plane_inputs(n, m, seed, real_imag=False):
    """A large-plane chunk's object channels ``[N, n, n, nz]`` (delta and
    beta, or near-vacuum real and imaginary parts), waves and cotangents
    ``[m, N, n, n]``."""
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (LARGE_N, n, n, LARGE_NZ)
    a = torch.rand(shape, device=dev, generator=gen) * 1e-3
    b = torch.rand(shape, device=dev, generator=gen) * 1e-5
    if real_imag:
        a = 1.0 - a
    wave = torch.randn((m, LARGE_N, n, n), dtype=torch.complex64,
                       device=dev, generator=gen)
    g = torch.randn((m, LARGE_N, n, n), dtype=torch.complex64, device=dev,
                    generator=gen)
    return a, b, wave, g


def run_large_planes():
    """R2's main path: each large plane through ``multislice_propagate``
    under ``fused='auto'``, forward and backward, with the Fraunhofer far
    field, the counts set to 0 just before and read just after.  Each
    output and gradient is held against the plain FFT scan
    (``fused=False``): the output within 1e-5 of its largest value, the
    gradients within 1e-3 (K1's bound: 16 steps of sums in other orders
    than cuFFT's).  Returns the launches."""
    from adorym_tpu_torch.ops import propagate as prop
    kw = dict(energy_ev=FLAGSHIP['energy_ev'], psize_cm=1e-7,
              binning=LARGE_BIN,
              final_prop={'free_prop_cm': 'inf', 'normalize_fft': False})
    switch = prop._db_stored_max_bytes
    reset_counts()
    try:
        for i, (pair, n, m, extra) in enumerate(LARGE_PLANES):
            a, b, wave, g = large_plane_inputs(
                n, m, 96 + i, 'unknown_type' in extra)
            prop._db_stored_max_bytes = ((lambda device: -1.0)
                                         if pair == 'K4' else switch)
            got = {}
            for fused in ('auto', False):
                leaves = [x.detach().requires_grad_() for x in (a, b, wave)]
                out = prop.multislice_propagate(*leaves, fused=fused, **kw,
                                                **extra)
                got[fused] = (out.detach(),) + torch.autograd.grad(
                    out, leaves, g)
            e_out = rel_err(got['auto'][0], got[False][0])[1]
            e_grad = max(rel_err(x, y)[1] for x, y in
                         zip(got['auto'][1:], got[False][1:]))
            log(f'R2 {pair} {n}^2 (M={m}) under auto: against the plain FFT '
                f'scan, output rel {e_out:.3e} (tol 1e-5), gradients rel '
                f'{e_grad:.3e} (tol 1e-3)')
            if not (e_out < 1e-5 and e_grad < 1e-3):
                raise AssertionError(f'R2: {pair} at {n}^2 disagrees with '
                                     'the plain FFT scan')
    finally:
        prop._db_stored_max_bytes = switch
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {'K1_FWD': 1, 'K1_BWD': 1, 'K1_GLOBAL': 2, 'K4_FWD': 1,
            'K4_BWD': 1, 'K4_GLOBAL': 2, 'K5_FWD': 1, 'K5_BWD': 1,
            'K5_GLOBAL': 2, 'K1_FFT': 0, 'K1_DENSE': 0, 'K4_FFT': 0,
            'K4_DENSE': 0, 'K5_FFT': 0, 'K5_DENSE': 0}
    log(f'R2 launches: {launches}')
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f'R2: launches {launches}, expected {want}')
    return launches


def check_large_planes():
    """The global route of K1, K4 and K5 against each pair's plain version
    at the large planes (:data:`LARGE_PLANES`, 16 steps of 64 patches, the
    Fraunhofer far field for K1 and K4), forward and backward, timed; then
    their main path (:func:`run_large_planes`), whose launches the records
    report.  Tolerances as the pairs' flagship rows: the output 1e-4, the
    gradients 1e-3."""
    from adorym_tpu_torch.ops import cuda_multislice as cm
    from adorym_tpu_torch.ops import cuda_multislice_fused as cmf
    from adorym_tpu_torch.ops import propagate as prop
    routes = {n: (cm.k1_route(n, n), cm.k4_route(n, n), cmf.k5_route(n, n),
                  cmf.k5_route(n, n, 3))
              for n in (64, 72, 80, 88, 96, 128)}
    log(f'routes (K1, K4, K5, K5 at 3 modes) by plane: {routes}')
    S = LARGE_NZ // LARGE_BIN
    lmbda = 1240.0 / FLAGSHIP['energy_ev']
    voxel = (1.0, 1.0, 1.0)
    k1 = 2 * np.pi / lmbda
    recs = []
    for i, (pair, n, m, extra) in enumerate(LARGE_PLANES):
        a, b, wave, g = large_plane_inputs(n, m, 196 + i,
                                           'unknown_type' in extra)
        dev = wave.device
        if pair == 'K5':
            t = torch.complex(a, b)[..., ::LARGE_BIN].permute(3, 0, 1, 2)
            operands = (t.contiguous(),)
            h = prop.fresnel_kernel((n, n), voxel, lmbda, 1.0 * LARGE_BIN,
                                    device=dev)
            fns = (cmf.multislice_fused, cmf.multislice_fused_plain)
            extra_args = ()
        else:
            db = torch.stack([a, b], 0)[..., ::LARGE_BIN].permute(
                4, 0, 1, 2, 3).contiguous()
            operands = (db,)
            h = prop.fresnel_kernel((n, n), voxel, lmbda, 1.0 * LARGE_BIN,
                                    device=dev)
            fm = prop.final_prop_mats((n, n), voxel, lmbda, 'inf',
                                      device=dev)
            if pair == 'K1':
                fns = (cm.multislice_db_stored_packed,
                       cm.multislice_db_stored_plain)
                extra_args = (k1, 1.0) + tuple(fm[:2])
            else:
                fns = (cm.multislice_db_packed, cm.multislice_db_plain)
                extra_args = (k1, 1.0) + tuple(fm)

        def run(fn):
            leaves = [x.detach().requires_grad_() for x in operands + (wave,)]
            out = fn(*leaves, h, *extra_args)
            grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
            return out.detach(), grads, (lambda: torch.autograd.grad(
                out, leaves, g, retain_graph=True))

        routes_of = {'K1': cm.K1_ROUTE_LAUNCHES, 'K4': cm.K4_ROUTE_LAUNCHES,
                     'K5': cmf.K5_ROUTE_LAUNCHES}[pair]
        r0 = routes_of['global']
        out_k, g_k, bwd_k = run(fns[0])
        out_p, g_p, bwd_p = run(fns[1])
        torch.cuda.synchronize()
        if routes_of['global'] - r0 != 2:
            raise AssertionError(f'{pair} at {n}^2 did not take its global '
                                 'route')
        e_fwd, r_fwd = rel_err(out_k, out_p)
        e_bwd = max(rel_err(x, y)[0] for x, y in zip(g_k, g_p))
        r_bwd = max(rel_err(x, y)[1] for x, y in zip(g_k, g_p))
        log(f'{pair} global route {n}^2 M={m} S={S} N={LARGE_N}: fwd max_abs '
            f'{e_fwd:.3e} rel {r_fwd:.3e} (tol 1e-4); grads max_abs '
            f'{e_bwd:.3e} rel {r_bwd:.3e} (tol 1e-3)')
        if not (r_fwd < 1e-4 and r_bwd < 1e-3):
            raise AssertionError(f'{pair} global route at {n}^2 disagrees '
                                 'with its plain version')
        del out_k, g_k, out_p, g_p
        with torch.no_grad():
            ms_f = time_ms(lambda: fns[0](*operands, wave, h, *extra_args),
                           5)
            plain_f = time_ms(lambda: fns[1](*operands, wave, h,
                                             *extra_args), 3)
        ms_b = time_ms(bwd_k, 5)
        plain_b = time_ms(bwd_p, 3)
        del bwd_k, bwd_p
        if pair == 'K5':
            b_f = bound(cmf.bytes_moved(S, m, LARGE_N, n, n),
                        cmf.flops(S, m, LARGE_N, n, n))
            b_b = bound(cmf.bytes_moved(S, m, LARGE_N, n, n, backward=True),
                        cmf.flops(S, m, LARGE_N, n, n, backward=True))
            src = 'adorym_tpu_torch/csrc/multislice_fused.cu'
            names = ('K5f multislice_fused forward',
                     'K5b multislice_fused backward')
            lines = (184, 222)
        else:
            inv = pair == 'K4'
            b_f = bound(cm.bytes_moved(S, m, LARGE_N, n, n, 4,
                                       records=not inv),
                        cm.flops(S, m, LARGE_N, n, n))
            b_b = bound(cm.bytes_moved(S, m, LARGE_N, n, n, 4, backward=True,
                                       records=not inv),
                        cm.flops(S, m, LARGE_N, n, n, backward=True,
                                 invertible=inv))
            src = ('adorym_tpu_torch/csrc/multislice_db.cu' if inv
                   else 'adorym_tpu_torch/csrc/multislice_db_stored.cu')
            names = (('K4f multislice_db forward',
                      'K4b multislice_db backward') if inv
                     else ('K1f multislice_db_stored forward',
                           'K1b multislice_db_stored backward'))
            lines = (294, 495) if inv else (353, 422)
        log(f'{pair} global route {n}^2: forward {ms_f:.3f} ms (plain '
            f'{plain_f:.3f}, bound {b_f[0]:.3f}), backward {ms_b:.3f} ms '
            f'(plain {plain_b:.3f}, bound {b_b[0]:.3f}); {CARD}')
        tag = f' {n}^2' + (f' M={m}' if m > 1 else '') + ' (float32)'
        for name, line, err, rel, tol, ms, plain, (bms, by), counter in (
                (names[0], lines[0], e_fwd, r_fwd, 1e-4, ms_f, plain_f, b_f,
                 f'{pair}_FWD'),
                (names[1], lines[1], e_bwd, r_bwd, 1e-3, ms_b, plain_b, b_b,
                 f'{pair}_BWD')):
            rec = record(name + tag, src,
                         f'adorym_tpu/ops/pallas_multislice.py:{line}', err,
                         rel, tol, ms, plain, bms, by, None, counter,
                         'large_plane')
            rec['step_route'] = 'global'
            recs.append(rec)
        del a, b, wave, g, operands
        torch.cuda.empty_cache()
    launches = run_large_planes()
    for rec in recs:
        rec['launches'] = launches[rec['counter']]
    return recs


# -- phase 7 -----------------------------------------------------------------

#: BASELINE #2 (``demos/2d_ptychography_experimental_data.py``): the
#: Siemens-star geometry at the demo's size.
SIEMENS = dict(n=256, pn=72, energy_ev=8801.121930115722,
               psize_cm=1.32789376566526e-06, stride=12)
#: Its ``reconstruct_ptychography`` keywords (the demo's, ``:93-110``).
SIEMENS_KW = dict(
    obj_size=(256, 256, 1), two_d_mode=True, free_prop_cm='inf',
    minibatch_size=35, random_guess_means_sigmas=(1., 0., 0.001, 0.002),
    probe_type='aperture_defocus', n_probe_modes=5, aperture_radius=10,
    beamstop_radius=5, probe_defocus_cm=0.0069, rescale_probe_intensity=True,
    raw_data_type='intensity', optimizer='adam', learning_rate=1e-3,
    optimize_probe=True, probe_learning_rate=1e-3,
    optimize_all_probe_pos=True, all_probe_pos_learning_rate=1e-2,
    update_scheme='immediate', unknown_type='real_imag',
    loss_function_type='lsq', use_checkpoint=False, save_intermediate=False)


def siemens_star(n, spokes=24):
    """The demo's spoke phantom: a binary star in an annulus, smoothed."""
    from scipy.ndimage import gaussian_filter
    yy, xx = np.mgrid[0:n, 0:n].astype(float) - n / 2
    r = np.hypot(yy, xx)
    star = (np.sin(spokes * np.arctan2(yy, xx)) > 0).astype(float)
    star *= (r > 6) & (r < n * 0.45)
    return gaussian_filter(star, 1.0)


def epoch_rates(out_dir):
    """Patterns/s of each epoch from the run's ``stdout_*.txt`` (the
    Reconstructor's progress lines under ``save_stdout``)."""
    import re
    rates = []
    for f in sorted(Path(out_dir).glob('stdout_*.txt')):
        rates += [float(m) for m in re.findall(r'([0-9.]+) patterns/s',
                                               f.read_text())]
    return rates


def siemens_data():
    """BASELINE #2's data at the demo's size: simulated on the card at
    jittered positions with a perturbed probe, intensities, the nominal
    grid recorded (the demo's ``:62-91``), as an ``ArrayDataset``.
    Returns (dataset, the true offsets less their mean, simulate s)."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.io import data as io_data
    from adorym_tpu_torch.utils.initialize import initialize_probe
    s = SIEMENS
    n, pn = s['n'], s['pn']
    rng = np.random.default_rng(0)
    xs = np.arange(0, n - pn + 1, s['stride'])
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    nominal = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    star = siemens_star(n)
    ph, mag = 0.4 * star, 1.0 - 0.25 * star
    obj = np.stack([mag * np.cos(ph), mag * np.sin(ph)],
                   -1)[:, :, None, :].astype(np.float32)
    probe = initialize_probe(
        (pn, pn), 'aperture_defocus', n_probe_modes=5,
        energy_ev=s['energy_ev'], psize_cm=s['psize_cm'], aperture_radius=10,
        beamstop_radius=5, probe_defocus_cm=0.0069, seed=0)
    prng = np.random.default_rng(1)
    probe = probe + 0.05 * np.abs(probe).max() * prng.normal(
        size=probe.shape).astype(np.float32)
    true = nominal + rng.uniform(-1.5, 1.5, nominal.shape)
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(n, n, 1), probe_size=(pn, pn),
                             energy_ev=s['energy_ev'],
                             psize_cm=s['psize_cm'], free_prop_cm='inf',
                             two_d_mode=True),
        train=pt.TrainConfig(minibatch_size=35, unknown_type='real_imag'))
    t0 = time.perf_counter()
    data = pt.simulate(cfg, obj, probe, true) ** 2
    sim_s = time.perf_counter() - t0
    ds = io_data.ArrayDataset(data, theta=np.zeros(1), probe_pos_px=nominal,
                              energy_ev=s['energy_ev'],
                              psize_cm=s['psize_cm'])
    err = true - nominal
    return ds, err - err.mean(0), sim_s


def run_siemens(work, n_epochs=30):
    """Phase 7a: BASELINE #2 at the demo's size through
    ``reconstruct_ptychography`` (:func:`siemens_data`); ``n_epochs``
    epochs (the first is the warmup), 8 generic steps an epoch (256 spots
    in minibatches of 35), five probe modes and the positions refined with
    the object.  One slice: no kernel runs.  Then the same configuration
    held against the CPU (:func:`siemens_cuda_matches_cpu`) and the
    refinement after the object has formed (:func:`siemens_refinement`).
    Returns {metric: value}."""
    import adorym_tpu_torch as pt
    ds, err, sim_s = siemens_data()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = work / 'siemens'
    t0 = time.perf_counter()
    res = pt.reconstruct_ptychography(
        fname='data.h5', save_path=str(work), output_folder='siemens',
        n_epochs=n_epochs, save_stdout=True, dataset=ds, **SIEMENS_KW)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    rates = epoch_rates(out)
    before = float(np.abs(err).mean())
    after = float(np.abs(res['probe_pos_correction'][0] - err).mean())
    log(f'7a BASELINE #2 (Siemens star, 256^2, 72^2 probe, 5 modes, '
        f'minibatch 35, positions and probe refined): simulate {sim_s:.2f} '
        f's; losses {list(res["loss_history"])}; patterns/s by epoch '
        f'{rates} (warmup first); call wall {wall:.2f} s; mean position '
        f'residual {before:.4f} px before, {after:.4f} px after '
        f'{n_epochs} epochs; peak memory {peak:.2f} GB; launches {launches}')
    if not np.all(np.isfinite(res['loss_history'])):
        raise AssertionError('7a: non-finite loss')
    if any(launches[k] for k in counters()):
        raise AssertionError(f'7a: a kernel ran on the 2D path {launches}')
    if res['probe_pos_correction'].shape != (1, len(err), 2):
        raise AssertionError('7a: no per-spot positions in the results')
    siemens_cuda_matches_cpu(work, ds)
    trend = siemens_refinement(work, ds, err)
    return {'patterns_s': rates[1:], 'residual': (before, after),
            'peak_gb': peak, 'refined': trend}


def siemens_cuda_matches_cpu(work, ds, n_epochs=3):
    """7a's configuration, unchanged, for ``n_epochs`` epochs on the card
    and on the CPU: the losses within rtol 1e-3 and the refined positions
    within two Adam steps (0.02 px), as ``tests/test_torch_refinables_api.py``
    holds the port against the JAX package (Adam turns f32 noise into sign
    flips of single steps)."""
    import adorym_tpu_torch as pt
    got = {}
    for dev in ('cuda', 'cpu'):
        t0 = time.perf_counter()
        extra = {} if dev == 'cuda' else {'device': 'cpu'}
        res = pt.reconstruct_ptychography(
            fname='data.h5', save_path=str(work),
            output_folder=f'siemens_{dev}', n_epochs=n_epochs, dataset=ds,
            **SIEMENS_KW, **extra)
        got[dev] = (np.asarray(res['loss_history']),
                    np.asarray(res['probe_pos_correction']),
                    time.perf_counter() - t0)
    loss_rel = float(np.max(np.abs(got['cuda'][0] - got['cpu'][0])
                            / np.abs(got['cpu'][0])))
    pos_diff = float(np.max(np.abs(got['cuda'][1] - got['cpu'][1])))
    moved = float(np.max(np.abs(got['cpu'][1])))
    log(f'7a CUDA against the CPU, {n_epochs} epochs at the demo size: '
        f'losses rel {loss_rel:.3e} (tol 1e-3); positions max diff '
        f'{pos_diff:.4f} px (tol 0.02) of corrections up to {moved:.4f} px; '
        f'wall {got["cuda"][2]:.2f} s card, {got["cpu"][2]:.2f} s CPU')
    if not (loss_rel < 1e-3 and pos_diff <= 0.02 and moved > 0):
        raise AssertionError('7a: the card and the CPU disagree')


def siemens_refinement(work, ds, err, delay_epochs=50, n_epochs=200):
    """7a's configuration with the position updates held back until the
    object has formed (``other_params_update_delay``, ``delay_epochs``
    epochs of 8 batches), ``n_epochs`` epochs, the refined positions read
    each epoch from ``intermediate/probe_pos``.  The residual must fall
    below its start and the corrections correlate with the true offsets
    (the demo's own settings move the positions before the object has
    formed, and the JAX package's run of them drifts the same way: PERF.md
    section 6).  Returns [(epoch, mean residual px, correlation)]."""
    import re
    import adorym_tpu_torch as pt
    kw = dict(SIEMENS_KW, save_intermediate=True,
              other_params_update_delay=8 * delay_epochs)
    pt.reconstruct_ptychography(
        fname='data.h5', save_path=str(work), output_folder='siemens_refine',
        n_epochs=n_epochs, dataset=ds, **kw)
    trend = []
    files = (work / 'siemens_refine' / 'intermediate' / 'probe_pos').glob(
        'probe_pos_correction_*.txt')
    for f in sorted(files, key=lambda f: int(re.findall(r'_(\d+)\.txt',
                                                        f.name)[0])):
        ep = int(re.findall(r'_(\d+)\.txt', f.name)[0])
        c = np.loadtxt(f).reshape(-1, 2)
        corr = (float(np.corrcoef(c.ravel(), err.ravel())[0, 1])
                if np.any(c) else 0.0)
        trend.append((ep, float(np.abs(c - err).mean()), corr))
    before = float(np.abs(err).mean())
    log(f'7a refinement after a {delay_epochs}-epoch delay: mean residual '
        f'{before:.4f} px before; by epoch (residual px, correlation) '
        f'{[t for t in trend if t[0] % 25 == 24 or t is trend[-1]]}; {CARD}')
    if not (len(trend) == n_epochs and trend[-1][1] < before
            and trend[-1][2] > 0.3):
        raise AssertionError('7a: the refined positions do not approach the '
                             'true offsets')
    return trend


def small_refinables_agree(kind):
    """CUDA against the CPU on a small configuration of each phase 7 path,
    2 epochs of GD, the per-epoch losses within 1e-4 (as phase 5e):
    ``'2d'`` the generic step with refined positions and two refined probe
    modes (7a); ``'band'`` the band step with refined positions (7b, K1 and
    K6); ``'angle'`` the per-angle step with refined positions and
    projection offset (7c, K1 unfolded and K2); ``'multidist'`` the
    multi-distance model with refined distances, affines and per-distance
    shifts (7d).  Returns the CUDA run's launches."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.models import multidist
    rng = np.random.default_rng(3)
    theta = np.linspace(0, np.pi, 3, endpoint=False)
    model = None
    probe0 = None
    aux_init = None
    if kind == 'multidist':
        n = 32
        dists = (0.05, 0.12, 0.3, 0.7)
        size, pos = (n, n, 1), np.array([[0.0, 0.0]])
        data = 1 + 0.1 * rng.random((1, 4, n, n)).astype(np.float32)
        obj0 = np.stack([np.ones(size), np.zeros(size)], -1).astype(
            np.float32) + 0.01 * rng.random(size + (2,)).astype(np.float32)
        geo = pt.Geometry(obj_size=size, probe_size=(n, n),
                          energy_ev=17500., psize_cm=1e-5,
                          free_prop_cm=dists, n_dists=4, two_d_mode=True,
                          safe_zone_width=0)
        train = pt.TrainConfig(minibatch_size=1, learning_rate=1e-2,
                               optimizer='gd', unknown_type='real_imag')
        refine = pt.RefineConfig(
            optimize_free_prop=True, free_prop_learning_rate=1e-5,
            free_prop_optimizer='gd', optimize_prj_affine=True,
            prj_affine_learning_rate=1e-4, prj_affine_optimizer='gd',
            optimize_all_probe_pos=True, all_probe_pos_learning_rate=1e-1,
            all_probe_pos_optimizer='gd')
        model, theta = multidist, np.zeros(1)
        aux_init = {'free_prop_cm': np.asarray(dists) * 1.06}
    else:
        xs = np.arange(4) * 4
        yy, xx = np.meshgrid(xs, xs, indexing='ij')
        pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
        two_d = kind == '2d'
        if two_d:
            pos = pos + rng.uniform(-1, 1, pos.shape)
            theta = np.zeros(1)
        size = (32, 32, 1) if two_d else (32, 32, 32)
        data = rng.random((len(theta), 16, 16, 16)).astype(np.float32)
        obj0 = (rng.random(size + (2,)) * 1e-3).astype(np.float32)
        if two_d:
            obj0[..., 0] += 1.0
        geo = pt.Geometry(obj_size=size, probe_size=(16, 16),
                          energy_ev=5000., psize_cm=1e-7,
                          free_prop_cm='inf', binning=1 if two_d else 2,
                          two_d_mode=two_d)
        train = pt.TrainConfig(
            minibatch_size=5 if two_d else 4, learning_rate=1e-3,
            optimizer='gd', update_scheme=('per angle' if kind == 'angle'
                                           else 'immediate'),
            rotate_out_of_loop=kind == 'angle',
            unknown_type='real_imag' if two_d else 'delta_beta',
            n_probe_modes=2 if two_d else 1)
        # A probe with structure: a plane wave does not move under a shift.
        probe0 = probe_modes(16, 2 if two_d else 1)
        refine = pt.RefineConfig(
            optimize_all_probe_pos=True, all_probe_pos_learning_rate=1e-1,
            all_probe_pos_optimizer='gd', optimize_probe=two_d,
            probe_optimizer='gd', probe_learning_rate=1e-2,
            optimize_prj_pos_offset=kind == 'angle',
            prj_pos_offset_optimizer='gd',
            prj_pos_offset_learning_rate=1e-1)
    cfg = pt.ReconConfig(geometry=geo, train=train, refine=refine)
    out, leaves = {}, {}
    reset_counts()
    for dev in ('cuda', 'cpu'):
        rec = pt.Reconstructor(cfg, data=data, probe_pos=pos, theta_ls=theta,
                               obj_init=obj0.copy(), probe_init=probe0,
                               aux_init=aux_init, model=model, device=dev)
        out[dev] = [rec.run_epoch(e) for e in range(2)]
        if dev == 'cuda':
            launches = launch_counts()
        leaves[dev] = {k: v.detach().cpu().numpy()
                       for k, v in rec.params.items() if k != 'obj'}
    rel = np.max(np.abs(np.subtract(out['cuda'], out['cpu']))
                 / np.abs(out['cpu']))
    moved = {k: float(np.max(np.abs(leaves['cuda'][k] - leaves['cpu'][k])))
             for k in leaves['cpu']}
    log(f'7 small {kind}: losses cuda {out["cuda"]} cpu {out["cpu"]} rel '
        f'{rel:.3e} (tol 1e-4); refined leaves CUDA - CPU max abs {moved}; '
        f'launches {launches}')
    if not rel < 1e-4:
        raise AssertionError(f'7 small {kind}: CUDA and CPU losses disagree')
    return launches


#: BASELINE #4 (``demos/2d_multidist_holography_w_affine.py``) at the
#: demo's size: its true distances and per-distance affines.
HOLO = dict(n=128, energy_ev=17500.0, psize_cm=1e-5,
            dists=(0.05, 0.12, 0.3, 0.7),
            affines=np.array([
                [[1.000, 0.000, 0.0], [0.000, 1.000, 0.0]],
                [[1.004, 0.002, 0.6], [-0.002, 1.004, -0.4]],
                [[0.996, -0.003, -0.5], [0.003, 0.996, 0.7]],
                [[1.006, 0.001, 0.3], [-0.001, 0.994, 0.5]]]))


def holo_phantom(n, seed=3):
    """The demo's band-limited phantom (a difference of Gaussians)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, n, 1))
    ph = gaussian_filter(base, (2, 2, 0)) - gaussian_filter(base, (6, 6, 0))
    ph = ph / np.abs(ph).max() * 0.5
    mg = rng.random((n, n, 1))
    mag = np.clip(1.0 - (gaussian_filter(mg, (2, 2, 0))
                         - gaussian_filter(mg, (6, 6, 0))), 0.7, 1.0)
    return np.stack([mag * np.cos(ph), mag * np.sin(ph)],
                    -1).astype(np.float32)


def run_multidist(work, n_epochs=200):
    """Phase 7d: BASELINE #4 at the demo's size through
    ``reconstruct_ptychography`` on :func:`holo_dataset`'s holograms; the
    run starts from distances 6% long and refines them with the affines
    (minibatch 1, ``randomize_probe_pos``, real_imag, Adam), ``n_epochs``
    one-step epochs.  One slice: no kernel runs.  Returns {metric:
    value}."""
    import adorym_tpu_torch as pt
    h = HOLO
    n, dists = h['n'], h['dists']
    ds, obj = holo_dataset()
    wrong = tuple(d * 1.06 for d in dists)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = pt.reconstruct_ptychography(
        fname='data.h5', save_path=str(work), output_folder='holo',
        obj_size=(n, n, 1), two_d_mode=True, free_prop_cm=wrong,
        safe_zone_width=0, n_epochs=n_epochs, minibatch_size=1,
        random_guess_means_sigmas=(1., 0., 0., 0.01), probe_type='plane',
        optimize_probe=False, optimizer='adam', learning_rate=1e-2,
        optimize_free_prop=True, free_prop_learning_rate=1e-3,
        optimize_prj_affine=True, prj_affine_learning_rate=1e-3,
        randomize_probe_pos=True, update_scheme='immediate',
        unknown_type='real_imag', raw_data_type='intensity',
        loss_function_type='lsq', use_checkpoint=False,
        save_intermediate=False, save_stdout=True, dataset=ds)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    rates = epoch_rates(work / 'holo')
    err0 = float(np.abs(np.asarray(wrong) - dists).mean())
    err1 = float(np.abs(res['free_prop_cm'] - dists).mean())
    s_epoch = [1.0 / r for r in rates[1:]]       # one pattern block an epoch
    phase = np.arctan2(res['obj'][..., 0, 1], res['obj'][..., 0, 0])
    truth = np.arctan2(obj[..., 0, 1], obj[..., 0, 0])
    sl = slice(8, n - 8)
    corr = float(np.corrcoef(phase[sl, sl].ravel(),
                             truth[sl, sl].ravel())[0, 1])
    log(f'7d BASELINE #4 (128^2, 4 distances, free_prop_cm and '
        f'prj_affine_ls refined): losses {list(res["loss_history"][:3])} .. '
        f'{list(res["loss_history"][-3:])}; s an epoch median '
        f'{statistics.median(s_epoch):.5f} (call wall {wall:.2f} s for '
        f'{n_epochs} epochs); distance error {err0:.5f} cm before, '
        f'{err1:.5f} after; affines {res["prj_affine_ls"].tolist()}; phase '
        f'correlation {corr:.4f}; peak memory {peak:.3f} GB; launches '
        f'{launches}')
    if not np.all(np.isfinite(res['loss_history'])):
        raise AssertionError('7d: non-finite loss')
    if any(launches[k] for k in counters()):
        raise AssertionError(f'7d: a kernel ran on the 2D path {launches}')
    return {'s_epoch': s_epoch, 'dist_err': (err0, err1), 'corr': corr,
            'peak_gb': peak}


# -- phase 8 -----------------------------------------------------------------

def check_multislice_branches():
    """Phase 3, K1 on the new branches of ``multislice_propagate`` at the
    shape the accumulate loop gives it (one grid row of 23 patches, 72^2,
    256 slices binned by 8): under ``beta = kappa delta`` with a tensor
    kappa and the far field folded (forward at 1e-4, the delta and kappa
    gradients at 1e-3), and under the propagation in -z (the -z step
    kernel on the FFT route, the flipped modulator sign; forward 1e-4,
    delta and beta gradients 1e-3).  The plain side is the same call with
    K1 swapped for its plain version, on the same inputs on the card."""
    from adorym_tpu_torch.ops import cuda_multislice as cm
    from adorym_tpu_torch.ops import propagate as prop
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(81)
    n, N, nz = FLAGSHIP['n_probe'], FLAGSHIP['mb'], FLAGSHIP['n_obj']
    delta = torch.rand((N, n, n, nz), device=dev, generator=gen) * 2e-4
    beta = torch.rand((N, n, n, nz), device=dev, generator=gen) * 5e-6
    wave = torch.randn((1, N, n, n), dtype=torch.complex64, device=dev,
                       generator=gen)
    g = torch.randn((1, N, n, n), dtype=torch.complex64, device=dev,
                    generator=gen)
    kernel_fn = cm.multislice_db_stored_packed
    for branch in ('kappa', 'backprop'):
        res = {}
        for side in ('kernel', 'plain'):
            cm.multislice_db_stored_packed = (
                kernel_fn if side == 'kernel'
                else cm.multislice_db_stored_plain)
            try:
                d = delta.detach().requires_grad_()
                b = beta.detach().requires_grad_()
                kappa = torch.tensor(0.03, device=dev, requires_grad=True)
                kw = dict(binning=FLAGSHIP['binning'], fused=True)
                if branch == 'kappa':
                    kw.update(kappa=kappa, final_prop={
                        'free_prop_cm': 'inf', 'normalize_fft': False})
                    leaves = (d, kappa)
                else:
                    kw.update(backprop=True)
                    leaves = (d, b)
                r0 = dict(cm.K1_ROUTE_LAUNCHES)
                out = prop.multislice_propagate(
                    d, b, wave, FLAGSHIP['energy_ev'], FLAGSHIP['psize_cm'],
                    **kw)
                grads = torch.autograd.grad(out, leaves, g)
                torch.cuda.synchronize()
                took = {r: cm.K1_ROUTE_LAUNCHES[r] - r0[r] for r in r0}
            finally:
                cm.multislice_db_stored_packed = kernel_fn
            res[side] = (out.detach(),) + tuple(x.detach() for x in grads)
            if side == 'kernel' and took != {'fft': 2, 'dense': 0,
                                             'global': 0}:
                raise AssertionError(f'K1 {branch}: launches by route '
                                     f'{took}')
        errs = [rel_err(a, b) for a, b in zip(res['kernel'], res['plain'])]
        names = ('forward', 'g_delta', 'g_kappa' if branch == 'kappa'
                 else 'g_beta')
        log(f'K1 {branch} (N={N}, {nz} slices binned by '
            f'{FLAGSHIP["binning"]}, FFT route): ' + '; '.join(
                f'{nm} max_abs {e[0]:.3e} rel {e[1]:.3e}'
                for nm, e in zip(names, errs))
            + ' (tol 1e-4 forward, 1e-3 gradients)')
        if not (errs[0][1] < 1e-4 and all(e[1] < 1e-3 for e in errs[1:])):
            raise AssertionError(f'K1 {branch} disagrees with its plain '
                                 'version')


#: Phases 8a-8d: the flagship geometry through the accumulate-then-update
#: loop (two angles of random data, Adam).
LOOP_PATHS = {
    # 'per angle' with the rotation inside autodiff: the whole object
    # rotated in autograd every batch, one update an angle.
    '8a': dict(update_scheme='per angle'),
    # 8a with the tilts refined: three rotations a batch in autograd.
    '8b': dict(update_scheme='per angle', refine=dict(optimize_tilt=True)),
    # 'immediate' with the rotation out of the loop: the object rotated
    # once an angle, the gradient rotated back every batch.
    '8c': dict(update_scheme='immediate', rotate_out_of_loop=True),
    # 'immediate' with four batches an update, the rotation in the loop.
    '8d': dict(update_scheme='immediate', n_batch_per_update=4),
}
LOOP_THETA = 2


def run_loop_flagship(path):
    """A warmup epoch and a timed epoch of ``LOOP_THETA`` angles at the
    flagship's full width through the accumulate loop, then one angle
    under the profiler.  Checks K1's launches (one pair a batch, 23 an
    angle; no other kernel) and returns {metric: value}."""
    import adorym_tpu_torch as pt
    f = FLAGSHIP
    p = LOOP_PATHS[path]
    pos = flagship_positions()
    rng = np.random.default_rng(8)
    data = rng.random((LOOP_THETA, len(pos), f['n_probe'], f['n_probe']),
                      dtype=np.float32)
    theta = np.linspace(0, np.pi, LOOP_THETA, endpoint=False)
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(f['n_obj'],) * 3,
                             probe_size=(f['n_probe'],) * 2,
                             energy_ev=f['energy_ev'], psize_cm=f['psize_cm'],
                             free_prop_cm='inf', binning=f['binning']),
        train=pt.TrainConfig(minibatch_size=f['mb'], learning_rate=1e-7,
                             optimizer='adam',
                             update_scheme=p['update_scheme'],
                             rotate_out_of_loop=p.get('rotate_out_of_loop',
                                                      False),
                             n_batch_per_update=p.get('n_batch_per_update',
                                                      1)),
        refine=pt.RefineConfig(**p.get('refine', {})))
    obj0 = (rng.random((f['n_obj'],) * 3 + (2,), dtype=np.float32)
            * np.float32(1e-6))
    rec = pt.Reconstructor(cfg, data=data, probe_pos=pos, theta_ls=theta,
                           obj_init=obj0, probe_init=probe_modes(
                               f['n_probe'], 1))
    del obj0
    if not rec._accum or rec.device.type != 'cuda':
        raise AssertionError(f'{path}: not the accumulate loop on CUDA')
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    losses = [rec.run_epoch(0)]
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses.append(rec.run_epoch(1))
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_b = 2 * LOOP_THETA * len(pos) // f['mb']
    expect = {k: 0 for k in launches}
    expect.update(K1_FWD=n_b, K1_BWD=n_b, K1_FFT=2 * n_b)
    if launches != expect or not np.all(np.isfinite(losses)):
        raise AssertionError(f'{path}: losses {losses}, launches {launches}, '
                             f'expected {expect}')
    # One angle under the profiler.
    batches = rec.make_batches(np.random.default_rng(2))
    first = [b for b in batches if b[0] == batches[0][0]]
    _, busy = profile_call(lambda: rec.epoch_fused(first, 2).cpu(),
                           f'{path} angle')
    rate = LOOP_THETA * len(pos) / wall
    k1_angle = n_b // (2 * LOOP_THETA)
    extra = ''
    if 'tilt_ls' in rec.params:
        tl = rec.params['tilt_ls'].cpu().numpy()
        if not np.all(np.isfinite(tl)):
            raise AssertionError(f'{path}: tilts {tl}')
        extra = (f'; tilts moved by {np.abs(tl[1:]).max():.3e} rad '
                 f'(axes 1-2)')
    log(f'{path} ({p}): losses {losses}; warmup {warm:.3f} s; timed epoch '
        f'{wall:.3f} s, {rate:.1f} patterns/s; updates '
        f'{rec.i_opt_batch}; device busy {100 * busy:.1f}% of a profiled '
        f'angle; peak memory {peak:.2f} GB; K1 {k1_angle} forward + '
        f'{k1_angle} backward launches an angle{extra}; {CARD}')
    del rec
    torch.cuda.empty_cache()
    return dict(patterns_s=rate, busy=busy, peak_gb=peak, k1_angle=k1_angle)


def run_sparse_flagship():
    """Phase 8e: the flagship's probe and scan over a [256, 256, 2] object
    at slice positions [0, 10e-4] cm, one view, the slice positions
    refined (Adam, steps of 1e-8 cm) on the reference's default scheme
    (the band step: plain FFTs through the two slices, K6 scattering each
    row's patch-major gradient).  A warmup and a timed epoch.  Returns
    (patterns/s, launches)."""
    import adorym_tpu_torch as pt
    f = FLAGSHIP
    pos = flagship_positions()
    rng = np.random.default_rng(9)
    n = f['n_obj']
    data = rng.random((1, len(pos), f['n_probe'], f['n_probe']),
                      dtype=np.float32)
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(n, n, 2),
                             probe_size=(f['n_probe'],) * 2,
                             energy_ev=f['energy_ev'], psize_cm=f['psize_cm'],
                             free_prop_cm='inf', slice_pos_cm_ls=(0, 10e-4)),
        train=pt.TrainConfig(minibatch_size=f['mb'], learning_rate=1e-7),
        refine=pt.RefineConfig(optimize_slice_pos=True,
                               slice_pos_learning_rate=1e-8))
    obj0 = (rng.random((n, n, 2, 2), dtype=np.float32) * np.float32(1e-4))
    rec = pt.Reconstructor(cfg, data=data, probe_pos=pos,
                           theta_ls=np.zeros(1), obj_init=obj0,
                           probe_init=probe_modes(f['n_probe'], 1))
    if not rec._band:
        raise AssertionError('8e: not the band step')
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = [rec.run_epoch(0)]
    t0 = time.perf_counter()
    losses.append(rec.run_epoch(1))
    wall = time.perf_counter() - t0
    launches = launch_counts()
    rows = 2 * len(pos) // f['mb']
    expect = {k: 0 for k in launches}
    expect.update(K6=rows, K6_VEC=rows)
    sp = rec.params['slice_pos_cm_ls'].cpu().numpy()
    log(f'8e sparse slices [256, 256, 2] at [0, 10e-4] cm refined: losses '
        f'{losses}; {len(pos) / wall:.1f} patterns/s; slice positions '
        f'{sp.tolist()} cm; peak memory '
        f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches '
        f'{launches}; {CARD}')
    if launches != expect or not np.all(np.isfinite(losses + sp.tolist())):
        raise AssertionError(f'8e: launches {launches}, expected {expect}')
    return len(pos) / wall, launches


def run_line_projection():
    """Phase 8f: line-projection tomography of a 256^3 object: the
    projection approximation with minus-logged data, a 256^2 plane-wave
    field, one position an angle, no propagation, 16 angles, the
    reference's default scheme (the generic step: the whole object's
    rotation in autograd).  A warmup and a timed epoch; no kernel runs."""
    import adorym_tpu_torch as pt
    n, n_theta = FLAGSHIP['n_obj'], 16
    rng = np.random.default_rng(10)
    data = rng.random((n_theta, 1, n, n), dtype=np.float32) * np.float32(
        0.1)
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(n, n, n), probe_size=(n, n),
                             energy_ev=FLAGSHIP['energy_ev'],
                             psize_cm=FLAGSHIP['psize_cm'], free_prop_cm=0,
                             pure_projection=True, is_minus_logged=True),
        train=pt.TrainConfig(minibatch_size=1, learning_rate=1e-5,
                             non_negativity=True))
    # A small positive start: at a zero projection the magnitude's
    # gradient vanishes.
    obj0 = np.zeros((n, n, n, 2), np.float32)
    obj0[..., 1] = rng.random((n, n, n), dtype=np.float32) * np.float32(1e-4)
    rec = pt.Reconstructor(
        cfg, data=data, probe_pos=np.zeros((1, 2)),
        theta_ls=np.linspace(0, np.pi, n_theta, endpoint=False),
        obj_init=obj0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = [rec.run_epoch(0)]
    t0 = time.perf_counter()
    losses.append(rec.run_epoch(1))
    wall = time.perf_counter() - t0
    launches = launch_counts()
    log(f'8f line projections (256^3, 16 angles of 256^2): losses {losses}; '
        f'{n_theta / wall:.1f} projections/s; peak memory '
        f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {CARD}')
    if any(launches[k] for k in counters()) or not np.all(
            np.isfinite(losses)):
        raise AssertionError(f'8f: losses {losses}, launches {launches}')
    return n_theta / wall


def run_multidist_ctf(work, n_epochs=100):
    """Phase 8g: 7d's configuration (BASELINE #4's geometry, 128^2, four
    distances refined) with ``forward_algorithm='ctf'`` and
    ``optimize_ctf_lg_kappa=True`` through ``reconstruct_ptychography``:
    the CTF holograms of a delta_beta phantom (delta = the demo's phase /
    10, kappa 50) simulated on the card, the run starting at
    ``ctf_lg_kappa=1.5``."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.io import data as io_data
    from adorym_tpu_torch.models import multidist
    from adorym_tpu_torch.utils.initialize import initialize_probe
    h = HOLO
    n, dists = h['n'], h['dists']
    ph = np.arctan2(*holo_phantom(n)[..., ::-1].transpose(3, 0, 1, 2))
    obj = np.stack([ph / 10, ph / 500], -1).astype(np.float32)
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(n, n, 1), probe_size=(n, n),
                             energy_ev=h['energy_ev'], psize_cm=h['psize_cm'],
                             free_prop_cm=dists, n_dists=len(dists),
                             two_d_mode=True, safe_zone_width=0),
        train=pt.TrainConfig(minibatch_size=1, forward_algorithm='ctf',
                             ctf_kappa=50.0))
    pos = np.array([[0.0, 0.0]])
    data = pt.simulate(cfg, obj, initialize_probe((n, n), 'plane'), pos,
                       model=multidist)
    ds = io_data.ArrayDataset(data, theta=np.zeros(1), probe_pos_px=pos,
                              energy_ev=h['energy_ev'],
                              psize_cm=h['psize_cm'])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = pt.reconstruct_ptychography(
        fname='data.h5', save_path=str(work), output_folder='holo_ctf',
        obj_size=(n, n, 1), two_d_mode=True, free_prop_cm=dists,
        safe_zone_width=0, n_epochs=n_epochs, minibatch_size=1,
        random_guess_means_sigmas=(0., 0., 0., 0.), probe_type='plane',
        optimizer='adam', learning_rate=1e-3, forward_algorithm='ctf',
        ctf_lg_kappa=1.5, optimize_ctf_lg_kappa=True,
        ctf_lg_kappa_learning_rate=1e-2, optimize_free_prop=True,
        free_prop_learning_rate=1e-6, unknown_type='delta_beta',
        raw_data_type='magnitude', use_checkpoint=False,
        save_intermediate=False, save_stdout=True, dataset=ds)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    rates = epoch_rates(work / 'holo_ctf')
    s_epoch = statistics.median([1.0 / r for r in rates[1:]])
    lgk = float(res['ctf_lg_kappa'][0])
    log(f'8g multi-distance CTF (128^2, 4 distances, ctf_lg_kappa and '
        f'free_prop_cm refined): losses {list(res["loss_history"][:2])} .. '
        f'{list(res["loss_history"][-2:])}; s an epoch median {s_epoch:.5f} '
        f'(call wall {wall:.2f} s for {n_epochs} epochs); ctf_lg_kappa 1.5 '
        f'-> {lgk:.4f} (true {np.log10(50.0):.4f}); distances '
        f'{res["free_prop_cm"].tolist()}; peak memory '
        f'{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; {CARD}')
    if (not np.all(np.isfinite(res['loss_history']))
            or any(launches[k] for k in counters())):
        raise AssertionError(f'8g: losses {res["loss_history"]}, launches '
                             f'{launches}')
    return s_epoch


def small_loop_agrees(kind):
    """Phase 8 (small): CUDA against the CPU on a small configuration of
    each new path, 2 epochs of GD, the per-epoch losses within 1e-4:
    ``'8a'`` the per-angle scheme with the rotation inside autodiff;
    ``'8b'`` with the tilts refined; ``'8c'`` the immediate scheme with
    the rotation out of the loop; ``'8d'`` two batches an update;
    ``'kappa'`` the band step under a refined kappa (K1 on ``beta = kappa
    delta``); ``'8e'`` sparse slices refined; ``'8f'`` minus-logged line
    projections; ``'8g'`` the multi-distance CTF with kappa refined.
    Returns the CUDA run's launches."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.models import multidist
    rng = np.random.default_rng(4)
    theta = np.linspace(0, np.pi, 3, endpoint=False)
    xs = np.arange(4) * 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    size, probe_size = (32, 32, 32), (16, 16)
    geo = dict(energy_ev=5000., psize_cm=1e-7, free_prop_cm='inf',
               binning=2)
    train = dict(minibatch_size=4, learning_rate=1e-3, optimizer='gd')
    refine, model, aux_init = {}, None, None
    probe0 = probe_modes(16, 1)
    if kind in LOOP_PATHS:
        p = LOOP_PATHS[kind]
        train.update({k: v for k, v in p.items() if k != 'refine'})
        if kind == '8d':
            train['n_batch_per_update'] = 2
        refine = dict(p.get('refine', {}), tilt_optimizer='gd',
                      tilt_learning_rate=1e-3)
    elif kind == 'kappa':
        refine = dict(optimize_ctf_lg_kappa=True, ctf_lg_kappa_optimizer='gd',
                      ctf_lg_kappa_learning_rate=1e-2)
        aux_init = {'ctf_lg_kappa': -1.5}
    elif kind == '8e':
        size, theta = (32, 32, 2), np.zeros(1)
        geo.update(slice_pos_cm_ls=(0.0, 1e-4), binning=1)
        refine = dict(optimize_slice_pos=True, slice_pos_optimizer='gd',
                      slice_pos_learning_rate=1e-12)
    elif kind == '8f':
        size, probe_size, pos = (16, 16, 16), (16, 16), np.zeros((1, 2))
        geo.update(free_prop_cm=0, pure_projection=True,
                   is_minus_logged=True, binning=1)
        train['minibatch_size'] = 1
        probe0 = None
    elif kind == '8g':
        size, probe_size, pos = (32, 32, 1), (32, 32), np.zeros((1, 2))
        theta = np.zeros(1)
        geo = dict(energy_ev=17500., psize_cm=1e-5,
                   free_prop_cm=(0.05, 0.12), n_dists=2, two_d_mode=True,
                   safe_zone_width=0)
        train.update(minibatch_size=1, forward_algorithm='ctf',
                     learning_rate=1e-3)
        refine = dict(optimize_ctf_lg_kappa=True, ctf_lg_kappa_optimizer='gd',
                      ctf_lg_kappa_learning_rate=1e-2)
        model, probe0, aux_init = multidist, None, {'ctf_lg_kappa': 1.5}
    n_rows = 2 if kind == '8g' else len(pos)
    data = rng.random((len(theta), n_rows) + probe_size).astype(np.float32)
    if kind == '8g':
        data = 1 + 0.1 * data
    obj0 = (rng.random(size + (2,)) * 1e-3).astype(np.float32)
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=size, probe_size=probe_size, **geo),
        train=pt.TrainConfig(**train), refine=pt.RefineConfig(**refine))
    out, leaves = {}, {}
    reset_counts()
    for dev in ('cuda', 'cpu'):
        rec = pt.Reconstructor(cfg, data=data, probe_pos=pos, theta_ls=theta,
                               obj_init=obj0.copy(), probe_init=probe0,
                               aux_init=aux_init, model=model, device=dev)
        out[dev] = [rec.run_epoch(e) for e in range(2)]
        if dev == 'cuda':
            launches = launch_counts()
        leaves[dev] = {k: v.detach().cpu().numpy()
                       for k, v in rec.params.items() if k != 'obj'}
    rel = np.max(np.abs(np.subtract(out['cuda'], out['cpu']))
                 / np.abs(out['cpu']))
    moved = {k: float(np.max(np.abs(leaves['cuda'][k] - leaves['cpu'][k])))
             for k in leaves['cpu'] if k != 'probe'}
    log(f'8 small {kind}: losses cuda {out["cuda"]} cpu {out["cpu"]} rel '
        f'{rel:.3e} (tol 1e-4); refined leaves CUDA - CPU max abs {moved}; '
        f'launches {launches}')
    if not rel < 1e-4:
        raise AssertionError(f'8 small {kind}: CUDA and CPU losses disagree')
    return launches


def slice12_runs(work):
    """Phase 8: the small CUDA-CPU agreements of each new path, then 8a-8g
    at full width; returns ({path: metrics}, 8e's launches)."""
    # 3 angles of 4 grid rows, 2 epochs: 24 batches, one K1 pair each on
    # the 3D multislice paths; the band step (kappa) scatters by K6; the
    # sparse path (one view) runs K6 alone; no kernel on the others.
    k1 = {'K1_FWD': 24, 'K1_BWD': 24, 'K1_FFT': 48, 'K2': 0, 'K6': 0}
    want = {'8a': k1, '8b': k1, '8c': k1, '8d': k1,
            'kappa': dict(k1, K6=24), '8e': {'K1_FWD': 0, 'K6': 8},
            '8f': {}, '8g': {}}
    for kind, expect in want.items():
        launches = small_loop_agrees(kind)
        expect = expect or {k: 0 for k in counters()}
        if any(launches[k] != v for k, v in expect.items()):
            raise AssertionError(f'8 small {kind}: launches {launches}, '
                                 f'expected {expect}')
    res = {path: run_loop_flagship(path) for path in LOOP_PATHS}
    res['8e'], sparse_launches = run_sparse_flagship()
    res['8f'] = run_line_projection()
    res['8g'] = run_multidist_ctf(work)
    log('phase 8: ' + '; '.join(
        f"{p} {r['patterns_s']:.1f} patterns/s, busy {100 * r['busy']:.1f}%"
        f", peak {r['peak_gb']:.2f} GB, K1 {r['k1_angle']} pairs an angle"
        for p, r in res.items() if isinstance(r, dict))
        + f"; 8e {res['8e']:.1f} patterns/s; 8f {res['8f']:.2f} "
        f"projections/s; 8g {res['8g']:.5f} s an epoch; {CARD}")
    return res, sparse_launches


# -- phase 9 -----------------------------------------------------------------

def k6_layouts():
    from adorym_tpu_torch.ops import cuda_scatter_grid as csg
    return dict(csg.K6_LAYOUT_LAUNCHES)


def reset_k6_layouts():
    from adorym_tpu_torch.ops import cuda_scatter_grid as csg
    for k in csg.K6_LAYOUT_LAUNCHES:
        csg.K6_LAYOUT_LAUNCHES[k] = 0


def scan_table(kind, seed=0):
    """The flagship's 23x23 scan at stride 8 as phase 9 varies it:
    ``'grid'`` as it is; ``'jittered'``, an integer offset in [-2, 2] on
    each spot; ``'staggered'``, the odd rows shifted by 4 px (half the
    stride)."""
    pos = flagship_positions()
    if kind == 'jittered':
        pos = pos + np.random.default_rng(seed).integers(-2, 3, pos.shape)
    elif kind == 'staggered':
        rows = pos.reshape(23, 23, 2)
        rows[1::2, :, 1] += 4
        pos = rows.reshape(-1, 2)
    return pos


def table_config(bf16=False, n=None, **train):
    """The flagship's configuration (delta_beta, binning 8, Fraunhofer,
    Adam at 1e-7, per angle with the rotation out of the loop) with
    ``train`` options on top."""
    import adorym_tpu_torch as pt
    f = FLAGSHIP
    kw = dict(minibatch_size=f['mb'], learning_rate=1e-7, optimizer='adam',
              rotate_out_of_loop=True, update_scheme='per angle',
              run_bfloat16=bf16)
    kw.update(train)
    return pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(n or f['n_obj'],) * 3,
                             probe_size=(f['n_probe'],) * 2,
                             energy_ev=f['energy_ev'], psize_cm=f['psize_cm'],
                             free_prop_cm='inf', binning=f['binning']),
        train=pt.TrainConfig(**kw))


def run_table(tag, pos, cfg, n_theta=None, obj0=None, profile=False):
    """Phase 9's drive of one per-angle configuration at full width: a
    warmup epoch and 2 timed epochs through ``Reconstructor`` on random
    data, then (``profile``) one epoch under the profiler.  Checks the
    launches: K1 one pair a gradient chunk; a chunk of whole rows of one
    complete grid one K2, any other grid-row chunk one K6 a row (pad rows
    included), each row read in place; no other kernel.  Returns {metric:
    value} with the Reconstructor under ``'rec'``."""
    import adorym_tpu_torch as pt
    f = FLAGSHIP
    n_theta = n_theta or f['n_theta']
    n = cfg.geometry.obj_size[0]
    rng = np.random.default_rng(0)
    data = rng.random((n_theta, pos.shape[-2], f['n_probe'], f['n_probe']),
                      dtype=np.float32)
    theta = np.linspace(0, np.pi, n_theta, endpoint=False)
    if obj0 is None:
        obj0 = (rng.random((n, n, n, 2), dtype=np.float32)
                * np.float32(1e-6))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = pt.Reconstructor(cfg, data=data, probe_pos=pos, theta_ls=theta,
                           obj_init=obj0, probe_init=probe_modes(
                               f['n_probe'], 1))
    del obj0
    if not rec._angles or rec.device.type != 'cuda':
        raise AssertionError(f'{tag}: not the per-angle path on CUDA')
    reset_counts()
    reset_k6_layouts()
    losses = [rec.run_epoch(0)]
    walls = []
    for ep in (1, 2):
        t0 = time.perf_counter()
        losses.append(rec.run_epoch(ep))
        walls.append(time.perf_counter() - t0)
    launches = launch_counts()
    layouts = k6_layouts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_b = -(-pos.shape[-2] // cfg.train.minibatch_size)
    g = min(rec._fuse_g, n_b)
    chunks = -(-n_b // g) * n_theta * 3
    expect = {k: 0 for k in launches}
    expect.update(K1_FWD=chunks, K1_BWD=chunks, K1_FFT=2 * chunks)
    if rec._grid_scatter_rows == g:
        expect.update(K2=chunks, K2_VEC=chunks)
    elif rec._patch_mode and rec._rowgrid_stride is not None:
        expect.update(K6=g * chunks, K6_VEC=g * chunks)
    rates = [n_theta * pos.shape[-2] / w for w in walls]
    log(f'{tag}: losses {losses}; epoch walls {[round(w, 4) for w in walls]}'
        f' s; patterns/s {rates}; peak memory {peak:.2f} GB; chunk {g} '
        f'batches ({chunks // (3 * n_theta)} an angle); patch mode '
        f'{rec._patch_mode}; streaming {rec._stream_rot}; launches '
        f'{launches}; K6 layouts {layouts}; {CARD}')
    if launches != expect or not np.all(np.isfinite(losses)):
        raise AssertionError(f'{tag}: losses {losses}, launches {launches},'
                             f' expected {expect}')
    if layouts['copy'] or layouts['channel'] != expect['K6']:
        raise AssertionError(f'{tag}: K6 layouts {layouts}')
    busy = None
    if profile:
        _, busy = profile_call(lambda: rec.run_epoch(3), f'{tag} epoch')
    return dict(rec=rec, losses=losses, patterns_s=statistics.median(rates),
                peak_gb=peak, launches=launches, busy=busy)


def scatter_patches_ms(pos, bf16):
    """Phase 9a: the any-table scatter (``patches.scatter_patches_add``,
    one ``index_add_``) alone at the jittered flagship's chunk: the whole
    angle's z-major gradient [32, 2, 529, 72, 72] into the padded binned
    accumulator.  Returns (device ms an angle, bound ms)."""
    from adorym_tpu_torch.ops import patches as patch_ops
    gen = torch.Generator(device='cuda').manual_seed(53)
    dtype = torch.bfloat16 if bf16 else torch.float32
    cot = torch.randn((32, 2, 529, 72, 72), device='cuda',
                      generator=gen).to(dtype).permute(2, 3, 4, 0, 1)
    pad = patch_ops.calculate_pad((256, 256), pos, (72, 72))
    pos_int = (np.round(pos).astype(np.int64)
               + np.asarray([pad[0][0], pad[1][0]]))
    acc = torch.zeros((256 + int(pad[0].sum()), 256 + int(pad[1].sum()),
                       32, 2), device='cuda')
    ms, by = device_ms(lambda: patch_ops.scatter_patches_add(acc, cot,
                                                             pos_int), 5)
    b, _ = bound(cot.numel() * cot.element_size() + 2 * acc.numel() * 4,
                 float(cot.numel()))
    del cot, acc
    torch.cuda.empty_cache()
    return ms, b, by


def run_9a():
    """Phase 9a: the jittered table, f32 and bf16, through the whole-object
    branch (each chunk through ``predict`` on the whole rotated object:
    K1 inside ``multislice_propagate``, the gather's backward a scatter)
    and then under ``patch_grad`` (patches of the binned object, K1, and
    ``scatter_patches_add``); one f32 epoch of each profiled; the
    any-table scatter's device time an angle."""
    pos = scan_table('jittered')
    res = {}
    for pg in (False, True):
        for bf16 in (False, True):
            tag = (f"9a jittered {'patch_grad ' if pg else ''}"
                   f"{'bf16' if bf16 else 'f32'}")
            r = run_table(tag, pos, table_config(bf16, patch_grad=pg),
                          profile=not bf16)
            if r['rec']._patch_mode != pg:
                raise AssertionError(f'{tag}: patch mode '
                                     f"{r['rec']._patch_mode}")
            del r['rec']
            res[tag] = r
    for bf16 in (False, True):
        ms, b, by = scatter_patches_ms(pos, bf16)
        log(f"9a scatter_patches_add ({'bf16' if bf16 else 'f32'} "
            f'cotangents, 529 patches [72, 72, 32, 2]): device {ms:.3f} ms '
            f'an angle ({by}); bound {b:.4f} ms; {CARD}')
        res[f"scatter {'bf16' if bf16 else 'f32'}"] = ms
    return res


def run_9b(work):
    """Phase 9b: per-angle jittered tables with ragged counts (529, 520,
    506 and 497 spots, each padded by its last spot, as
    ``reconstruct_ptychography`` pads them) through
    ``reconstruct_ptychography(common_probe_pos=False)`` on an
    ``ArrayDataset`` (the card has no h5py): 3 epochs, the first the
    warmup, patterns/s from its progress lines."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.io.data import ArrayDataset
    f = FLAGSHIP
    rng = np.random.default_rng(21)
    counts = (529, 520, 506, 497)
    tables = {f'probe_pos_px_{i}': scan_table('jittered', seed=30 + i)[:c]
              for i, c in enumerate(counts)}
    data = rng.random((4, 529, f['n_probe'], f['n_probe']), dtype=np.float32)
    for i, c in enumerate(counts):
        data[i, c:] = data[i, c - 1]
    theta = np.linspace(0, np.pi, 4, endpoint=False)
    ds = ArrayDataset(data, theta=theta, energy_ev=f['energy_ev'],
                      psize_cm=f['psize_cm'], **tables)
    reset_counts()
    reset_k6_layouts()
    torch.cuda.reset_peak_memory_stats()
    out = work / '9b'
    t0 = time.perf_counter()
    res = pt.reconstruct_ptychography(
        fname='unused.h5', obj_size=(f['n_obj'],) * 3, n_epochs=3,
        minibatch_size=f['mb'], learning_rate=1e-7, optimizer='adam',
        update_scheme='per angle', rotate_out_of_loop=True,
        common_probe_pos=False, binning=f['binning'], free_prop_cm='inf',
        probe_type='plane', dataset=ds, save_path=str(work),
        output_folder='9b', save_stdout=True, store_checkpoint=False,
        use_checkpoint=False)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    rates = epoch_rates(out)
    peak = torch.cuda.max_memory_allocated() / 1e9
    expect = {k: 0 for k in launches}
    expect.update(K1_FWD=12, K1_BWD=12, K1_FFT=24)
    log(f"9b per-angle ragged tables through reconstruct_ptychography: loss "
        f"history {list(res['loss_history'])}; patterns/s by epoch {rates} "
        f"(the first the warmup); call wall {wall:.2f} s; peak memory "
        f"{peak:.2f} GB; launches {launches}; {CARD}")
    if (launches != expect or len(rates) != 3
            or not np.all(np.isfinite(res['loss_history']))):
        raise AssertionError(f'9b: launches {launches}, expected {expect}')
    return dict(patterns_s=statistics.median(rates[1:]), peak_gb=peak)


def run_9e():
    """Phase 9e: the streaming rotation.  At 256^3 ``'on'`` against
    ``'off'`` on the same inputs (the largest loss difference; the two
    forms are equal in exact arithmetic and here bit for bit).  Then
    1024^3 with one angle and a 40x40 scan at stride 24 (minibatch 40):
    ``'auto'`` must engage; its peak memory, and ``'off'``'s beside it
    where ``'off'`` fits on the card."""
    res = {}
    pos = scan_table('grid')
    runs = {}
    for mode in ('on', 'off'):
        r = run_table(f'9e stream {mode} 256^3', pos,
                      table_config(stream_rotation=mode))
        if r['rec']._stream_rot != (mode == 'on'):
            raise AssertionError(f"9e {mode}: streaming "
                                 f"{r['rec']._stream_rot}")
        del r['rec']
        runs[mode] = r
    diff = float(np.max(np.abs(np.subtract(runs['on']['losses'],
                                           runs['off']['losses']))))
    log(f"9e 256^3: 'on' against 'off' losses largest difference {diff:.3e};"
        f" patterns/s on {runs['on']['patterns_s']:.1f} off "
        f"{runs['off']['patterns_s']:.1f}; peak on "
        f"{runs['on']['peak_gb']:.2f} GB off {runs['off']['peak_gb']:.2f} GB")
    if diff > 1e-6 * abs(runs['off']['losses'][0]):
        raise AssertionError('9e: streaming changes the losses')
    res['256'] = runs
    n, s, k = 1024, 24, 40
    xs = 8 + s * np.arange(k)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    big = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    for mode in ('auto', 'off'):
        tag = f'9e 1024^3 stream {mode}'
        try:
            r = run_table(tag, big, table_config(
                n=n, minibatch_size=k, stream_rotation=mode), n_theta=1,
                obj0=np.zeros((n, n, n, 2), np.float32),
                profile=mode == 'auto')
        except torch.cuda.OutOfMemoryError as e:
            # 'off' is measured where it fits; 'auto' must.
            if mode == 'auto':
                raise
            r, why = None, str(e).splitlines()[0]
        if r is None:
            import gc
            gc.collect()
            torch.cuda.empty_cache()
            log(f'{tag}: does not fit on the card ({why})')
            res['1024 off'] = None
            continue
        engaged = r['rec']._stream_rot
        log(f"{tag}: streaming engaged {engaged}; peak memory "
            f"{r['peak_gb']:.2f} GB of "
            f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f}; "
            f"{r['patterns_s']:.1f} patterns/s")
        if engaged != (mode == 'auto'):
            raise AssertionError(f'{tag}: streaming {engaged}')
        del r['rec']
        res[f'1024 {mode}'] = r
        torch.cuda.empty_cache()
    return res


def run_9f():
    """Phase 9f: ``exact_grad_rotation=True`` on the flagship (the binned
    gradient expanded by repeat, then the rotation's transpose), with the
    rotate-back's device time an angle beside the interp form's (the
    fused expand and -theta gather) at the flagship's [256, 256, 32, 2]
    binned gradient."""
    from adorym_tpu_torch.ops.rotate import (rotate_adjoint,
                                             rotate_expanded_from_binned_z)
    r = run_table('9f exact rotate-back', scan_table('grid'),
                  table_config(exact_grad_rotation=True), profile=True)
    del r['rec']
    gen = torch.Generator(device='cuda').manual_seed(31)
    n = FLAGSHIP['n_obj']
    g = torch.randn((n, n, n // 8, 2), device='cuda', generator=gen)

    # The angles on the card, so that a CUDA graph can capture the calls.
    th, nth = torch.tensor([0.7, -0.7], device='cuda')

    def exact():
        return rotate_adjoint(torch.repeat_interleave(g, 8, dim=2)[:, :, :n],
                              th)

    def interp():
        return rotate_expanded_from_binned_z(g, nth, 8, n)
    ms = {'exact': device_ms(exact, 5)[0], 'interp': device_ms(interp, 5)[0]}
    log(f"9f rotate-back an angle at [256, 256, 32, 2]: exact (repeat + "
        f"transpose) {ms['exact']:.3f} ms, interp (fused gather) "
        f"{ms['interp']:.3f} ms device time; {CARD}")
    r['rotate_back_ms'] = ms
    return r


def small_table_agrees(kind):
    """Phase 9 (small): CUDA against the CPU on a small configuration of
    each new branch of the per-angle path, 2 epochs of GD at 32^3 with a
    16^2 probe, the per-epoch losses within 1e-4, no K6 row copied.
    Returns the CUDA run's launches."""
    import adorym_tpu_torch as pt
    import adorym_tpu_torch.utils.profiling as tprof
    from types import SimpleNamespace
    from adorym_tpu_torch.models import ptychography
    rng = np.random.default_rng(6)
    n_theta = 3
    theta = np.linspace(0, np.pi, n_theta, endpoint=False)
    xs = np.arange(4) * 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    grid = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    jit = grid + rng.integers(-2, 3, grid.shape)
    stag = grid.copy()
    stag[4:8, 1] += 2
    stag[12:16, 1] += 2
    per_angle = np.stack([grid + rng.integers(-2, 3, grid.shape)
                          for _ in range(n_theta)])
    train = dict(minibatch_size=4, learning_rate=1e-3, optimizer='gd',
                 update_scheme='per angle', rotate_out_of_loop=True)
    case = {'padded_chunks': (grid, {}, 8e6),
            'staggered': (stag, {}, None),
            'jittered': (jit, {}, None),
            'jittered_patch_grad': (jit, dict(patch_grad=True), None),
            'randomized': (grid, dict(randomize_probe_pos=True), None),
            'per_angle': (per_angle, {}, None),
            'per_angle_accumulate': (per_angle,
                                     dict(rotate_out_of_loop=False), None),
            'per_angle_immediate': (per_angle,
                                    dict(update_scheme='immediate',
                                         rotate_out_of_loop=False), None),
            'stream': (stag, dict(stream_rotation='on'), 8e6),
            'exact': (grid, dict(exact_grad_rotation=True), None),
            'no_patch_form': (grid, {}, None)}[kind]
    pos, extra, cap = case
    train.update(extra)
    if cap:
        # K1's chunk budget on the CPU too: chunks of 3 of the 4 batches
        # an angle on both devices, the rotation in 8 y chunks.
        train['fused_multislice'] = 'on'
    model = (SimpleNamespace(predict=ptychography.predict)
             if kind == 'no_patch_form' else None)
    data = rng.random((n_theta, pos.shape[-2], 16, 16)).astype(np.float32)
    obj0 = (rng.random((32, 32, 32, 2)) * 1e-3).astype(np.float32)
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(32, 32, 32), probe_size=(16, 16),
                             energy_ev=5000., psize_cm=1e-7,
                             free_prop_cm='inf', binning=2),
        train=pt.TrainConfig(**train))
    hbm = tprof.hbm_limit_bytes
    if cap:
        tprof.hbm_limit_bytes = lambda device=None: cap
    out = {}
    try:
        reset_counts()
        reset_k6_layouts()
        for dev in ('cuda', 'cpu'):
            rec = pt.Reconstructor(cfg, data=data, probe_pos=pos,
                                   theta_ls=theta, obj_init=obj0.copy(),
                                   probe_init=probe_modes(16, 1), model=model,
                                   device=dev)
            out[dev] = [rec.run_epoch(e) for e in range(2)]
            if dev == 'cuda':
                launches, layouts = launch_counts(), k6_layouts()
                info = (rec._fuse_g, rec._patch_mode, rec._stream_rot)
    finally:
        tprof.hbm_limit_bytes = hbm
    rel = np.max(np.abs(np.subtract(out['cuda'], out['cpu']))
                 / np.abs(out['cpu']))
    log(f'9 small {kind}: losses cuda {out["cuda"]} cpu {out["cpu"]} rel '
        f'{rel:.3e} (tol 1e-4); (chunk, patch mode, streaming) {info}; '
        f'launches {launches}; K6 layouts {layouts}')
    if not rel < 1e-4:
        raise AssertionError(f'9 small {kind}: CUDA and CPU losses disagree')
    if launches['K1_FWD'] == 0 or layouts['copy']:
        raise AssertionError(f'9 small {kind}: launches {launches}, K6 '
                             f'layouts {layouts}')
    return launches


#: Phase 9's small cases and the K6 launches of each CUDA run (2 epochs
#: of 3 angles): one a grid row on the row branches, 3 rows a chunk and 2
#: chunks an angle (the last padded) where the capacity is patched.
SMALL_TABLES = {'padded_chunks': 36, 'staggered': 24, 'jittered': 0,
                'jittered_patch_grad': 0, 'randomized': 0, 'per_angle': 0,
                'per_angle_accumulate': 0, 'per_angle_immediate': 0,
                'stream': 36, 'exact': 0, 'no_patch_form': 0}


def slice14_runs(work, kernels):
    """Phase 9: the small CUDA-CPU agreements of each new branch, then
    9a-9f at the flagship's width.  9d's runs give the per-angle chunk-row
    records of K6 their launches."""
    for kind, k6 in SMALL_TABLES.items():
        launches = small_table_agrees(kind)
        if launches['K6'] != k6:
            raise AssertionError(f'9 small {kind}: K6 {launches["K6"]}, '
                                 f'expected {k6}')
    stamp('phase 9 small')
    res = {'9a': run_9a()}
    stamp('phase 9a')
    res['9b'] = run_9b(work)
    res['9c'] = {}
    for pg in (False, True):
        tag = f"9c randomized{' patch_grad' if pg else ''} f32"
        r = run_table(tag, scan_table('grid'), table_config(
            randomize_probe_pos=True, patch_grad=pg), profile=not pg)
        del r['rec']
        res['9c'][tag] = r
    stamp('phases 9b, 9c')
    res['9d'] = {}
    for bf16 in (False, True):
        tag = f"9d staggered {'bf16' if bf16 else 'f32'}"
        r = run_table(tag, scan_table('staggered'), table_config(bf16),
                      profile=not bf16)
        if (r['rec']._grid_scatter_rows is not None
                or r['rec']._rowgrid_stride != 8 or not r['launches']['K6']):
            raise AssertionError(f'{tag}: not the row-by-row branch')
        del r['rec']
        res['9d'][tag] = r
        name = '(bfloat16)' if bf16 else '(float32)'
        for k in kernels:
            if k['path'] == '9d' and k['name'].endswith(name):
                k['launches'] = r['launches'][k['counter']]
    stamp('phase 9d')
    res['9e'] = run_9e()
    stamp('phase 9e')
    res['9f'] = run_9f()
    stamp('phase 9f')
    summary = []
    for ph in ('9a', '9c', '9d'):
        summary += [f"{t} {r['patterns_s']:.1f} patterns/s, peak "
                    f"{r['peak_gb']:.2f} GB" for t, r in res[ph].items()
                    if isinstance(r, dict)]
    summary.append(f"9b {res['9b']['patterns_s']:.1f} patterns/s")
    for t, r in res['9e'].items():
        if t != '256':
            summary.append(f'9e {t}: ' + ('does not fit' if r is None else
                                          f"{r['patterns_s']:.1f} patterns/s"
                                          f", peak {r['peak_gb']:.2f} GB"))
    summary.append(f"9f {res['9f']['patterns_s']:.1f} patterns/s")
    log('phase 9: ' + '; '.join(summary) + f'; {CARD}')
    return res


# -- phase 10 ----------------------------------------------------------------

def second_order_config(optimizer, unknown_type='delta_beta', n=32, pn=16,
                        binning=2, mb=4, immediate=True):
    import adorym_tpu_torch as pt
    return pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(n,) * 3, probe_size=(pn, pn),
                             energy_ev=5000., psize_cm=1e-7,
                             free_prop_cm='inf', binning=binning),
        train=pt.TrainConfig(minibatch_size=mb, learning_rate=1e-3,
                             optimizer=optimizer,
                             update_scheme=('immediate' if immediate
                                            else 'per angle'),
                             unknown_type=unknown_type))


def line_search_evals():
    from adorym_tpu_torch.optim import second_order as so
    return so.LINE_SEARCH_EVALS['count']


def second_order_expect(optimizer, pair, n_b, evals):
    """Each kernel's launches over ``n_b`` second-order batches: CG one
    forward and backward pair for the batch's gradient and one forward a
    line-search evaluation; Curveball five forwards (the gradient, the
    curvature's linearization, its two forward-mode products, the
    trust-region loss), four backwards and two tangents a batch."""
    counts = {k: 0 for k in launch_counts()}
    if optimizer == 'cg':
        counts.update({f'{pair}_FWD': n_b + evals, f'{pair}_BWD': n_b,
                       f'{pair}_FFT': 2 * n_b + evals})
    else:
        counts.update({f'{pair}_FWD': 5 * n_b, f'{pair}_BWD': 4 * n_b,
                       f'{pair}_FFT': 9 * n_b, f'TANGENT_{pair}': 2 * n_b})
    return counts


def small_second_order_agrees(optimizer, unknown_type, dev='cuda'):
    """Phase 10 (small): CG or Curveball on a 32^3 object (16^2 probe, a
    4x4 grid at stride 4, 2 angles, minibatch 4, binning 2, the immediate
    scheme) on ``dev`` and on the CPU, an epoch of 8 updates: each
    batch's loss within 1e-4 (a longer run of CG parts by rounding, as
    the JAX package's and the port's do on the CPU), and on ``dev`` each
    batch's launches of K1 (delta_beta) or K5 (real_imag) and of the
    tangent.  The delta_beta data are random;
    the real_imag data are simulated from a near-vacuum object (random
    data drive CG's first real_imag steps past the f32 range of the
    slices' products, in the JAX package too)."""
    import adorym_tpu_torch as pt
    rng = np.random.default_rng(10)
    theta = np.linspace(0, np.pi, 2, endpoint=False)
    xs = np.arange(4) * 4
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    cfg = second_order_config(optimizer, unknown_type)
    data = rng.random((2, len(pos), 16, 16)).astype(np.float32)
    obj0 = (rng.random((32, 32, 32, 2)) * 1e-3).astype(np.float32)
    if unknown_type == 'real_imag':
        obj0[..., 0] += 1.0
        truth = (rng.random(obj0.shape) * 2e-2).astype(np.float32)
        truth[..., 0] += 1.0
        data = pt.simulate(cfg, truth, probe_modes(16, 1), pos, theta,
                           device='cpu')
    out = {}
    reset_counts()
    evals0 = line_search_evals()
    for d in (dev, 'cpu'):
        rec = pt.Reconstructor(cfg, data=data, probe_pos=pos, theta_ls=theta,
                               obj_init=obj0.copy(),
                               probe_init=probe_modes(16, 1), device=d)
        out[d] = []
        rec.run_epoch(0, callback=lambda e, b, loss: out[d].append(loss))
        if d == dev:
            launches, evals = launch_counts(), line_search_evals() - evals0
    rel = np.max(np.abs(np.subtract(out[dev], out['cpu']))
                 / np.abs(out['cpu']))
    pair = 'K1' if unknown_type == 'delta_beta' else 'K5'
    expect = second_order_expect(optimizer, pair, 8, evals)
    log(f'10 small {optimizer} {unknown_type}: losses {dev} {out[dev]} cpu '
        f'{out["cpu"]} rel {rel:.3e} (tol 1e-4); launches {launches}; '
        f'line-search evaluations {evals}; {CARD}')
    if not rel < 1e-4:
        raise AssertionError(f'10 small {optimizer} {unknown_type}: the '
                             f'devices disagree')
    if dev == 'cuda' and any(launches[k] != v for k, v in expect.items()):
        raise AssertionError(f'10 small {optimizer} {unknown_type}: '
                             f'launches {launches}, expected {expect}')


def check_tangents(dev='cuda'):
    """K1's and K5's forward-mode rules on the card at phase 10a's shapes
    (32 steps of 23 patches of 72^2; K1 with the Fraunhofer far field
    folded, K5 with a non-paraxial transfer function) against forward mode
    through the plain FFT scan (``multislice_fused_plain``, cuFFT), f32,
    within 1e-5 of the largest value; with the times of K1's forward
    kernel, of the forward under forward mode (the kernel, then the
    tangent) and of the tangent alone.  Returns {metric: ms}."""
    import torch.autograd.forward_ad as fwAD
    from adorym_tpu_torch.ops import cuda_multislice as cm
    from adorym_tpu_torch.ops import cuda_multislice_fused as cmf
    from adorym_tpu_torch.ops import propagate as prop
    from adorym_tpu_torch.ops.fourier import fft2_and_shift
    S, N, n, k1, s = 32, 23, 72, 25.0, 1.0
    rng = np.random.default_rng(12)
    gen = torch.Generator(device=dev).manual_seed(12)

    def cplx(*shape):
        return torch.complex(
            torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev))

    db = torch.as_tensor(rng.uniform(0, 0.02, (S, 2, N, n, n)).astype(
        np.float32), device=dev)
    ddb = torch.randn(db.shape, generator=gen, device=dev)
    wave, dwave = cplx(1, N, n, n), cplx(1, N, n, n)
    h = prop.fresnel_kernel((n, n), (1.0, 1.0, 1.0), 0.1, 20.0, device=dev)
    fay, fax = prop.final_prop_mats((n, n), (1.0, 1.0), 0.1, 'inf',
                                    device=dev)[:2]
    out = {}
    with torch.no_grad():
        def k1_dual():
            with fwAD.dual_level():
                o = cm.multislice_db_stored_packed(
                    fwAD.make_dual(db, ddb), fwAD.make_dual(wave, dwave), h,
                    k1, s, fay, fax)
                return fwAD.unpack_dual(o).tangent

        def plain_dual(t, dt, hh, far):
            with fwAD.dual_level():
                o = cmf.multislice_fused_plain(
                    fwAD.make_dual(t, dt), fwAD.make_dual(wave, dwave), hh)
                if far:
                    o = fft2_and_shift(o)
                return fwAD.unpack_dual(o).tangent

        def plain_k1():
            t, dt = cm.modulator_tangent(db, ddb, k1, s)
            return plain_dual(t, dt, h, True)

        n0 = cm.TANGENT_LAUNCHES['K1']
        got, ref = k1_dual(), plain_k1()
        if cm.TANGENT_LAUNCHES['K1'] != n0 + 1:
            raise AssertionError('K1 jvp: the tangent did not run')
        _, rel = rel_err(got, ref)
        out['K1 tangent max_rel_err'] = rel
        out['K1f ms'] = time_ms(lambda: cm.multislice_db_stored_packed(
            db, wave, h, k1, s, fay, fax), 10)
        out['K1f + tangent ms'] = time_ms(k1_dual, 10)
        t, dt = cm.modulator_tangent(db, ddb, k1, s)
        _, rec = cm.multislice_db_stored_plain(db, wave, h, k1, s, fay, fax,
                                               records=True)
        far = (fay, fax.transpose(0, 1))
        out['tangent ms'] = time_ms(lambda: cm.multislice_tangent(
            t, dt, rec, dwave, h, far), 10)
        # Its bound: t, dt, the records, the incident wave's tangent, the
        # step kernel and the far-field mats read once, the exit wave's
        # tangent written once; two FFTs a step and the far field's two
        # matmuls a patch (complex, 8 real operations a multiply-add).
        tb = sum(x.numel() * x.element_size()
                 for x in (t, dt, rec, dwave, h) + far) + \
            dwave.numel() * dwave.element_size()
        tf = (2 * (S - 1) * N * 5 * n * n * np.log2(n * n)
              + N * 2 * 8 * n ** 3)
        out['tangent bound ms'] = bound(tb, tf)[0]
        out['tangent bytes'] = float(tb)
        out['plain forward mode ms'] = time_ms(plain_k1, 5)
        if not rel < 1e-5:
            raise AssertionError(f'K1 jvp against the plain scan: {rel:.3e}')
        hn = prop.fresnel_kernel((n, n), (1.0, 1.0, 1.0), 0.1, 20.0,
                                 fresnel_approx=False, device=dev)
        tt = torch.exp(1j * 0.1 * cplx(S, N, n, n).real).to(torch.complex64)
        dtt = cplx(S, N, n, n)

        def k5_dual():
            with fwAD.dual_level():
                o = cmf.multislice_fused(fwAD.make_dual(tt, dtt),
                                         fwAD.make_dual(wave, dwave), hn)
                return fwAD.unpack_dual(o).tangent

        n0 = cm.TANGENT_LAUNCHES['K5']
        got5, ref5 = k5_dual(), plain_dual(tt, dtt, hn, False)
        if cm.TANGENT_LAUNCHES['K5'] != n0 + 1:
            raise AssertionError('K5 jvp: the tangent did not run')
        _, rel5 = rel_err(got5, ref5)
        out['K5 tangent max_rel_err'] = rel5
        out['K5f + tangent ms'] = time_ms(k5_dual, 10)
        if not rel5 < 1e-5:
            raise AssertionError(f'K5 jvp against the plain scan: {rel5:.3e}')
    log('10 tangents (32 steps, 23 patches of 72^2, f32): ' + ', '.join(
        f'{k} {v:.4g}' for k, v in out.items()) + f'; {CARD}')
    return out


def epie_small_inputs(n=40, p=16, seed=0):
    """A weak object's Fraunhofer magnitudes on a 4x4 grid at stride 8 and
    a starting probe with a phase of its own (``tests/
    test_torch_conventional.py``'s inputs)."""
    rng = np.random.default_rng(seed)
    obj = (np.exp(0.5j * rng.random((n, n)))
           * (0.9 + 0.1 * rng.random((n, n)))).astype(np.complex64)
    yy, xx = np.mgrid[:p, :p] - (p - 1) / 2
    probe = (np.exp(-(yy ** 2 + xx ** 2) / 30)
             * np.exp(1j * rng.random((p, p)))).astype(np.complex64)
    xs = np.arange(0, n - p + 1, 8)
    gy, gx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([gy.ravel(), gx.ravel()], -1)
    data = np.stack([np.abs(np.fft.fftshift(np.fft.fft2(
        probe * obj[y:y + p, x:x + p]))) for y, x in pos]).astype(np.float32)
    probe0 = (np.exp(-(yy ** 2 + xx ** 2) / 40)
              * np.exp(1j * rng.random((p, p)))).astype(np.complex64)
    return data, probe0, pos, np.ones((n, n), np.complex64)


def small_conventional_agrees(dev='cuda'):
    """Phase 10 (small): ePIE (3 epochs; object and probe), the
    multi-distance CTF retrieval (128^2, 4 distances, affines and a safe
    zone; the phase map), the external CTF update (64^2 holograms, one
    epoch; the object) and the scipy bridge (Newton-CG with the GVP
    ``hessp``, 5 iterations on a 2-D problem; the object), each on ``dev``
    and on the CPU, within 1e-4 of the largest value."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch import conventional as conv
    from adorym_tpu_torch.models import multidist
    from adorym_tpu_torch.utils.initialize import initialize_probe
    errs = {}
    data, probe0, pos, obj0 = epie_small_inputs()
    res = {d: conv.epie_reconstruct(data, probe0, pos, obj0, alpha=0.8,
                                    n_epochs=3, device=d)
           for d in (dev, 'cpu')}
    errs['epie object'] = rel_err(res[dev][0].cpu(), res['cpu'][0])[1]
    errs['epie probe'] = rel_err(res[dev][1].cpu(), res['cpu'][1])[1]
    h = HOLO
    prj = holo_dataset(dev)[0].all_magnitudes()[0]
    # Affines in the warp's normalized coordinates (not the scipy pixel
    # form of HOLO's): a small shift, scale and shear.
    aff = np.tile(np.asarray([[1, 0, 0], [0, 1, 0]], np.float32), (4, 1, 1))
    aff[1:, 0, 2], aff[2, 1, 1], aff[3, 0, 1] = 0.01, 1.004, 0.002
    kw = dict(kappa=50.0, safe_zone_width=8, prj_affine_ls=aff)
    ph = {d: conv.multidistance_ctf(prj, h['dists'], h['energy_ev'],
                                    h['psize_cm'], device=d, **kw)
          for d in (dev, 'cpu')}
    errs['ctf phase'] = rel_err(ph[dev].cpu(), ph['cpu'])[1]
    n = 64
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(n, n, 1), probe_size=(n, n),
                             energy_ev=h['energy_ev'], psize_cm=h['psize_cm'],
                             free_prop_cm=h['dists'], n_dists=4,
                             two_d_mode=True, safe_zone_width=0),
        train=pt.TrainConfig(minibatch_size=1, learning_rate=1e-3,
                             optimizer='adam', ctf_kappa=200.0))
    holo = (1.0 + 0.05 * np.random.default_rng(2).random(
        (1, 4, n, n))).astype(np.float32)
    objs = {}
    for d in (dev, 'cpu'):
        rec = pt.Reconstructor(cfg, data=holo, probe_pos=np.zeros((1, 2)),
                               probe_init=initialize_probe((n, n), 'plane'),
                               obj_init=np.zeros((n, n, 1, 2), np.float32),
                               model=multidist, external_algorithm='ctf',
                               device=d)
        rec.run_epoch(0)
        objs[d] = rec.obj
    errs['ctf hook object'] = rel_err(torch.as_tensor(objs[dev]),
                                      torch.as_tensor(objs['cpu']))[1]
    x = {d: scipy_bridge_run(d, n=32, pn=16, stride=4, maxiter=5)['obj']
         for d in (dev, 'cpu')}
    errs['scipy bridge object'] = rel_err(torch.as_tensor(x[dev]),
                                          torch.as_tensor(x['cpu']))[1]
    log('10 small conventional and scipy bridge, device - CPU over the '
        'largest value: ' + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
        + f' (tol 1e-4); {CARD}')
    bad = [k for k, v in errs.items() if not v < 1e-4]
    if bad:
        raise AssertionError(f'10 small: the devices disagree on {bad}')


def blob_phantom(n, seed=0, delta=1e-4, beta=3e-6):
    """The adhesin demo's phantom (:func:`adhesin_phantom`: six Gaussian
    blobs) drawn at ``n^3``, delta up to ``delta`` and beta up to
    ``beta``, ``[n, n, n, 2]`` float32."""
    rng = np.random.default_rng(seed)
    g = (np.arange(n, dtype=np.float32) - 0.0)[:, None, None]
    vol = np.zeros((n, n, n), np.float32)
    for _ in range(6):
        c = rng.uniform(0.3 * n, 0.7 * n, 3).astype(np.float32)
        r = np.float32(rng.uniform(0.06 * n, 0.16 * n))
        vol += (np.exp(-(g - c[0]) ** 2 / (2 * r * r))
                * np.exp(-(g[:, :, 0][None] - c[1]) ** 2 / (2 * r * r))
                * np.exp(-(g[:, 0, 0][None, None] - c[2]) ** 2
                         / (2 * r * r)))
    vol /= vol.max()
    return np.stack([vol * delta, vol * beta], -1)


def run_second_order_flagship(optimizer):
    """Phase 10a: CG or Curveball at the flagship's full width (256^3, a
    23x23 scan of 72^2 patterns at stride 8, binning 8, Fraunhofer,
    delta_beta) on the immediate scheme at minibatch 23, 2 angles: a
    warmup and a timed epoch of 46 batches, every one through the
    second-order step (the view rotation of the whole object inside
    autodiff).  The data are simulated on the card from
    :func:`blob_phantom` at 256^3: on random data (8a-8d's) each
    minibatch's line search accepts its first trial, the suggested step
    doubles every batch, and CG's object leaves the f32 range within the
    epoch (the JAX package's rule; its CG does the same).  Checks each
    batch's launches (K1 alone, the tangent under Curveball) and returns
    {metric: value}."""
    import adorym_tpu_torch as pt
    f = FLAGSHIP
    pos = flagship_positions()
    rng = np.random.default_rng(8)
    theta = np.linspace(0, np.pi, LOOP_THETA, endpoint=False)
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(f['n_obj'],) * 3,
                             probe_size=(f['n_probe'],) * 2,
                             energy_ev=f['energy_ev'], psize_cm=f['psize_cm'],
                             free_prop_cm='inf', binning=f['binning']),
        train=pt.TrainConfig(minibatch_size=f['mb'], optimizer=optimizer,
                             update_scheme='immediate'))
    probe = probe_modes(f['n_probe'], 1)
    data = pt.simulate(cfg, blob_phantom(f['n_obj']), probe, pos, theta,
                       minibatch_size=f['mb'])
    obj0 = (rng.random((f['n_obj'],) * 3 + (2,), dtype=np.float32)
            * np.float32(1e-6))
    rec = pt.Reconstructor(cfg, data=data, probe_pos=pos, theta_ls=theta,
                           obj_init=obj0, probe_init=probe)
    del obj0
    if not rec.second_order or rec._band or rec._accum:
        raise AssertionError(f'10a {optimizer}: not the second-order step')
    torch.cuda.reset_peak_memory_stats()
    batch_losses = []
    t0 = time.perf_counter()
    losses = [rec.run_epoch(0)]
    warm = time.perf_counter() - t0
    reset_counts()
    evals0 = line_search_evals()
    t0 = time.perf_counter()
    losses.append(rec.run_epoch(
        1, callback=lambda e, b, loss: batch_losses.append(loss)))
    wall = time.perf_counter() - t0
    launches = launch_counts()
    evals = line_search_evals() - evals0
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_b = LOOP_THETA * len(pos) // f['mb']
    expect = second_order_expect(optimizer, 'K1', n_b, evals)
    rate = LOOP_THETA * len(pos) / wall
    per = {k: launches[k] / n_b for k in ('K1_FWD', 'K1_BWD', 'TANGENT_K1')}
    log(f'10a {optimizer} flagship (256^3, 72^2, 23x23, binning 8, '
        f'immediate, minibatch 23, 2 angles): losses {losses}; the timed '
        f'epoch\'s batch losses {batch_losses[0]:.5g} .. '
        f'{batch_losses[-1]:.5g} (min {min(batch_losses):.5g}); warmup '
        f'{warm:.3f} s; timed epoch {wall:.3f} s, {rate:.1f} patterns/s; '
        f'peak memory {peak:.2f} GB; per batch K1f {per["K1_FWD"]:.2f}, K1b '
        f'{per["K1_BWD"]:.2f}, tangent {per["TANGENT_K1"]:.2f}'
        + (f', line-search evaluations {evals / n_b:.2f}'
           if optimizer == 'cg' else '') + f'; {CARD}')
    if not np.all(np.isfinite(losses)) or launches != expect:
        raise AssertionError(f'10a {optimizer}: losses {losses}, launches '
                             f'{launches}, expected {expect}')
    del rec
    torch.cuda.empty_cache()
    return dict(patterns_s=rate, peak_gb=peak, per_batch=per,
                evals_per_batch=evals / n_b, s_epoch=wall)


def run_epie_siemens(work):
    """Phase 10b: ePIE through ``reconstruct_ptychography(use_epie=True)``
    on BASELINE #2's data (:func:`siemens_data`: 256^2, 256 spots of
    72^2, intensities; the demo's keywords, the first of its five probe
    modes) on the card: runs of 2 and 22 epochs, their difference over 20
    the seconds an epoch.  Returns {metric: value}."""
    import adorym_tpu_torch as pt
    ds, _, _ = siemens_data()
    walls, res = [], None
    for n_epochs in (2, 22):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pt.reconstruct_ptychography(
            fname='data.h5', save_path=str(work), output_folder=None,
            n_epochs=n_epochs, use_epie=True, dataset=ds, **SIEMENS_KW)
        walls.append(time.perf_counter() - t0)
    s_epoch = (walls[1] - walls[0]) / 20
    star = siemens_star(SIEMENS['n'])
    edge = SIEMENS['n'] // 8
    sl = slice(edge, SIEMENS['n'] - edge)
    corr = float(np.corrcoef(np.angle(res['obj'])[sl, sl].ravel(),
                             star[sl, sl].ravel())[0, 1])
    log(f'10b ePIE on BASELINE #2 (256^2, 256 spots of 72^2): {s_epoch:.4f} '
        f's an epoch ({walls[1]:.2f} s for 22 epochs, {walls[0]:.2f} s for '
        f'2); phase correlation with the star {corr:.4f}; {CARD}')
    if not (np.all(np.isfinite(res['obj'])) and np.isfinite(corr)):
        raise AssertionError('10b: non-finite ePIE result')
    return dict(s_epoch=s_epoch, corr=corr)


def holo_dataset(dev='cuda'):
    """BASELINE #4's holograms at the demo's size (phase 7d): four
    distances of the demo's phantom simulated on ``dev`` by the
    multi-distance model, each warped by its true affine (scipy, as the
    demo), as intensities in an ``ArrayDataset``.  Returns (the dataset,
    the phantom)."""
    import adorym_tpu_torch as pt
    from scipy.ndimage import affine_transform
    from adorym_tpu_torch.io import data as io_data
    from adorym_tpu_torch.models import multidist
    from adorym_tpu_torch.utils.initialize import initialize_probe
    h = HOLO
    n, dists = h['n'], h['dists']
    obj = holo_phantom(n)
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(n, n, 1), probe_size=(n, n),
                             energy_ev=h['energy_ev'], psize_cm=h['psize_cm'],
                             free_prop_cm=dists, n_dists=len(dists),
                             two_d_mode=True, safe_zone_width=0),
        train=pt.TrainConfig(minibatch_size=1, unknown_type='real_imag'))
    pos = np.array([[0.0, 0.0]])
    data = pt.simulate(cfg, obj, initialize_probe((n, n), 'plane'), pos,
                       model=multidist, device=dev)
    for d in range(1, len(dists)):
        a = h['affines'][d]
        data[0, d] = affine_transform(data[0, d], a[:, :2], offset=a[:, 2],
                                      order=1, mode='nearest')
    ds = io_data.ArrayDataset(data ** 2, theta=np.zeros(1), probe_pos_px=pos,
                              energy_ev=h['energy_ev'],
                              psize_cm=h['psize_cm'])
    return ds, obj


def run_ctf_hook(work, n_epochs=20, dev='cuda'):
    """Phase 10c: BASELINE #4's holograms (:func:`holo_dataset`) through
    ``reconstruct_ptychography`` with ``update_using_external_algorithm=
    'ctf'``: the true distances, the affines refined (Adam) and read by
    each retrieval, a delta_beta object (the update writes the retrieved
    phase into the delta channel), ``n_epochs`` one-step epochs; then
    ``multidistance_ctf`` alone on the same holograms (unregistered): ms
    a call and the phase correlation with the phantom.
    Returns {metric: value}."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch import conventional as conv
    h = HOLO
    n = h['n']
    ds, obj = holo_dataset(dev)
    truth = np.arctan2(obj[..., 0, 1], obj[..., 0, 0])
    sl = slice(8, n - 8)

    def corr(phase):
        return float(np.corrcoef(phase[sl, sl].ravel(),
                                 truth[sl, sl].ravel())[0, 1])

    t0 = time.perf_counter()
    res = pt.reconstruct_ptychography(
        fname='data.h5', save_path=str(work), output_folder=None,
        obj_size=(n, n, 1), two_d_mode=True, free_prop_cm=h['dists'],
        safe_zone_width=0, n_epochs=n_epochs, minibatch_size=1,
        random_guess_means_sigmas=(0., 0., 0., 0.), probe_type='plane',
        optimizer='adam', learning_rate=1e-3, optimize_prj_affine=True,
        prj_affine_learning_rate=1e-3, update_scheme='immediate',
        unknown_type='delta_beta', raw_data_type='intensity',
        update_using_external_algorithm='ctf', use_checkpoint=False,
        save_intermediate=False, dataset=ds, device=dev)
    wall = time.perf_counter() - t0
    hook_corr = corr(res['obj'][..., 0, 0])
    prj = torch.as_tensor(ds.all_magnitudes()[0], device=dev)
    ms = time_ms(lambda: conv.multidistance_ctf(
        prj, h['dists'], h['energy_ev'], h['psize_cm'], kappa=50.0,
        device=dev), 20)
    alone = conv.multidistance_ctf(prj, h['dists'], h['energy_ev'],
                                   h['psize_cm'], kappa=50.0,
                                   device=dev).cpu().numpy()
    alone_corr = corr(alone)
    log(f'10c BASELINE #4 (128^2, 4 distances) with the external CTF '
        f'update: losses {res["loss_history"][:2].tolist()} .. '
        f'{res["loss_history"][-2:].tolist()}; {wall / n_epochs:.5f} s an '
        f'epoch '
        f'({wall:.2f} s for {n_epochs}); phase correlation {hook_corr:.4f}; '
        f'multidistance_ctf alone {ms:.4f} ms a call, phase correlation '
        f'{alone_corr:.4f}; {CARD}')
    if not (np.all(np.isfinite(res['obj'])) and np.isfinite(alone_corr)):
        raise AssertionError('10c: non-finite CTF result')
    return dict(s_epoch=wall / n_epochs, corr=hook_corr, ctf_ms=ms,
                ctf_corr=alone_corr)


def scipy_bridge_run(dev='cuda', n=128, pn=32, stride=8, maxiter=10):
    """``scipy_minimize_object`` with Newton-CG and the Gauss-Newton
    ``hessp`` on a full-batch 2-D ptychography problem (``n``^2 object, a
    ``pn``^2 probe with a phase of its own, a grid at ``stride``, data
    simulated from a smooth phantom on ``dev``), ``maxiter`` iterations
    from a small random start.  Returns {metric: value}."""
    import adorym_tpu_torch as pt
    from scipy.ndimage import gaussian_filter
    from adorym_tpu_torch.models import base as model_base
    from adorym_tpu_torch.optim.scipy_bridge import scipy_minimize_object
    rng = np.random.default_rng(13)
    xs = np.arange(0, n - pn + 1, stride)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    sm = gaussian_filter(rng.random((n, n, 1)), (3, 3, 0))
    truth = np.stack([sm * 2e-2, sm * 5e-4], -1).astype(np.float32)
    py = np.mgrid[:pn, :pn] - (pn - 1) / 2
    amp = np.exp(-(py ** 2).sum(0) / (pn * pn / 8))
    ph = rng.random((pn, pn))
    probe = np.stack([amp * np.cos(ph), amp * np.sin(ph)],
                     -1)[None].astype(np.float32)
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(n, n, 1), probe_size=(pn, pn),
                             energy_ev=5000., psize_cm=1e-7,
                             free_prop_cm='inf', two_d_mode=True),
        train=pt.TrainConfig(minibatch_size=len(pos)))
    data = pt.simulate(cfg, truth, probe, pos, device=dev)
    obj0 = (rng.random(truth.shape) * 1e-3).astype(np.float32)
    rec = pt.Reconstructor(cfg, data=data, probe_pos=pos, obj_init=obj0,
                           probe_init=probe, device=dev)
    batch = rec._batch(0, np.arange(len(pos)))
    measured = rec._dataset()[0]

    def loss_obj_fn(o):
        return rec.loss_fn({**rec.params, 'obj': o}, batch, measured)

    def pred_fn(o):
        return rec.model.predict({**rec.params, 'obj': o}, batch, cfg,
                                 rec.pad_arr)

    def loss_pred_fn(pred):
        return model_base.mismatch_loss(pred, measured)

    with torch.no_grad():
        before = float(loss_obj_fn(rec.params['obj']))
    t0 = time.perf_counter()
    x = scipy_minimize_object(loss_obj_fn, obj0, method='Newton-CG',
                              pred_fn=pred_fn, loss_pred_fn=loss_pred_fn,
                              options={'maxiter': maxiter}, device=dev)
    wall = time.perf_counter() - t0
    with torch.no_grad():
        after = float(loss_obj_fn(torch.as_tensor(x, device=rec.device)))
    return dict(obj=x, before=before, after=after, s=wall)


def run_scipy_bridge():
    """Phase 10d: :func:`scipy_bridge_run` at 128^2 (a 32^2 probe, 13x13
    spots at stride 8, all 169 in one batch), 10 Newton-CG iterations on
    the card."""
    r = scipy_bridge_run()
    log(f'10d scipy bridge (Newton-CG, GVP hessp, 2-D 128^2, 169 patterns '
        f'of 32^2, full batch, 10 iterations): loss {r["before"]:.6e} -> '
        f'{r["after"]:.6e} in {r["s"]:.3f} s; {CARD}')
    if not (np.isfinite(r['after']) and r['after'] < r['before']):
        raise AssertionError('10d: the loss did not fall')
    return r


def slice15_runs(work):
    """Phase 10: the small device-CPU agreements and the tangents, then
    10a-10d."""
    for optimizer in ('cg', 'curveball'):
        for unknown_type in ('delta_beta', 'real_imag'):
            small_second_order_agrees(optimizer, unknown_type)
    tangents = check_tangents()
    small_conventional_agrees()
    stamp('phase 10 small')
    res = {o: run_second_order_flagship(o) for o in ('cg', 'curveball')}
    stamp('phase 10a')
    res['10b'] = run_epie_siemens(work)
    res['10c'] = run_ctf_hook(work)
    res['10d'] = run_scipy_bridge()
    stamp('phases 10b-10d')
    log(f"phase 10: 10a CG {res['cg']['patterns_s']:.1f} patterns/s "
        f"({res['cg']['evals_per_batch']:.2f} line-search evaluations a "
        f"batch), Curveball {res['curveball']['patterns_s']:.1f} patterns/s;"
        f" tangent {tangents['tangent ms']:.3f} ms beside K1f "
        f"{tangents['K1f ms']:.3f} ms; 10b ePIE {res['10b']['s_epoch']:.4f} "
        f"s an epoch; 10c {res['10c']['s_epoch']:.5f} s an epoch, "
        f"multidistance_ctf {res['10c']['ctf_ms']:.4f} ms; 10d "
        f"{res['10d']['s']:.3f} s; {CARD}")
    return res


# -- phase 11 ----------------------------------------------------------------

#: Phase 11d's object edge: 1280^3 keeps 16.8 GB of object and 33.6 GB of
#: Adam moments on the host.  The card's host had 103.6e9 bytes available
#: (``tools/host_link_torch.py`` on the NVIDIA H100 80GB HBM3 host, 700 W),
#: over the 100 GB that 1280^3 needs with room; 1152^3 (about 37 GB) is the
#: size for a host with less.
BEYOND_N = 1280


def host_link_rates(gb=1.0):
    """The page-locked copy rate between the host and the card, GB/s, host
    to device, device to host and both at once, over ``gb``-GB blocks
    registered as the offloaded blocks are (CUDA events, 3 copies after a
    warmup)."""
    from adorym_tpu_torch.offload import HostArena
    n = int(gb * 1e9)
    arena = HostArena(torch.device('cuda'))
    ha, hb = arena.zeros((n,), torch.uint8), arena.zeros((n,), torch.uint8)
    da = torch.empty(n, dtype=torch.uint8, device='cuda')
    db = torch.empty(n, dtype=torch.uint8, device='cuda')
    up, down = torch.cuda.Stream(), torch.cuda.Stream()

    def both():
        cur = torch.cuda.current_stream()
        up.wait_stream(cur)
        down.wait_stream(cur)
        with torch.cuda.stream(up):
            da.copy_(ha, non_blocking=True)
        with torch.cuda.stream(down):
            hb.copy_(db, non_blocking=True)
        cur.wait_stream(up)
        cur.wait_stream(down)
    rates = {}
    for name, fn, nbytes in (
            ('h2d', lambda: da.copy_(ha, non_blocking=True), n),
            ('d2h', lambda: hb.copy_(db, non_blocking=True), n),
            ('both', both, 2 * n)):
        rates[name] = nbytes / (time_ms(fn, 3) * 1e-3) / 1e9
    del da, db, ha, hb, arena
    torch.cuda.empty_cache()
    return rates


def pcie_bound_s(h2d, d2h, rates):
    """The least seconds ``h2d`` bytes up and ``d2h`` bytes down can take
    over the link: each way at its rate, and both at once at theirs."""
    return max(h2d / (rates['h2d'] * 1e9), d2h / (rates['d2h'] * 1e9),
               (h2d + d2h) / (rates['both'] * 1e9))


def flagship_data(n_theta=None):
    """The per-angle flagship's inputs as :func:`run_flagship` makes them:
    random magnitudes (seed 0), the 23x23 table, ``n_theta`` angles."""
    f = FLAGSHIP
    n_theta = n_theta or f['n_theta']
    pos = flagship_positions()
    data = np.random.default_rng(0).random(
        (n_theta, len(pos), f['n_probe'], f['n_probe']), dtype=np.float32)
    theta = np.linspace(0, np.pi, n_theta, endpoint=False)
    return data, pos, theta


def drive(rec, epochs, tag):
    """``rec.run_epoch`` over ``epochs``; returns (losses, each epoch's
    wall seconds, launches, peak GB), peak memory and launches counted
    over these epochs alone."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for ep in epochs:
        t0 = time.perf_counter()
        losses.append(rec.run_epoch(ep))
        walls.append(time.perf_counter() - t0)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f'{tag}: losses {losses}')
    return losses, walls, launches, peak


def expect_chunk_launches(rec, launches, n_angles, tag):
    """The per-angle path's kernels: one K1 pair a gradient chunk, one K2
    a chunk of whole rows of one complete grid (else K6 a row)."""
    n_b = -(-rec.n_pos // rec.cfg.train.minibatch_size)
    g = min(rec._fuse_g, n_b)
    chunks = -(-n_b // g) * n_angles
    want = {'K1_FWD': chunks, 'K1_BWD': chunks}
    if rec._grid_scatter_rows == g:
        want['K2'] = chunks
    else:
        want['K6'] = g * chunks
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad:
        raise AssertionError(f'{tag}: launches (got, expected) {bad}')
    return want


def run_11a(work, rates):
    """Phase 11a: the per-angle delta_beta flagship (4 angles, f32) with
    its data read through a FastLoader over a raw file in the work dir,
    beside the device-resident run on the same inputs: equal losses,
    patterns/s of each."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.io.fastloader import FastLoader
    data, pos, theta = flagship_data()
    raw = work / '11a.raw'
    data.tofile(raw)
    cfg = flagship_config(False, 'delta_beta')
    obj0 = np.zeros((FLAGSHIP['n_obj'],) * 3 + (2,), np.float32)
    res = {}
    for src in ('resident', 'loader'):
        ld = (FastLoader(str(raw), data.shape, max_batch=len(pos))
              if src == 'loader' else None)
        rec = pt.Reconstructor(cfg, data=ld if ld else data, probe_pos=pos,
                               theta_ls=theta, obj_init=obj0)
        if rec.stager().resident != (src == 'resident'):
            raise AssertionError(f'11a {src}: resident '
                                 f'{rec.stager().resident}')
        losses, walls, launches, peak = drive(rec, range(3), f'11a {src}')
        expect_chunk_launches(rec, launches, 3 * len(theta), f'11a {src}')
        rates_ = [data.shape[0] * len(pos) / w for w in walls[1:]]
        res[src] = dict(losses=losses, patterns_s=statistics.median(rates_),
                        peak_gb=peak, staged=rec.stager().staged_rows)
        if ld:
            ld.close()
        del rec
        torch.cuda.empty_cache()
    nbytes = data[0].nbytes
    bound = pcie_bound_s(nbytes, 0, rates) * 1e3
    log(f"11a per-angle flagship f32, data through a FastLoader: losses "
        f"{res['loader']['losses']} (resident {res['resident']['losses']}); "
        f"{res['loader']['patterns_s']:.1f} patterns/s against "
        f"{res['resident']['patterns_s']:.1f} resident; rows staged "
        f"{res['loader']['staged']}; an angle's rows {nbytes / 1e6:.1f} MB, "
        f"their PCIe bound {bound:.3f} ms; peak {res['loader']['peak_gb']:.2f}"
        f" GB; {CARD}")
    if res['loader']['losses'] != res['resident']['losses']:
        raise AssertionError('11a: the loader run changes the losses')
    return res


def run_11b(rates):
    """Phase 11b: the per-angle and the immediate flagship with the Adam
    moments on the host in 8 slabs, against their resident runs (a warmup
    and 3 timed epochs each, 2 on the immediate path): losses within 1e-6
    relative, the object within 1e-6 of its largest value; patterns/s (the
    timed epochs' median) and peak memory."""
    import adorym_tpu_torch as pt
    res = {}
    data, pos, theta = flagship_data()
    obj0 = np.zeros((FLAGSHIP['n_obj'],) * 3 + (2,), np.float32)
    obj_bytes = obj0.nbytes
    for path in ('delta_beta', 'immediate'):
        base = flagship_config(False, path)
        n_ep = 4 if path == 'delta_beta' else 3
        out = {}
        for off in (False, True):
            cfg = base.replace(parallel=pt.ParallelConfig(
                offload_optimizer_state=off, offload_slabs=8))
            rec = pt.Reconstructor(cfg, data=data, probe_pos=pos,
                                   theta_ls=theta, obj_init=obj0)
            if rec._off_slabbed != off:
                raise AssertionError(f'11b {path}: slabbed {off}')
            losses, walls, launches, peak = drive(rec, range(n_ep),
                                                  f'11b {path}')
            wall = statistics.median(walls[1:])
            out[off] = dict(losses=losses, wall=wall, peak_gb=peak,
                            obj=rec.obj, launches=launches,
                            updates=rec.i_opt_batch // n_ep,
                            patterns_s=data.shape[0] * len(pos) / wall)
            del rec
            torch.cuda.empty_cache()
        a, b = out[True], out[False]
        rel = max(abs(x - y) / abs(y) for x, y in zip(a['losses'],
                                                     b['losses']))
        err = float(np.max(np.abs(a['obj'] - b['obj']))
                    / max(np.max(np.abs(b['obj'])), 1e-30))
        bound = pcie_bound_s(2 * obj_bytes * a['updates'],
                             2 * obj_bytes * a['updates'], rates)
        log(f"11b {path} flagship f32, moments on the host in 8 slabs: "
            f"losses {a['losses']} (resident {b['losses']}), largest "
            f"relative difference {rel:.3e}, object {err:.3e} of its largest"
            f" value; {a['patterns_s']:.1f} patterns/s against "
            f"{b['patterns_s']:.1f}, epoch {a['wall']:.3f} s against "
            f"{b['wall']:.3f} ({a['updates']} updates an epoch, their "
            f"moments' PCIe bound {bound:.3f} s); peak {a['peak_gb']:.2f} GB "
            f"against {b['peak_gb']:.2f}; launches {a['launches']}; {CARD}")
        if rel > 1e-6 or err > 1e-6:
            raise AssertionError(f'11b {path}: offloaded moments differ '
                                 f'({rel:.3e}, {err:.3e})')
        for v in out.values():
            del v['obj']
        res[path] = out
    return res


def offload_run(n, s, k, tag, epochs, rates, resident_losses=None):
    """One angle of an ``n``^3 object with a ``k`` x ``k`` scan at stride
    ``s`` (minibatch ``k``), object and moments offloaded (8 slabs), 9e's
    inputs: ``epochs`` epochs, the first the warmup.  Returns {metric:
    value}."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.utils.profiling import host_memory_rss_mb
    f = FLAGSHIP
    xs = 8 + s * np.arange(k)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    data = np.random.default_rng(0).random((1, len(pos), f['n_probe'],
                                            f['n_probe']), dtype=np.float32)
    cfg = table_config(n=n, minibatch_size=k).replace(
        parallel=pt.ParallelConfig(offload_optimizer_state=True,
                                   offload_slabs=8, offload_object=True))
    rss0 = host_memory_rss_mb()
    t0 = time.perf_counter()
    rec = pt.Reconstructor(cfg, data=data, probe_pos=pos,
                           theta_ls=np.zeros(1),
                           obj_init=np.zeros((n, n, n, 2), np.float32),
                           probe_init=probe_modes(f['n_probe'], 1))
    setup = time.perf_counter() - t0
    if not rec._obj_offloaded or not rec._angles:
        raise AssertionError(f'{tag}: object offload did not engage')
    losses, walls, launches, peak = drive(rec, range(epochs), tag)
    # What stays on the card between angles (the dataset, the probe), not
    # the chunk's buffers.
    resident_gb = torch.cuda.memory_allocated() / 1e9
    want = expect_chunk_launches(rec, launches, epochs, tag)
    rss = host_memory_rss_mb()
    obj_bytes = n ** 3 * 8
    bound = pcie_bound_s(4 * obj_bytes, 3 * obj_bytes, rates)
    timed = walls[1:]
    res = dict(losses=losses, walls=walls, setup_s=setup, peak_gb=peak,
               fuse_g=rec._fuse_g, resident_gb=resident_gb,
               host_rss_gb=rss * 2 ** 20 / 1e9,
               host_blocks_gb=rec._arena.nbytes / 1e9,
               rss_growth_gb=(rss - rss0) * 2 ** 20 / 1e9,
               patterns_s=len(pos) / statistics.median(timed),
               angle_s=statistics.median(timed), bound_s=bound,
               launches={k_: launches[k_] for k_ in
                         ('K1_FWD', 'K1_BWD', 'K2', 'K6')}, want=want)
    hbm = torch.cuda.get_device_properties(0).total_memory
    log(f"{tag}: {n}^3 ({obj_bytes / 1e9:.2f} GB of object, "
        f"{2 * obj_bytes / 1e9:.2f} GB of moments on the host), {k}x{k} "
        f"spots at stride {s}, minibatch {k}: losses {losses}; setup "
        f"{setup:.2f} s; angle walls {[round(w, 3) for w in walls]} s "
        f"(the first the warmup); {res['patterns_s']:.1f} patterns/s; "
        f"PCIe bound an angle {bound:.3f} s ({4 * obj_bytes / 1e9:.1f} GB "
        f"up, {3 * obj_bytes / 1e9:.1f} GB down at {rates['h2d']:.1f} / "
        f"{rates['d2h']:.1f} / {rates['both']:.1f} GB/s); peak device "
        f"memory {peak:.2f} GB of {hbm / 1e9:.1f}, {resident_gb:.3f} GB "
        f"resident between angles; fuse_g {rec._fuse_g} (chunk of "
        f"{min(rec._fuse_g, len(pos) // k)} batches); host blocks "
        f"{res['host_blocks_gb']:.2f} GB, host RSS {res['host_rss_gb']:.2f} "
        f"GB (grew {res['rss_growth_gb']:.2f} GB); launches "
        f"{res['launches']}; "
        f"{CARD}")
    if resident_losses is not None:
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                     resident_losses))
        res['rel_vs_resident'] = rel
        log(f'{tag}: against the resident run {resident_losses}: largest '
            f'relative difference {rel:.3e}')
        if rel > 1e-6:
            raise AssertionError(f'{tag}: offloaded losses differ ({rel})')
    del rec
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_11e():
    """Phase 11e: ``run_epochs(3)`` against three ``run_epoch`` calls on
    the immediate flagship (92 updates an epoch, the host-bound path): the
    same losses; the wall time of each."""
    import adorym_tpu_torch as pt
    data, pos, theta = flagship_data()
    obj0 = np.zeros((FLAGSHIP['n_obj'],) * 3 + (2,), np.float32)
    out = {}
    for how in ('run_epoch', 'run_epochs', 'run_epoch again'):
        rec = pt.Reconstructor(flagship_config(False, 'immediate'),
                               data=data, probe_pos=pos, theta_ls=theta,
                               obj_init=obj0)
        rec.run_epoch(0)                            # warmup
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == 'run_epochs':
            losses = rec.run_epochs(3, start_epoch=1)
        else:
            losses = [rec.run_epoch(ep) for ep in (1, 2, 3)]
        out[how] = dict(losses=losses, wall=time.perf_counter() - t0)
        del rec
        torch.cuda.empty_cache()
    log(f"11e immediate flagship f32, 3 epochs after a warmup: run_epochs "
        f"{out['run_epochs']['wall']:.3f} s, three run_epoch calls "
        f"{out['run_epoch']['wall']:.3f} s and {out['run_epoch again']['wall']:.3f}"
        f" s; losses {out['run_epochs']['losses']}; {CARD}")
    if not (out['run_epochs']['losses'] == out['run_epoch']['losses']
            == out['run_epoch again']['losses']):
        raise AssertionError(f'11e: losses {out}')
    return out


def slice16_runs(work, kernels, res_9e):
    """Phase 11: the host link's rates, then 11a-11e.  The K1, K2 and K6
    records of the per-angle and immediate f32 paths take 11d's (and 11b's
    immediate run's) launches as ``phase11_launches``."""
    rates = host_link_rates()
    log(f"11: host link, page-locked 1 GB blocks: host to device "
        f"{rates['h2d']:.2f} GB/s, device to host {rates['d2h']:.2f}, both "
        f"at once {rates['both']:.2f}; {CARD}")
    res = {'rates': rates, '11a': run_11a(work, rates)}
    stamp('phase 11a')
    res['11b'] = run_11b(rates)
    stamp('phase 11b')
    auto = res_9e.get('1024 auto')
    res['11c'] = offload_run(1024, 24, 40, '11c 1024^3 object offloaded', 3,
                             rates, auto['losses'][:3] if auto else None)
    stamp('phase 11c')
    res['11d'] = offload_run(BEYOND_N, 24, 50, f'11d {BEYOND_N}^3 beyond '
                             'the card', 2, rates)
    stamp('phase 11d')
    res['11e'] = run_11e()
    stamp('phase 11')
    counts = dict(res['11d']['launches'])
    imm = res['11b']['immediate'][True]['launches']
    for k in kernels:
        if not k['name'].endswith('(float32)'):
            continue
        if k['path'] == 'delta_beta' and k['counter'] in counts:
            k['phase11_launches'] = counts[k['counter']]
        elif k['path'] == 'immediate' and k['counter'] in imm:
            k['phase11_launches'] = imm[k['counter']]
    d = res['11d']
    log(f"phase 11: 11a loader {res['11a']['loader']['patterns_s']:.1f} "
        f"patterns/s (resident {res['11a']['resident']['patterns_s']:.1f}); "
        f"11b per angle {res['11b']['delta_beta'][True]['patterns_s']:.1f} "
        f"(resident {res['11b']['delta_beta'][False]['patterns_s']:.1f}), "
        f"immediate {res['11b']['immediate'][True]['patterns_s']:.1f} "
        f"(resident {res['11b']['immediate'][False]['patterns_s']:.1f}); "
        f"11c {res['11c']['patterns_s']:.1f} patterns/s, "
        f"{res['11c']['angle_s']:.3f} s an angle (bound "
        f"{res['11c']['bound_s']:.3f}), peak {res['11c']['peak_gb']:.2f} GB;"
        f" 11d {BEYOND_N}^3 {d['patterns_s']:.1f} patterns/s, "
        f"{d['angle_s']:.3f} s an angle (bound {d['bound_s']:.3f}), peak "
        f"{d['peak_gb']:.2f} GB, host blocks {d['host_blocks_gb']:.2f} GB; "
        f"11e run_epochs {res['11e']['run_epochs']['wall']:.3f} s against "
        f"{res['11e']['run_epoch']['wall']:.3f}; {CARD}")
    return res


# -- phase 12 ----------------------------------------------------------------

#: Ranks of phase 12's meshes; they share the one card through gloo.
P12_SHAPES = {'12a (2, 1)': (2, 1), '12a (1, 2)': (1, 2),
              '12a (2, 2)': (2, 2)}


def p12_gloo_cuda():
    """Which of gloo's collectives for CUDA tensors (the documented two,
    ``all_reduce`` and ``broadcast``) run on a small tensor of
    ``cuda:0``.  Point-to-point sends are not tried: gloo hands a CUDA
    tensor's device pointer to its socket and the process aborts
    (``writev ... Bad address``), so :mod:`adorym_tpu_torch.parallel.comm`
    stages ring shifts and all-gathers through page-locked host
    buffers."""
    import torch.distributed as dist
    t = torch.ones(4, device='cuda:0')
    out = {}
    for name, fn in (('all_reduce', lambda: dist.all_reduce(t.clone())),
                     ('broadcast', lambda: dist.broadcast(t.clone(), 0))):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = 'ok'
        except Exception as e:                           # noqa: BLE001
            out[name] = f'refused: {type(e).__name__}: {str(e)[:80]}'
    return out


def p12_config(kind, dp=1, op=1, offload=False, train=None):
    """The f32 flagship of ``kind`` on a ``dp x op`` mesh; ``train``
    overrides its training keywords (12a and 12b's GD runs)."""
    import dataclasses
    import adorym_tpu_torch as pt
    cfg = flagship_config(False, kind)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, **(train or {})))
    return dataclasses.replace(cfg, parallel=pt.ParallelConfig(
        data_axis=dp, object_axis=op, offload_optimizer_state=offload))


def p12_inputs(n_theta):
    from adorym_tpu_torch.utils.initialize import initialize_object
    data, pos, theta = flagship_data(n_theta)
    return dict(data=data, probe_pos=pos, theta_ls=theta,
                obj_init=initialize_object((FLAGSHIP['n_obj'],) * 3, seed=0))


def p12_updates(rec, kind):
    """The updates whose whole object gradient phase 12 compares with the
    one-rank run's: on the per-angle path every angle's, on the immediate
    one the epoch's first, the first whose band crosses the middle row
    (the slab boundary at op = 2) and the last.  Counted in the batches
    ``run_epoch(0)`` makes."""
    if kind != 'immediate':
        return set(range(rec.n_theta))
    batches = rec.make_batches(np.random.default_rng(rec.cfg.train.seed))
    py = rec.cfg.geometry.probe_size[0]
    mid = rec.cfg.geometry.obj_size[0] // 2
    y0 = [float(rec.probe_pos[inds[0], 0]) for _, inds in batches]
    cross = next(i for i, y in enumerate(y0) if y < mid < y + py)
    return {0, cross, len(batches) - 1}


def p12_hook(rec, keep, mesh=None):
    """Keep the object gradient that each update in ``keep`` (numbered
    from 0 in the run) hands the optimizer, as f32 numpy: the whole object
    on one rank, the rank's y slab on a mesh (on the ranks of dp = 0 only;
    the sum over 'dp' made the others' the same).  Returns the dict it
    fills."""
    grads = {}
    step = rec.apply_step
    n = [0]

    def hooked(g, *args, **kw):
        if n[0] in keep and (mesh is None or mesh.dp == 0):
            grads[n[0]] = g['obj'].detach().float().cpu().numpy()
        n[0] += 1
        return step(g, *args, **kw)
    rec.apply_step = hooked
    return grads


def p12_shapes(rec, kind):
    """What K1 and K6 take on this rank's mesh path: K1's patches a
    launch, K6's spots a grid row, rows a chunk and accumulator."""
    if kind == 'immediate':
        m = rec._mci
        return dict(N=m['mpp'], cols=m['mpp'], rows=1,
                    acc=(m['py'], m['X'] + m['px0'] + m['px1'], m['nzb'], 2))
    m = rec._mc
    return dict(N=m['g_rows'] * m['mp'], cols=m['mp'], rows=m['g_rows'],
                acc=(m['S_p'] + m['py'], m['X'] + m['px0'] + m['px1'],
                     m['nzb'], 2))


def p12_rank(kind, dp, op, n_theta, offload=False, train=None):
    """One rank of a phase-12 flagship mesh run, one epoch."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.parallel.mesh import make_mesh
    cfg = p12_config(kind, dp, op, offload, train)
    mesh = make_mesh(cfg.parallel, device='cuda:0')
    rec = pt.Reconstructor(cfg, mesh=mesh, **p12_inputs(n_theta))
    path = rec._mc if kind == 'delta_beta' else rec._mci
    if path is None:
        raise AssertionError(f'{kind} ({dp}, {op}): the mesh path declined: '
                             f'{rec._mc_decline_reasons}')
    if offload and not rec._off_state:
        raise AssertionError('12d: the moments are not offloaded')
    grads = ({} if offload
             else p12_hook(rec, p12_updates(rec, kind), mesh))
    out = p12_drive(rec, mesh, n_theta * rec.n_pos)
    out.update(grads=grads, shapes=p12_shapes(rec, kind))
    return out


def p12_drive(rec, mesh, n_patterns):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    mesh.comm.reset()
    rows = []
    t0 = time.perf_counter()
    losses = [rec.run_epoch(0, callback=lambda e, b, l: rows.append(l))]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    summary = mesh.comm.summary()
    peak = torch.cuda.max_memory_allocated() / 1e9
    obj = rec.obj
    return {'rank': mesh.rank, 'coord': (mesh.dp, mesh.op),
            'backend': mesh.comm.backend, 'losses': losses,
            'row_losses': rows, 'wall': wall,
            'patterns_s': n_patterns / wall, 'peak_gb': peak,
            'launches': {k: launches[k] for k in ('K1_FWD', 'K1_BWD', 'K6',
                                                  'K2')},
            'comm': summary, 'obj': obj if mesh.rank == 0 else None}


def p12_single(kind, n_theta, train=None):
    """The one-rank run on the card, one epoch: per-row losses, the
    gradients of :func:`p12_updates`, the object, peak memory."""
    import gc
    import adorym_tpu_torch as pt
    rec = pt.Reconstructor(p12_config(kind, train=train),
                           **p12_inputs(n_theta))
    grads = p12_hook(rec, p12_updates(rec, kind))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rows = []
    t0 = time.perf_counter()
    losses = [rec.run_epoch(0, callback=lambda e, b, l: rows.append(l))]
    torch.cuda.synchronize()
    out = {'losses': losses, 'row_losses': rows, 'grads': grads,
           'wall': time.perf_counter() - t0,
           'peak_gb': torch.cuda.max_memory_allocated() / 1e9,
           'obj': rec.obj, 'launches': launch_counts()}
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def p12_report(tag, outs):
    """Print a mesh run's ranks; returns the ranks' launches summed."""
    o0 = outs[0]
    world = len(outs)
    log(f'{tag}: backend {o0["backend"]}, {world} ranks, {world} a card '
        f'({CARD})')
    total = {}
    for o in outs:
        comm = '; '.join(f"{k} {v['count']}x {v['bytes'] / 1e6:.2f} MB "
                         f"{v['seconds']:.3f} s" for k, v in
                         sorted(o['comm'].items()))
        log(f"  rank {o['rank']} {o['coord']}: launches {o['launches']}, "
            f"peak {o['peak_gb']:.2f} GB, {o['patterns_s']:.1f} patterns/s "
            '(wiring on one shared card, not scaling); collectives: '
            f'{comm}')
        for k, v in o['launches'].items():
            total[k] = total.get(k, 0) + v
    return total


def p12_check(tag, mesh_out, single, hold_all, tol=1e-5):
    """The mesh run against the one-rank run: every grid row's loss at
    rtol ``tol``, and the updates of :func:`p12_updates`, each one's
    object gradient assembled from the op ranks' slabs, within ``tol`` of
    the one-rank gradient's largest value (f32 sums in other orders).
    ``hold_all`` (the runs at rate 0, whose object stays at its start):
    every such update is held; else (Adam at the flagship's rate) the
    first alone, the only one that starts from the same object in both
    runs, and the others' differences are printed."""
    got = np.asarray(mesh_out[0]['row_losses'])
    want = np.asarray(single['row_losses'])
    if got.shape != want.shape:
        raise AssertionError(f'{tag}: {got.shape} row losses against '
                             f'{want.shape}')
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    slabs = sorted((o for o in mesh_out if o['coord'][0] == 0),
                   key=lambda o: o['coord'][1])
    g_rel = {}
    for u, g1 in sorted(single['grads'].items()):
        g = np.concatenate([o['grads'][u] for o in slabs], 0)
        if g.shape != g1.shape:
            raise AssertionError(f'{tag}: update {u} gradient {g.shape} '
                                 f'against {g1.shape}')
        g_rel[u] = float(np.max(np.abs(g - g1)) / np.max(np.abs(g1)))
    held = g_rel if hold_all else {0: g_rel[0]}
    log(f'{tag}: {len(got)} row losses against one rank, max rel '
        f'{rel:.2e} (tol {tol}); object gradient of updates '
        f'{sorted(g_rel)}: max |diff| / max |g| '
        f'{[f"{v:.2e}" for v in g_rel.values()]} (tol {tol}, held at '
        f'updates {sorted(held)})')
    if rel > tol or max(held.values()) > tol:
        raise AssertionError(f'{tag}: disagrees with the one-rank run')
    return rel, g_rel


def p12_gather_rank(seed=0):
    """12e on one rank: the flagship's padded, binned object [260, 264,
    32, 2] split over 'op', 529 windows of 72^2."""
    from adorym_tpu_torch.config import ParallelConfig
    from adorym_tpu_torch.ops.patches import extract_patches
    from adorym_tpu_torch.parallel import halo
    from adorym_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(ParallelConfig(data_axis=2, object_axis=2),
                     device='cuda:0')
    g = torch.Generator(device='cuda:0').manual_seed(seed)
    Y, X, Z = 260, 264, 32
    obj = torch.rand((Y, X, Z, 2), device='cuda:0', generator=g)
    pos = flagship_positions().astype(np.int64) + 4
    st, sz = mesh.slab(Y)
    sl = obj[st:st + sz].clone().requires_grad_(True)
    mesh.comm.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = halo.sharded_patch_gather(sl, pos, (72, 72), mesh)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    w = torch.rand(got.shape, device='cuda:0', generator=g)
    t0 = time.perf_counter()
    (got * w).sum().backward()
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    o = obj.clone().requires_grad_(True)
    ref = extract_patches(o, pos, (72, 72))
    (ref * w).sum().backward()
    fwd = float((got.detach() - ref.detach()).abs().max())
    vjp = float((sl.grad - o.grad[st:st + sz]).abs().max())
    return {'rank': mesh.rank, 'fwd_err': fwd, 'vjp_err': vjp,
            'vjp_scale': float(o.grad.abs().max()), 'fwd_s': t_fwd,
            'bwd_s': t_bwd, 'comm': mesh.comm.summary(),
            'host_copies': len(mesh.comm.host_copies),
            'peak_gb': torch.cuda.max_memory_allocated() / 1e9}


def p12_baseline5_rank(work):
    """12c on one rank: BASELINE #5's reconstruction through
    ``reconstruct_ptychography`` on a distributed object (op = 2), random
    data for 2 angles, one epoch."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.io import data as io_data
    import torch.distributed as dist
    n, pn = 256, 72
    grid = (n - pn) // 8 + 1
    xs = np.arange(grid) * 8 + (n - (grid - 1) * 8 - pn) // 2
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    n_theta = 2
    data = np.random.default_rng(5).random((n_theta, len(pos), pn, pn),
                                           dtype=np.float32)
    theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    ds = io_data.ArrayDataset(data, theta=theta, probe_pos_px=pos,
                              energy_ev=5000.0, psize_cm=1e-7)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = pt.reconstruct_ptychography(
        fname='data_cone_256.h5', save_path=str(work),
        output_folder='recon_cone256_mesh', obj_size=(n, n, n), n_epochs=1,
        learning_rate=1e-7, energy_ev=5000.0, psize_cm=1e-7,
        minibatch_size=grid, binning=8, free_prop_cm='inf',
        probe_type='gaussian', probe_mag_sigma=12, probe_phase_sigma=12,
        probe_phase_max=0.4, optimizer='adam', rotate_out_of_loop=True,
        update_scheme='per angle', use_checkpoint=False,
        n_batch_per_checkpoint=grid * 30,
        distribution_mode='distributed_object', parallel_object_axis=2,
        dataset=ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    return {'rank': dist.get_rank(), 'wall': wall,
            'loss_history': res['loss_history'].tolist(),
            'shape': tuple(res['obj'].shape),
            'finite': bool(np.all(np.isfinite(res['obj']))),
            'launches': {k: launches[k] for k in ('K1_FWD', 'K1_BWD', 'K6',
                                                  'K2')},
            'peak_gb': torch.cuda.max_memory_allocated() / 1e9,
            'patterns_s': n_theta * len(pos) / wall}


def p12_kernels(shapes_a, shapes_b):
    """K1 and K6 at the shapes phase 12's mesh paths give them, each held
    against its plain version as at the flagships' shapes: 12a's per-angle
    chunk on a rank of the (2, 2) mesh (K1 at its rows times its share of
    a row's spots; K6 on each row of the chunk's z-major gradient, read in
    place, into the rank's slab accumulator) and 12b's share of an
    immediate row (K1 and K6 at ``mb / 4`` spots, K6 into the band)."""
    recs = []
    for tag, sh in (('12a', shapes_a), ('12b', shapes_b)):
        path = 'mesh' + tag
        recs += check_multislice(torch.float32, 1e-4, 1e-3, N=sh['N'],
                                 path=path, label=f' mesh {tag}')
        acc = sh['acc']
        if (sh['rows'] - 1) * 8 + 72 > acc[0] or (
                (sh['cols'] - 1) * 8 + 72 > acc[1]):
            raise AssertionError(f'K6 {tag}: rows of {sh} do not fit')
        gen = torch.Generator(device='cuda').manual_seed(71)
        cot = torch.randn((acc[2], 2, sh['N'], 72, 72), device='cuda',
                          generator=gen).permute(2, 3, 4, 0, 1)
        acc0 = torch.randn(acc, device='cuda', generator=gen)
        recs += check_k6(f"K6 scatter_rowgrid mesh {tag} rows of "
                         f"{sh['cols']} (float32)", cot, acc0, sh['rows'],
                         path, 10, in_place=sh['rows'] > 1)
        del cot, acc0
        torch.cuda.empty_cache()
    return recs


def slice17_runs(work, kernels):
    """Phase 12: meshes as gloo ranks on the one card, 12a-12e; then K1
    and K6 at the shapes 12a (2, 2) and 12b gave them, whose records take
    those runs' launches on rank 0."""
    import gc
    from adorym_tpu_torch.parallel.launch import RankPool
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    n_theta = 2
    single = p12_single('delta_beta', n_theta)
    single_imm = p12_single('immediate', n_theta)
    log(f"12: one rank on the card: per angle {single['losses']} peak "
        f"{single['peak_gb']:.2f} GB; immediate {single_imm['losses']} "
        f"peak {single_imm['peak_gb']:.2f} GB; {CARD}")
    # GD at rate 0: every update's gradient at the starting object, held
    # at each recorded update (12a's two angles; 12b's one angle, 23
    # updates).
    gd0 = dict(optimizer='gd', learning_rate=0.0)
    single_gd = p12_single('delta_beta', n_theta, gd0)
    single_imm_gd = p12_single('immediate', 1, gd0)
    res = {}
    with RankPool(2, 'cuda:0', threads=2) as pool2:
        log(f'12: gloo on CUDA tensors: {pool2.run(p12_gloo_cuda)[0]}')
        for tag in ('12a (2, 1)', '12a (1, 2)'):
            dp, op = P12_SHAPES[tag]
            out = pool2.run(p12_rank, 'delta_beta', dp, op, n_theta)
            p12_report(tag, out)
            p12_check(tag, out, single, False)
            if op == 2 and max(o['peak_gb'] for o in out) >= single[
                    'peak_gb']:
                raise AssertionError(f'{tag}: a rank peaks above the one-'
                                     'rank run')
            res[tag] = out
        out = pool2.run(p12_baseline5_rank, str(work))
        o0 = out[0]
        log(f"12c BASELINE #5 distributed object (op = 2): losses "
            f"{o0['loss_history']}, object {o0['shape']}, launches "
            f"{[o['launches'] for o in out]}, peaks "
            f"{[round(o['peak_gb'], 2) for o in out]} GB, "
            f"{o0['patterns_s']:.1f} patterns/s (wiring on one shared card, "
            f"not scaling); {CARD}")
        if not (o0['finite'] and o0['shape'] == (256, 256, 256, 2)
                and np.all(np.isfinite(o0['loss_history']))
                and all(o['launches']['K6'] > 0 and o['launches']['K2'] == 0
                        for o in out)):
            raise AssertionError('12c: BASELINE #5 on the mesh failed')
    stamp('phase 12a-12c (two ranks)')
    with RankPool(4, 'cuda:0', threads=2) as pool4:
        tag = '12a (2, 2)'
        out = pool4.run(p12_rank, 'delta_beta', 2, 2, n_theta)
        p12_report(tag, out)
        p12_check(tag, out, single, False)
        res[tag] = out
        out = pool4.run(p12_rank, 'delta_beta', 2, 2, n_theta, train=gd0)
        p12_report('12a (2, 2) gradients (GD at rate 0)', out)
        p12_check('12a (2, 2) gradients (GD at rate 0)', out, single_gd,
                  True)
        out = pool4.run(p12_rank, 'immediate', 2, 2, n_theta)
        p12_report('12b immediate (2, 2)', out)
        p12_check('12b immediate (2, 2)', out, single_imm, False)
        res['12b'] = out
        out = pool4.run(p12_rank, 'immediate', 2, 2, 1, train=gd0)
        tag_b = '12b immediate (2, 2) gradients (GD at rate 0, one angle)'
        p12_report(tag_b, out)
        p12_check(tag_b, out, single_imm_gd, True)
        out = pool4.run(p12_rank, 'delta_beta', 2, 2, n_theta, True)
        p12_report('12d (2, 2) moments on the host', out)
        same = np.array_equal(out[0]['obj'], res[tag][0]['obj']) and (
            out[0]['row_losses'] == res[tag][0]['row_losses'])
        log(f'12d: offloaded mesh run bit-equal to the resident one: {same}')
        if not same:
            raise AssertionError('12d: the offloaded mesh run differs')
        g = pool4.run(p12_gather_rank)
        for o in g:
            log(f"12e rank {o['rank']}: forward max |diff| {o['fwd_err']:.1e}"
                f", VJP {o['vjp_err']:.1e} (of {o['vjp_scale']:.2f}), "
                f"{o['fwd_s'] * 1e3:.1f} ms forward, {o['bwd_s'] * 1e3:.1f} "
                f"ms backward, host copies {o['host_copies']}, collectives "
                f"{o['comm']}; {CARD}")
            if o['fwd_err'] != 0 or o['vjp_err'] > 1e-5 * o['vjp_scale']:
                raise AssertionError('12e: the halo gather disagrees')
    log(f'phase 12 runs: {time.perf_counter() - t_phase:.1f} s; {CARD}')
    del single, single_imm, single_gd, single_imm_gd
    for o in res.values():
        for r in o:
            r['grads'] = None
    recs = p12_kernels(res[tag][0]['shapes'], res['12b'][0]['shapes'])
    for k in recs:
        run = res[tag] if k['path'] == 'mesh12a' else res['12b']
        k['launches'] = run[0]['launches'][k['counter']]
    kernels += recs
    log(f'phase 12: {time.perf_counter() - t_phase:.1f} s; {CARD}')
    stamp('phase 12')
    return res


# -- phase 13 ----------------------------------------------------------------

@contextlib.contextmanager
def api_spy():
    """While the block runs, the package's ``simulate`` and
    ``reconstruct_ptychography`` (the names the port's demos call) and the
    API's ``Reconstructor`` record each call; a ``reconstruct_ptychography``
    call sets the launch counts to 0 just before it runs and reads them
    just after.  Yields ``{'simulate': [seconds, ...], 'recon': [{'s',
    'results', 'launches', 'peak_gb'}, ...], 'recs': [(reconstructor,
    kwargs), ...]}``; every argument passes through unchanged."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch import api
    spy = {'simulate': [], 'recon': [], 'recs': []}
    orig_sim, orig_recon = pt.simulate, pt.reconstruct_ptychography
    orig_rec = api.Reconstructor

    def simulate(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_sim(*args, **kwargs)
        spy['simulate'].append(time.perf_counter() - t0)
        return out

    def reconstruct(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = orig_recon(*args, **kwargs)
        torch.cuda.synchronize()
        spy['recon'].append({'s': time.perf_counter() - t0, 'results': res,
                             'launches': launch_counts(),
                             'peak_gb': torch.cuda.max_memory_allocated()
                             / 1e9, 'kwargs': kwargs})
        return res

    class Recording(orig_rec):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            spy['recs'].append((self, dict(kwargs, cfg=args[0])))

    pt.simulate, pt.reconstruct_ptychography = simulate, reconstruct
    api.Reconstructor = Recording
    try:
        yield spy
    finally:
        pt.simulate, pt.reconstruct_ptychography = orig_sim, orig_recon
        api.Reconstructor = orig_rec


def port_demo(name):
    import importlib
    return importlib.import_module(f'adorym_tpu_torch.demos.{name}')


def epoch_ends(out_dir):
    """Each epoch's end on the loss log's clock (``convergence/
    loss_rank_0.txt``, seconds since the Reconstructor opened it) and the
    per-batch losses, in logged order."""
    rows = np.genfromtxt(Path(out_dir) / 'convergence' / 'loss_rank_0.txt',
                         delimiter=',', names=True)
    eps = np.atleast_1d(rows['i_epoch']).astype(int)
    ends = [float(np.atleast_1d(rows['time'])[eps == e].max())
            for e in np.unique(eps)]
    return ends, np.atleast_1d(rows['loss'])


def run_13a(work, n_theta=20, n_epochs=2, scale=1):
    """Phase 13a: BASELINE #5, the cone demo (``adorym_tpu_torch/demos/
    multislice_ptycho_256_theta.py``) at full width through its ``main``:
    a 256^3 cone, 20 angles of 24x24 72^2 patterns, binning 8, Adam at
    lr 1e-7, per angle with the rotation out of the loop, 2 epochs, its
    data simulated on the card (no h5py there: an ArrayDataset).  Held: the
    second epoch's loss below the first; K1f, K1b and K2 once a gradient
    chunk (the flagship's launches, ROADMAP "the main path"); the first
    angle's loss (the mean of its 23 row losses, all taken before its
    update) within 1e-4 relative of the same angle's on the CPU, from the
    same data and initial object and probe (the CPU's ``angle_step`` on a
    Reconstructor built with the card run's arguments)."""
    import adorym_tpu_torch as pt
    demo = port_demo('multislice_ptycho_256_theta')
    data = work / 'cone_256' / f'data_cone_{256 // scale}.h5'
    with api_spy() as spy:
        corr = demo.main(n_theta=n_theta, n_epochs=n_epochs, data=str(data),
                         scale=scale, output_folder='recon_13a')
    (rec, kw), = spy['recs']
    call, = spy['recon']
    res, launches = call['results'], call['launches']
    losses = list(res['loss_history'])
    n_pat = rec.n_theta * rec.n_pos
    ends, batch_losses = epoch_ends(data.parent / 'recon_13a')
    rates = [n_pat / (b - a) for a, b in zip([0.0] + ends[:-1], ends)]
    per_angle = {k: launches[k] / (n_theta * n_epochs)
                 for k in ('K1_FWD', 'K1_BWD', 'K2', 'K6')}
    want = expect_chunk_launches(rec, launches, n_theta * n_epochs, '13a')
    # The first angle of the first epoch and its rows, as the run drew
    # them; its losses on the CPU before the update.
    groups = rec._group_batches(rec.make_batches(
        np.random.default_rng(rec.cfg.train.seed)))
    i_theta, inds_list = groups[0]
    card = batch_losses[:len(inds_list)]
    t0 = time.perf_counter()
    cpu_kw = {k: v for k, v in kw.items()
              if k not in ('cfg', 'device', 'output_folder', 'mesh')}
    cpu = pt.Reconstructor(kw['cfg'], device='cpu', **cpu_kw)
    cpu_losses = cpu.angle_step(i_theta, inds_list).detach().double().numpy()
    cpu_s = time.perf_counter() - t0
    del cpu
    rel = abs(card.mean() - cpu_losses.mean()) / abs(cpu_losses.mean())
    rel_rows = np.abs(card - cpu_losses) / np.abs(cpu_losses)
    log(f'13a BASELINE #5 demo ({rec.cfg.geometry.obj_size} cone, '
        f'{n_theta} angles x {rec.n_pos} patterns of '
        f'{rec.cfg.geometry.probe_size}, binning {rec.cfg.geometry.binning}, '
        f'per angle, {n_epochs} epochs): simulate '
        f'{spy["simulate"][0]:.2f} s on the card; epoch losses {losses}; '
        f'patterns/s by epoch {rates} (the first with the Reconstructor '
        f'set-up, the second with a checkpoint); call wall {call["s"]:.2f} s; peak device '
        f'memory {call["peak_gb"]:.2f} GB; phantom delta correlation '
        f'{corr:.4f}; launches an angle {per_angle} (expected {want} over '
        f'the run); first angle ({i_theta}) loss {card.mean()!r} on the '
        f'card, {cpu_losses.mean()!r} on the CPU (rel {rel:.2e}, rows up '
        f'to {rel_rows.max():.2e}; CPU {cpu_s:.1f} s); {CARD}')
    if not (np.all(np.isfinite(losses)) and losses[1] < losses[0]):
        raise AssertionError(f'13a: the loss did not fall: {losses}')
    if not rel < 1e-4:
        raise AssertionError(f'13a: card and CPU first-angle losses differ '
                             f'by {rel:.2e}')
    geo = rec.cfg.geometry
    rows = int(round(np.sqrt(rec.n_pos)))
    return {'corr': corr, 'losses': losses, 'rates': rates,
            'peak_gb': call['peak_gb'], 'sim_s': spy['simulate'][0],
            'per_angle': per_angle, 'rel': rel, 'launches': launches,
            'n_pos': rec.n_pos, 'rows': rows,
            'size': geo.obj_size[0] + int(np.sum(rec.pad_arr[0])),
            'channels': 2 * (geo.obj_size[2] // geo.binning)}


def _into(mod, work):
    """A 2-D demo's data file and outputs under ``work``, as
    ``tests/test_demos.py`` points them."""
    if hasattr(mod, 'DATA_DIR'):
        mod.DATA_DIR = str(work)
    if hasattr(mod, 'DATA'):
        mod.DATA = str(work / os.path.basename(mod.DATA))


#: Phase 13b: each demo at the size and epoch count of
#: ``tests/test_demos.py`` and that file's threshold (the phase
#: correlation; the probe demo's phase and probe correlations; the
#: position-correction demo's refined positions nearer the truth than the
#: nominal grid).
DEMOS_13B = [
    ('2d_ptychography_experimental_data',
     dict(n_epochs=30, output_folder='recon_ci'), 0.45),
    ('2d_multidist_holography_w_affine',
     dict(n_epochs=150, output_folder='recon_ci'), 0.6),
    ('2d_ptychography_w_probe_optimization',
     dict(n_epochs=400, output_folder='recon_ci'), (0.9, 0.9)),
    ('2d_multidist_holography_w_position_correction',
     dict(n_epochs=150, output_folder='recon_ci'), 0.85),
    ('2d_ptychography_position_correction', {}, None),
    ('multislice_tomography_64',
     dict(n_epochs=10, n_theta=12, output_folder='recon_ci',
          data='d64.h5'), 0.25),
    ('multislice_ptycho_256_theta',
     dict(n_theta=8, n_epochs=12, scale=4, data='cone.h5',
          output_folder='recon_ci'), 0.3),
]


def run_13b(work):
    """Phase 13b: the seven demos through their ``main`` on the card
    (:data:`DEMOS_13B`), each with its data simulated on the card; the 2-D
    ones launch no multislice kernel (one slice), the tomography demo K1
    (the generic step), the cone demo K1 and K2 once a gradient chunk.
    Returns {demo: (value, wall s, patterns/s)}."""
    import gc
    out = {}
    for name, kwargs, threshold in DEMOS_13B:
        # The peak of each demo's own run (the last run's Reconstructor
        # sits in reference cycles until collected).
        gc.collect()
        torch.cuda.empty_cache()
        mod = port_demo(name)
        d = work / f'13b_{name}'
        d.mkdir()
        kwargs = dict(kwargs)
        if 'data' in kwargs:
            kwargs['data'] = str(d / kwargs['data'])
        saved = {k: getattr(mod, k) for k in ('DATA', 'DATA_DIR')
                 if hasattr(mod, k)}
        _into(mod, d)
        t0 = time.perf_counter()
        try:
            with api_spy() as spy:
                value = mod.main(**kwargs)
        finally:
            for k, v in saved.items():
                setattr(mod, k, v)
        wall = time.perf_counter() - t0
        (rec, _), = spy['recs']
        call, = spy['recon']
        res, launches = call['results'], call['launches']
        n_epochs = len(res['loss_history'])
        rate = rec.n_theta * rec.n_pos * n_epochs / call['s']
        ran = {k: v for k, v in launches.items() if v}
        if name == '2d_ptychography_position_correction':
            nominal, true, _ = mod.problem()
            err = true - nominal
            err = err - err.mean(0)
            before = float(np.abs(err).mean())
            after = float(np.abs(res['probe_pos_correction'][0]
                                 - err).mean())
            value = (before, after)
            ok = after < before
        elif isinstance(threshold, tuple):
            ok = all(v > t for v, t in zip(value, threshold))
        else:
            ok = value > threshold
        if name.startswith('2d'):
            ok = ok and not ran
        elif name == 'multislice_tomography_64':
            ok = ok and launches['K1_FWD'] > 0 and launches['K1_BWD'] > 0
        else:
            expect_chunk_launches(rec, launches, rec.n_theta * n_epochs,
                                  f'13b {name}')
        what = ('residual px (nominal, refined)' if threshold is None
                else 'correlation')
        log(f'13b {name}: {what} {value} (threshold {threshold}); '
            f'{n_epochs} epochs, losses '
            f'{res["loss_history"][0]:.6e} -> {res["loss_history"][-1]:.6e}; '
            f'wall {wall:.2f} s (reconstruction {call["s"]:.2f} s, simulate '
            f'{sum(spy["simulate"]):.2f} s); {rate:.1f} patterns/s; peak '
            f'{call["peak_gb"]:.3f} GB; kernels launched {ran}; {CARD}')
        if not (ok and np.all(np.isfinite(res['loss_history']))):
            raise AssertionError(f'13b {name}: {value} against {threshold}, '
                                 f'launches {ran}')
        out[name] = (value, wall, rate)
    return out


def run_13c(work):
    """Phase 13c: the user tools' computations on the card against the
    CPU: ``retrieve_probe`` (the ER loop) on ``tests/test_tools.py``'s
    disk, 300 epochs with that test's two assertions, and at 10 epochs
    against the CPU (1e-5 of the largest magnitude: ER on a hard-edged
    disk is chaotic, the CPU test's reason); the multi-distance CTF
    retrieval on BASELINE #4's holograms (1e-5); the affine-warp and the
    registration tools on TIFF folders (1e-5 of the largest value, the
    shifts equal); ``profiler_trace`` writing a trace with the card's
    kernels."""
    from adorym_tpu_torch.conventional import multidistance_ctf
    from adorym_tpu_torch.io.output import read_tiff, write_tiff
    from adorym_tpu_torch.tools import (affine_transform_images as aff,
                                        initialize_probe_er as er,
                                        register_multidistance_data as reg)
    from adorym_tpu_torch.utils.profiling import profiler_trace
    n = 32
    yy, xx = np.mgrid[:n, :n] - (n - 1) / 2
    disk = (np.hypot(yy, xx) <= 6).astype(np.complex64)
    dp = np.abs(np.fft.fftshift(np.fft.fft2(disk)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probe, mse = er.retrieve_probe(dp, mask_radius=8, n_epochs=300)
    er_s = time.perf_counter() - t0
    inside = np.hypot(yy, xx) <= 8
    e_in = np.sum(np.abs(probe[inside]) ** 2)
    e_out = np.sum(np.abs(probe[~inside]) ** 2)
    ok_er = mse < 0.3 * np.mean(dp ** 2) and e_in > 5 * e_out
    a, ma = er.retrieve_probe(dp, 8, n_epochs=10)
    b, mb = er.retrieve_probe(dp, 8, n_epochs=10, device='cpu')
    er_err = np.abs(a - b).max() / np.abs(b).max()
    er_mse = abs(ma - mb) / abs(mb)

    holo, _ = holo_dataset()
    prj = holo.all_magnitudes()[0]          # the holograms' intensities
    ctf = {}
    for dev in ('cuda', 'cpu'):
        t0 = time.perf_counter()
        ctf[dev] = multidistance_ctf(prj, HOLO['dists'], HOLO['energy_ev'],
                                     HOLO['psize_cm'],
                                     device=dev).cpu().numpy()
        ctf[dev + '_s'] = time.perf_counter() - t0
    ctf_err = np.abs(ctf['cuda'] - ctf['cpu']).max() / np.abs(
        ctf['cpu']).max()

    rng = np.random.default_rng(6)
    from scipy.ndimage import gaussian_filter, shift as nd_shift
    base = gaussian_filter(rng.random((128, 128)), 2).astype(np.float32)
    src = work / '13c_imgs'
    src.mkdir()
    shifts_true = [np.zeros(2), np.array([2.0, -3.0]), np.array([-1.3, 0.6])]
    for t in range(2):
        for d, s in enumerate(shifts_true):
            write_tiff(nd_shift(base + 0.1 * t, -s, order=1, mode='wrap'),
                       str(src / f'data_{t:04d}_{d:02d}.tiff'))
    mats = np.concatenate([np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
                           np.array([[1.01, 0.02, 0.05],
                                     [-0.01, 0.99, -0.03]]),
                           np.array([[0.98, 0.0, -0.1],
                                     [0.01, 1.02, 0.08]])])
    np.savetxt(work / '13c_mats.txt', mats)
    outs, reg_shifts = {}, {}
    for dev in ('cuda', 'cpu'):
        outs['aff_' + dev] = aff.apply_affines(
            str(src), str(work / '13c_mats.txt'), str(work / f'13c_aff_{dev}'),
            'data', device=dev)
        copy = work / f'13c_reg_{dev}'
        import shutil
        shutil.copytree(src, copy)
        outs['reg_' + dev], reg_shifts[dev] = reg.register_folder(
            str(copy), 'data', device=dev)

    def folder_err(a, b):
        return max(np.abs(read_tiff(os.path.join(a, f))
                          - read_tiff(os.path.join(b, f))).max()
                   / np.abs(read_tiff(os.path.join(b, f))).max()
                   for f in sorted(os.listdir(b)))
    aff_err = folder_err(outs['aff_cuda'], outs['aff_cpu'])
    reg_err = folder_err(outs['reg_cuda'], outs['reg_cpu'])
    same_shifts = np.array_equal(np.asarray(reg_shifts['cuda']),
                                 np.asarray(reg_shifts['cpu']))
    trace_dir = work / '13c_trace'
    with profiler_trace(str(trace_dir)):
        er.retrieve_probe(dp, 8, n_epochs=2)
        torch.cuda.synchronize()
    trace = json.loads(next(trace_dir.glob('trace_*.json')).read_text())
    kernels_traced = any(e.get('cat') == 'kernel'
                         for e in trace.get('traceEvents', []))
    log(f'13c tools on the card against the CPU: retrieve_probe 300 epochs '
        f'{er_s:.2f} s, mse {mse:.4e} (< 0.3 mean dp^2 '
        f'{0.3 * np.mean(dp ** 2):.4e}), energy in/out {e_in / e_out:.1f} '
        f'(> 5); at 10 epochs probe {er_err:.2e}, mse {er_mse:.2e} rel; '
        f'CTF retrieval {ctf_err:.2e} of the largest magnitude ('
        f'{ctf["cuda_s"] * 1e3:.1f} ms on the card, {ctf["cpu_s"] * 1e3:.1f}'
        f' on the CPU); affine warp {aff_err:.2e}; registration images '
        f'{reg_err:.2e}, shifts {reg_shifts["cuda"]} equal: {same_shifts}; '
        f'profiler_trace with the card\'s kernels: {kernels_traced}; {CARD}')
    if not (ok_er and er_err <= 1e-5 and er_mse <= 1e-5 and ctf_err <= 1e-5
            and aff_err <= 1e-5 and reg_err <= 1e-5 and same_shifts
            and kernels_traced):
        raise AssertionError('13c: a tool disagrees with the CPU')


def slice18_runs(work, kernels):
    """Phase 13: the port's demos and user tools on the card (13a-13c);
    then K1 and K2 at the shapes 13a gave them (the cone demo's 24x24
    grid: K1 at 576 patches, K2 of 24 rows into the unpadded 256^2
    object), whose records take 13a's launches."""
    t_phase = time.perf_counter()
    res = run_13a(work)
    stamp('phase 13a')
    if res['n_pos'] != res['rows'] ** 2 or res['channels'] != 64:
        raise AssertionError(f'13a: an unexpected chunk {res}')
    label = f' {res["rows"]}x{res["rows"]} grid, 13a cone demo'
    recs = check_multislice(torch.float32, 1e-4, 1e-3, N=res['n_pos'],
                            path='13a', label=f' ({label.strip()})')
    recs += check_grid_scatter(torch.float32, 64, True, '13a', 1,
                               rows=res['rows'], size=res['size'],
                               label=label)
    torch.cuda.empty_cache()
    for k in recs:
        k['launches'] = res['launches'][k['counter']]
        log(f"{k['name']}: kernel_ms {k['kernel_ms']:.4f} plain_ms "
            f"{k['plain_ms']:.4f} bound_ms {k['bound_ms']:.4f} "
            f"({k['bound_by']}) launches {k['launches']} (13a's run)")
    kernels += recs
    stamp('phase 13a kernels')
    run_13b(work)
    stamp('phase 13b')
    run_13c(work)
    log(f'phase 13: {time.perf_counter() - t_phase:.1f} s; {CARD}')
    stamp('phase 13')
    return res


# -- phase 14 ----------------------------------------------------------------

#: Phase 14c's object edge: 512^3 keeps 1.07 GB of object and 2.15 GB of
#: Adam moments in host blocks, written to disk slab by slab.
P14C_N = 512


def disk_write_rate(folder, gb=1.0):
    """The write rate of ``folder``'s disk, GB/s: ``gb`` GB of random bytes
    written in 16 blocks, then ``os.fsync``, timed to the fsync's end (the
    file is removed)."""
    block = os.urandom(int(gb * 1e9) // 16)
    path = Path(folder) / 'disk_rate.bin'
    t0 = time.perf_counter()
    with open(path, 'wb') as f:
        for _ in range(16):
            f.write(block)
        f.flush()
        os.fsync(f.fileno())
    s = time.perf_counter() - t0
    path.unlink()
    return 16 * len(block) / s / 1e9


def dir_bytes(path):
    """The bytes of the files under ``path`` (a file's own size)."""
    path = Path(path)
    if path.is_file():
        return path.stat().st_size
    return sum(p.stat().st_size for p in path.rglob('*') if p.is_file())


def timed_saves(rec, on_save=None):
    """Time each ``rec.save_checkpoint`` call (host clock; the write ends
    with the data on the host and on disk); ``on_save(n)`` runs after the
    ``n``-th.  Returns the list the seconds go into."""
    seconds = []
    save = rec.save_checkpoint

    def timed(i_epoch, i_batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(i_epoch, i_batch)
        seconds.append(time.perf_counter() - t0)
        if on_save is not None:
            on_save(len(seconds))
        return path
    rec.save_checkpoint = timed
    return seconds


def run_14a(work):
    """Phase 14a: the per-angle flagship (4 angles, f32) with a checkpoint
    at the end of each angle, in the sharded form and in the npz form, one
    epoch each: seconds a checkpoint and bytes written; then a resume from
    the sharded checkpoint after angle 2 (copied aside when it was
    written), whose row losses and object equal the uninterrupted run's
    (1e-6 relative); K1f, K1b and K2 launched once an angle."""
    import shutil
    import adorym_tpu_torch as pt
    f = FLAGSHIP
    t0 = time.perf_counter()
    import torch.distributed.checkpoint  # noqa: F401
    log(f'14a: import torch.distributed.checkpoint '
        f'{time.perf_counter() - t0:.3f} s (outside the checkpoints)')
    data, pos, theta = flagship_data()
    obj0 = np.zeros((f['n_obj'],) * 3 + (2,), np.float32)
    base = flagship_config(False, 'delta_beta')
    kw = dict(data=data, probe_pos=pos, theta_ls=theta, obj_init=obj0)
    res = {}
    snap = work / '14a_after_angle_2'
    for form in ('sharded', 'npz'):
        out = work / f'14a_{form}'
        cfg = base.replace(io=pt.IOConfig(
            use_orbax=form == 'sharded', n_batch_per_checkpoint=f['mb']))
        rec = pt.Reconstructor(cfg, output_folder=str(out), **kw)

        def keep(n, out=out, form=form):
            if form == 'sharded' and n == 2:
                shutil.copytree(out / 'checkpoint', snap / 'checkpoint')
        seconds = timed_saves(rec, keep)
        reset_counts()
        rows = []
        t0 = time.perf_counter()
        loss = rec.run_epoch(0, callback=lambda e, b, l: rows.append(l))
        wall = time.perf_counter() - t0
        launches = launch_counts()
        ck = out / 'checkpoint'
        nbytes = dir_bytes(ck / 'dcp' if form == 'sharded'
                           else ck / 'checkpoint.npz')
        res[form] = dict(seconds=seconds, bytes=nbytes, loss=loss,
                         wall=wall, rows=rows, obj=rec.obj,
                         launches={k: launches[k] for k in
                                   ('K1_FWD', 'K1_BWD', 'K2', 'K6')})
        log(f"14a per-angle flagship f32, {form} checkpoints after each "
            f"angle: {[round(s, 4) for s in seconds]} s (median "
            f"{statistics.median(seconds):.4f} s), {nbytes / 1e9:.4f} GB a "
            f"checkpoint, epoch {wall:.3f} s, loss {loss}, launches "
            f"{res[form]['launches']}; {CARD}")
        want = {'K1_FWD': f['n_theta'], 'K1_BWD': f['n_theta'],
                'K2': f['n_theta'], 'K6': 0}
        if res[form]['launches'] != want or len(seconds) != f['n_theta']:
            raise AssertionError(f'14a {form}: launches '
                                 f"{res[form]['launches']}, {len(seconds)} "
                                 'checkpoints')
        del rec
        torch.cuda.empty_cache()
    if res['sharded']['rows'] != res['npz']['rows']:
        log('14a: the two forms\' runs differ in their row losses (the '
            'card\'s sums in other orders)')
    rec = pt.Reconstructor(base.replace(io=pt.IOConfig(
        use_orbax=True, n_batch_per_checkpoint=10_000)),
        output_folder=str(snap), **kw)
    skip = 2 * len(pos) // f['mb']
    if (rec._start_epoch, rec._start_batch) != (0, skip):
        raise AssertionError(f'14a: resumed at ({rec._start_epoch}, '
                             f'{rec._start_batch}), not (0, {skip})')
    rows = []
    rec.run_epoch(0, callback=lambda e, b, l: rows.append(l))
    want = np.asarray(res['sharded']['rows'][skip:])
    rel = float(np.max(np.abs(np.asarray(rows) - want) / np.abs(want)))
    ref = res['sharded']['obj']
    err = float(np.max(np.abs(rec.obj - ref)) / np.max(np.abs(ref)))
    res['resume'] = dict(rel=rel, obj_err=err, n_rows=len(rows))
    log(f'14a resume from the checkpoint after angle 2: {len(rows)} row '
        f'losses against the uninterrupted run, max rel {rel:.3e}; object '
        f'{err:.3e} of its largest value (tol 1e-6)')
    if len(rows) != len(want) or rel > 1e-6 or err > 1e-6:
        raise AssertionError('14a: the resume differs from the '
                             'uninterrupted run')
    del rec
    for v in res.values():
        v.pop('obj', None)
    torch.cuda.empty_cache()
    return res


def p14_config(dp, op):
    """12a's per-angle flagship (f32, 2 angles) on a ``dp x op`` mesh (one
    rank at (1, 1)), checkpointing in the sharded form."""
    import dataclasses
    import adorym_tpu_torch as pt
    cfg = p12_config('delta_beta', dp, op)
    return dataclasses.replace(cfg, io=pt.IOConfig(
        use_orbax=True, n_batch_per_checkpoint=10_000))


def p14_write_rank(folder):
    """14b on one rank of (2, 2): one epoch, then the sharded checkpoint
    and the npz form of the same state, each timed with the collectives
    it issued; then the uninterrupted second epoch."""
    import torch.distributed.checkpoint  # noqa: F401  (not in the timing)
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.parallel.mesh import make_mesh
    cfg = p14_config(2, 2)
    mesh = make_mesh(cfg.parallel, device='cuda:0')
    rec = pt.Reconstructor(cfg, mesh=mesh, output_folder=folder,
                           **p12_inputs(2))
    reset_counts()
    rec.run_epoch(0)
    launches = launch_counts()
    out = {'rank': mesh.rank, 'coord': (mesh.dp, mesh.op),
           'launches': {k: launches[k] for k in ('K1_FWD', 'K1_BWD', 'K6',
                                                 'K2')}}
    # The npz form goes to a folder of its own: an npz checkpoint removes
    # the sharded form beside it, which the restores below read.
    ck = os.path.join(folder, 'checkpoint')
    ck_npz = os.path.join(folder, 'npz_form')
    for form, save in (('sharded', lambda: rec.save_checkpoint(1, 0)),
                       ('npz', lambda: rec._save_npz(ck_npz, 1, 0))):
        torch.cuda.synchronize()
        mesh.comm.reset()
        t0 = time.perf_counter()
        save()
        out[form] = {'seconds': time.perf_counter() - t0,
                     'comm': mesh.comm.summary()}
    out['sharded']['bytes'] = sum(
        p.stat().st_size for p in Path(ck, 'dcp').glob(
            f'__{mesh.rank}_*.distcp'))
    out['npz']['bytes'] = (os.path.getsize(os.path.join(ck_npz,
                                                        'checkpoint.npz'))
                           if mesh.rank == 0 else 0)
    rows = []
    rec.run_epoch(1, callback=lambda e, b, l: rows.append(l))
    out['rows'] = rows
    return out


def p14_resume_rank(folder, dp, op):
    """A ``dp x op`` rank of 14b's restores from ``folder``'s (2, 2)
    checkpoint: the second epoch's row losses and the rows this rank
    holds."""
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.parallel.mesh import make_mesh
    cfg = p14_config(dp, op)
    mesh = make_mesh(cfg.parallel, device='cuda:0')
    rec = pt.Reconstructor(cfg, mesh=mesh, output_folder=folder,
                           **p12_inputs(2))
    start = rec._start_epoch
    rows = []
    rec.run_epoch(1, callback=lambda e, b, l: rows.append(l))
    return {'rank': mesh.rank, 'start': start, 'rows': rows,
            'slab': tuple(rec.params['obj'].shape)}


def p14_one_rank(folder):
    """14b's restore on one rank (no process group) from ``folder``'s
    (2, 2) checkpoint: the second epoch's row losses."""
    import adorym_tpu_torch as pt
    rec = pt.Reconstructor(p14_config(1, 1), output_folder=folder,
                           **p12_inputs(2))
    start = rec._start_epoch
    rows = []
    rec.run_epoch(1, callback=lambda e, b, l: rows.append(l))
    del rec
    torch.cuda.empty_cache()
    return {'start': start, 'rows': rows}


def p14_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f'14b: {got.shape} row losses against '
                             f'{want.shape}')
    return float(np.max(np.abs(got - want) / np.abs(want)))


def run_14b(work):
    """Phase 14b: 12a's per-angle flagship at (2, 2) as gloo ranks on the
    card with ``use_orbax=True``: each rank's bytes written and the
    all-gather bytes during the sharded checkpoint (none) beside the npz
    form's; the checkpoint restored onto (1, 2) and onto one rank, each
    resumed epoch's row losses within 1e-5 of the uninterrupted (2, 2)
    run's; K1 and K6 launched.  Returns the (2, 2) ranks' results."""
    from adorym_tpu_torch.parallel.launch import RankPool
    folder = str(work / '14b')
    with RankPool(4, 'cuda:0', threads=2) as pool4:
        out = pool4.run(p14_write_rank, folder)
    for o in out:
        gathered = {form: sum(v['bytes'] for k, v in o[form]['comm'].items()
                              if k.startswith('all_gather'))
                    for form in ('sharded', 'npz')}
        o['all_gather_bytes'] = gathered
        log(f"14b rank {o['rank']} {o['coord']}: sharded checkpoint "
            f"{o['sharded']['seconds']:.4f} s, {o['sharded']['bytes'] / 1e6:.2f}"
            f" MB written, all-gather {gathered['sharded']} bytes, "
            f"collectives {o['sharded']['comm']}; npz form "
            f"{o['npz']['seconds']:.4f} s, {o['npz']['bytes'] / 1e6:.2f} MB "
            f"written, all-gather {gathered['npz'] / 1e6:.2f} MB; launches "
            f"{o['launches']} (wiring on one shared card, not scaling); "
            f'{CARD}')
        if gathered['sharded'] != 0 or gathered['npz'] == 0:
            raise AssertionError(f'14b: all-gather bytes {gathered}')
        if o['launches']['K1_FWD'] == 0 or o['launches']['K6'] == 0:
            raise AssertionError(f"14b: launches {o['launches']}")
        dp0 = o['coord'][0] == 0
        if (o['sharded']['bytes'] > 0) != dp0:
            raise AssertionError(f'14b: rank {o["rank"]} wrote '
                                 f"{o['sharded']['bytes']} bytes")
    res = {'write': out}
    with RankPool(2, 'cuda:0', threads=2) as pool2:
        got = pool2.run(p14_resume_rank, folder, 1, 2)
    one = p14_one_rank(folder)
    res['(1, 2)'] = p14_rel(got[0]['rows'], out[0]['rows'])
    res['one rank'] = p14_rel(one['rows'], out[0]['rows'])
    log(f"14b restores of the (2, 2) checkpoint, their second epoch against "
        f"the uninterrupted (2, 2) run's: onto (1, 2) (slabs "
        f"{[g['slab'] for g in got]}, start epoch {got[0]['start']}) max rel "
        f"{res['(1, 2)']:.3e}; onto one rank (start epoch {one['start']}) "
        f"{res['one rank']:.3e} (tol 1e-5)")
    if (got[0]['start'] != 1 or one['start'] != 1
            or max(res['(1, 2)'], res['one rank']) > 1e-5):
        raise AssertionError('14b: a restore differs from its uninterrupted '
                             'run')
    return res


def run_14c(work, rate, n=P14C_N, s=24, k=19):
    """Phase 14c: a 512^3 object with its Adam moments on the host (8
    slabs), one angle of 19x19 spots at stride 24 (minibatch 19), with
    ``use_orbax=True``: two epochs, then a timed sharded checkpoint with
    the host's RSS sampled during the write (no whole-array copy: its
    growth stays under one object), beside bytes / the disk's rate; then
    the uninterrupted third epoch against a resume from the checkpoint
    (loss and object within 1e-6 relative)."""
    import threading
    import adorym_tpu_torch as pt
    from adorym_tpu_torch.utils.profiling import host_memory_rss_mb
    f = FLAGSHIP
    xs = 8 + s * np.arange(k)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    data = np.random.default_rng(0).random((1, len(pos), f['n_probe'],
                                            f['n_probe']), dtype=np.float32)
    cfg = table_config(n=n, minibatch_size=k).replace(
        parallel=pt.ParallelConfig(offload_optimizer_state=True,
                                   offload_slabs=8, offload_object=True),
        io=pt.IOConfig(use_orbax=True, n_batch_per_checkpoint=10_000))
    kw = dict(data=data, probe_pos=pos, theta_ls=np.zeros(1),
              probe_init=probe_modes(f['n_probe'], 1))
    folder = work / '14c'
    rec = pt.Reconstructor(cfg, output_folder=str(folder),
                           obj_init=np.zeros((n, n, n, 2), np.float32), **kw)
    if not rec._obj_offloaded:
        raise AssertionError('14c: object offload did not engage')
    reset_counts()
    losses = [rec.run_epoch(ep) for ep in (0, 1)]
    launches = launch_counts()
    rss = []
    done = threading.Event()

    def sample():
        while not done.is_set():
            rss.append(host_memory_rss_mb())
            time.sleep(0.005)
    rss0 = host_memory_rss_mb()
    th = threading.Thread(target=sample)
    th.start()
    t0 = time.perf_counter()
    try:
        rec.save_checkpoint(2, 0)
    finally:
        write_s = time.perf_counter() - t0
        done.set()
        th.join()
    nbytes = dir_bytes(folder / 'checkpoint' / 'dcp')
    obj_bytes = n ** 3 * 8
    growth = (max(rss) - rss0) * 2 ** 20 / 1e9
    loss_u = rec.run_epoch(2)
    obj_u = rec.obj
    del rec
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    rec = pt.Reconstructor(cfg, output_folder=str(folder),
                           obj_init=np.zeros((n, n, n, 2), np.float32), **kw)
    start = rec._start_epoch
    loss_r = rec.run_epoch(2)
    rel = abs(loss_r - loss_u) / abs(loss_u)
    err = float(np.max(np.abs(rec.obj - obj_u)) / np.max(np.abs(obj_u)))
    res = dict(seconds=write_s, bytes=nbytes, bound_s=nbytes / (rate * 1e9),
               rss_before_gb=rss0 * 2 ** 20 / 1e9,
               rss_peak_gb=max(rss) * 2 ** 20 / 1e9, rss_growth_gb=growth,
               samples=len(rss), losses=losses + [loss_u], rel=rel,
               obj_err=err, start=start,
               launches={k_: launches[k_] for k_ in ('K1_FWD', 'K1_BWD',
                                                     'K2', 'K6')})
    log(f"14c {n}^3 object and moments on the host ({obj_bytes / 1e9:.2f} + "
        f"{2 * obj_bytes / 1e9:.2f} GB), one angle of {k}x{k} spots: sharded "
        f"checkpoint {write_s:.3f} s for {nbytes / 1e9:.3f} GB, against "
        f"bytes / disk rate {res['bound_s']:.3f} s ({rate:.3f} GB/s); host "
        f"RSS {res['rss_before_gb']:.2f} GB before the write, peak "
        f"{res['rss_peak_gb']:.2f} GB during it ({len(rss)} samples, growth "
        f"{growth:.3f} GB); losses {res['losses']}; resumed at epoch {start}"
        f": loss {loss_r} (rel {rel:.3e}), object {err:.3e} of its largest "
        f"value (tol 1e-6); launches {res['launches']}; {CARD}")
    if start != 2 or rel > 1e-6 or err > 1e-6:
        raise AssertionError('14c: the resume differs')
    if growth > 0.5 * obj_bytes / 1e9:
        raise AssertionError(f'14c: the write grew RSS by {growth:.2f} GB')
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    return res


def slice19_runs(work, kernels):
    """Phase 14: the output folder's disk rate, then 14a-14c.  The K1 and
    K2 records of the per-angle f32 path take 14a's launches, and the K1
    and K6 records of 12a's mesh shapes take 14b's (2, 2) rank 0's, as
    ``phase14_launches``."""
    t_phase = time.perf_counter()
    rate = disk_write_rate(work)
    log(f'14: disk write rate of the output folder {rate:.3f} GB/s (1 GB, '
        f'fsync; {CARD})')
    res = {'disk_gb_s': rate, '14a': run_14a(work)}
    stamp('phase 14a')
    res['14b'] = run_14b(work)
    stamp('phase 14b')
    res['14c'] = run_14c(work, rate)
    stamp('phase 14c')
    a = res['14a']['sharded']['launches']
    b = res['14b']['write'][0]['launches']
    for k in kernels:
        if k['path'] == 'delta_beta' and k['name'].endswith('(float32)'):
            if k['counter'] in a:
                k['phase14_launches'] = a[k['counter']]
        elif k['path'] == 'mesh12a' and k['counter'] in b:
            k['phase14_launches'] = b[k['counter']]
    sh, npz = res['14a']['sharded'], res['14a']['npz']
    log(f"phase 14: 14a {statistics.median(sh['seconds']):.4f} s a sharded "
        f"checkpoint, {statistics.median(npz['seconds']):.4f} s an npz one "
        f"({sh['bytes'] / 1e9:.4f} / {npz['bytes'] / 1e9:.4f} GB); 14b "
        f"all-gather bytes {res['14b']['write'][0]['all_gather_bytes']}; "
        f"14c {res['14c']['seconds']:.3f} s (bytes / disk rate "
        f"{res['14c']['bound_s']:.3f} s), RSS growth "
        f"{res['14c']['rss_growth_gb']:.3f} GB; "
        f'{time.perf_counter() - t_phase:.1f} s; {CARD}')
    stamp('phase 14')
    return res


def child_processes():
    """The command lines of this process's live children."""
    me, out = str(os.getpid()), []
    for d in os.listdir('/proc'):
        try:
            with open(f'/proc/{d}/stat') as f:
                stat = f.read()
            with open(f'/proc/{d}/cmdline') as f:
                cmd = f.read().replace('\0', ' ').strip()
        except (OSError, ValueError):
            continue
        # The parent's pid is the second field after the command's ')'.
        fields = stat.rsplit(')', 1)[-1].split()
        if fields[1] == me and fields[0] != 'Z':
            out.append(cmd[:120])
    return out


def pools_stopped(label, phase, *args):
    """``phase(*args)``, a phase that opens ``RankPool``s; then the fork
    server and the resource tracker, which outlive every pool, stopped,
    and a failure if a child process of this script is still alive."""
    from adorym_tpu_torch.parallel import launch
    try:
        out = phase(*args)
    finally:
        launch.shutdown()
    left = child_processes()
    if left:
        raise AssertionError(f'{label} left processes running: {left}')
    return out


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    global CARD
    CARD = smi
    log(f'python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}')

    from adorym_tpu_torch.utils import cuda_build
    build_s = cuda_build.build(['multislice_db_stored.cu', 'grid_scatter.cu',
                                'grid_extract.cu', 'multislice_fused.cu',
                                'multislice_db.cu', 'rowgrid_scatter.cu'])
    log(f'kernels built in {build_s:.2f} s')
    stamp('build')

    kernels = []
    # This slice's shapes of K1: per-spot waves at one grid row with the
    # far field folded (7b) and at a whole angle without it (7c); then the
    # large planes, which K1, K4 and K5 take on their global route (R2).
    kernels += check_per_spot_multislice(23, True)
    kernels += check_per_spot_multislice(529, False)
    torch.cuda.empty_cache()
    kernels += check_large_planes()
    stamp('phase 3: per-spot K1, large planes')
    for dtype, tol_bwd in ((torch.float32, 1e-3), (torch.bfloat16, 3e-2)):
        # f32: 32 steps of 72-deep sums in other orders than cuBLAS.  bf16:
        # the kernel rounds its records and gdb to bf16, autograd does not.
        kernels += check_multislice(dtype, 1e-4, tol_bwd)
        # The immediate path's shapes: K1 at one grid row, K6 on its
        # z-major gradient.
        kernels += check_multislice(dtype, 1e-4, tol_bwd, N=23)
        kernels += check_rowgrid_scatter_zmajor(dtype)
        # The per-angle path's: K6 on the rows of a chunk, in place.
        kernels += check_rowgrid_scatter_chunk_rows(dtype)
        if dtype == torch.float32:
            # The adhesin configuration's shape (phase 6b).
            kernels += check_multislice_unfolded()
        kernels += check_grid_extract(dtype)
        for case in K2_CASES:
            kernels += check_grid_scatter(dtype, *case)
            torch.cuda.empty_cache()
    stamp('phase 3: K1, K6 z-major, K3, K2')
    # f32: 31 steps of 72-point transforms (the FFT route's stages, the
    # dense route's DFT matmuls) against cuFFT, sums in other orders.
    kernels += check_fused_multislice(1e-4, 1e-3)
    kernels += check_fused_multislice(1e-4, 1e-3, M=3)
    torch.cuda.empty_cache()
    # The multi-mode paths: K1 at three modes (as K1 at one), K4 at 256
    # steps; and K6.
    kernels += check_multislice(torch.float32, 1e-4, 1e-3, M=3)
    for dtype in (torch.float32, torch.bfloat16):
        kernels += check_invertible(dtype)
        torch.cuda.empty_cache()
    kernels += check_rowgrid_scatter()
    kernels += check_rowgrid_scatter_sparse()
    kernels += check_rowgrid_scatter_real_imag()
    adjoint_ms = check_band_adjoint()
    # K1 under kappa and in -z (phase 8's branches).
    check_multislice_branches()
    stamp('phase 3: K5, K4, K6, band adjoint, K1 branches')
    # The f32 kernels of K1 and K4 against the complex128 sweep, each route.
    truth = check_truth()
    for k in kernels:
        which = k['name'][:2]
        if (which in truth and k['name'].endswith('(float32)')
                and ' M=' not in k['name'] and ' N=' not in k['name']
                and '^2' not in k['name']):
            i = slice(0, 1) if 'forward' in k['name'] else slice(1, 3)
            k['truth_rel_err'] = {form: max(e[i]) for form, e in
                                  truth[which].items()}
    for k in kernels:
        lib = 'none' if k['library_ms'] is None else f"{k['library_ms']:.4f}"
        dense = (f" dense_ms {k['dense_ms']:.4f}" if 'dense_ms' in k
                 else '')
        log(f"{k['name']}: kernel_ms {k['kernel_ms']:.4f} plain_ms "
            f"{k['plain_ms']:.4f} bound_ms {k['bound_ms']:.4f} "
            f"({k['bound_by']}) library_ms {lib}{dense}")
    stamp('phase 3')

    # Phases 4-4c, then 4d: the immediate flagship.  Each run checks its
    # launches: K6 on the immediate path only.
    runs = [(path, bf16, 3) for path in ('delta_beta', 'real_imag',
                                         'multimode')
            for bf16 in (False, True)] + [('multimode_binned', False, 1)] + [
        ('immediate', bf16, 3) for bf16 in (False, True)]
    for path, bf16, n_timed in runs:
        run_path(kernels, path, bf16, n_timed)
    # Phases 7b and 7c: the same flagships with the positions refined.
    slice_flagships(kernels)
    stamp('phases 4, 7b, 7c')

    # Phase 5: 16^2 patterns take K1's FFT route, one pair per angle and
    # epoch.
    small_config_agrees(expect={'K1_FWD': 6, 'K1_BWD': 6, 'K1_FFT': 12,
                                'K1_DENSE': 0})
    # Phase 5b: the general fused path, one K5 pair per angle and epoch,
    # on its FFT route at 16^2.
    small_config_agrees('real_imag', expect={'K5_FWD': 6, 'K5_FFT': 12,
                                             'K5_DENSE': 0, 'K1_FWD': 0,
                                             'K3': 6})
    small_config_agrees('delta_beta', False, 1e-5,
                        expect={'K5_FWD': 6, 'K5_FFT': 12, 'K5_DENSE': 0,
                                'K1_FWD': 0, 'K3': 0})
    # Phase 5c: three refined probe modes at binning 1, through K4 (the
    # switch forced; its FFT route at 16^2) and through K1; one pair per
    # angle and epoch.  The object's step keeps the absorption physical for
    # K4's rebuilt waves.
    multimode = dict(n_modes=3, binning=1, lr=1e-4)
    small_config_agrees(force_invertible=True, **multimode,
                        expect={'K4_FWD': 6, 'K4_BWD': 6, 'K4_FFT': 12,
                                'K4_DENSE': 0, 'K1_FWD': 0})
    small_config_agrees(**multimode,
                        expect={'K1_FWD': 6, 'K1_BWD': 6, 'K1_FFT': 12,
                                'K1_DENSE': 0, 'K4_FWD': 0})
    # Phase 5d: the immediate scheme, one update a grid row (4 an angle, 24
    # over the two epochs): the band step (K6 once a row) and, on the
    # jittered table, the generic step (the whole object's rotation
    # through autograd), each delta_beta (K1) and real_imag (K5).
    for unknown_type, pair in (('delta_beta', 'K1'), ('real_imag', 'K5')):
        for jitter in (False, True):
            small_config_agrees(
                unknown_type, immediate=True, jitter=jitter,
                expect={f'{pair}_FWD': 24, f'{pair}_BWD': 24,
                        f'{pair}_FFT': 48, 'K6': 0 if jitter else 24,
                        'K6_VEC': 0 if jitter else 24, 'K2': 0, 'K3': 0})
    log(f"band adjoint at the immediate flagship: taps "
        f"{adjoint_ms['taps']:.3f} ms, autograd transpose "
        f"{adjoint_ms['transpose']:.3f} ms")
    # Phase 5e: regularizers (TV and reweighted L1; plain L1 for
    # real_imag), a support cylinder and shrink-wrap on the band step, the
    # generic step and the per-angle step, delta_beta (K1) and real_imag
    # (K5); then a 2D run (one slice: no kernel).
    for unknown_type, pair in (('delta_beta', 'K1'), ('real_imag', 'K5')):
        for immediate, jitter in ((True, False), (True, True),
                                  (False, False)):
            n = 24 if immediate else 6
            small_config_agrees(
                unknown_type, immediate=immediate, jitter=jitter, regs=True,
                expect={f'{pair}_FWD': n, f'{pair}_BWD': n,
                        f'{pair}_FFT': 2 * n,
                        'K6': 24 if immediate and not jitter else 0,
                        'K2': 0 if immediate else 6})
    small_config_agrees(immediate=True, regs=True, two_d=True,
                        expect={k: 0 for k in counters()})
    stamp('phase 5')

    # Phases 6a-6c: the user's entry points, at full width, with outputs
    # and checkpoints in a scratch folder under build/ (removed at the
    # end).
    build = Path(__file__).resolve().parent / 'build'
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as work:
        work = Path(work)
        imm = run_immediate_api(work)
        stamp('phase 6a')
        adhesin_launches = run_adhesin(work)
        stamp('phase 6b')
        slice_api_runs(work)
        stamp('phase 7')
        _, sparse_launches = slice12_runs(work)
        stamp('phase 8')
        res14 = slice14_runs(work, kernels)
        slice15_runs(work)
        stamp('phase 10')
        slice16_runs(work, kernels, res14['9e'])
        pools_stopped('phase 12', slice17_runs, work, kernels)
        slice18_runs(work, kernels)
        pools_stopped('phase 14', slice19_runs, work, kernels)
    angle_rate, angle_peak = run_per_angle_regularized()
    stamp('phase 6c')
    log(f"phase 6: immediate with checkpoints "
        f"{statistics.median(imm['patterns_s']):.1f} patterns/s, without "
        f"{statistics.median(imm['patterns_s_no_ckpt']):.1f}, "
        f"{imm['ckpt_s']:.3f} s a checkpoint, peak {imm['peak_gb']:.2f} GB; "
        f"per angle {angle_rate:.1f} patterns/s, peak {angle_peak:.2f} GB")
    for k in kernels:
        if k['path'] == 'adhesin':
            k['launches'] = adhesin_launches[k['counter']]
        elif k['path'] == 'sparse':
            k['launches'] = sparse_launches[k['counter']]
    return finish(kernels, smi)


def run_path(kernels, path, bf16, n_timed, profile=True):
    """One flagship run; its launches go to the kernel records of its path
    and storage type.  Returns its median patterns/s."""
    rate, launches = run_flagship(bf16, path, n_timed, profile)
    tag = '(bfloat16)' if bf16 else '(float32)'
    for k in kernels:
        if k['path'] == path and k['name'].endswith(tag):
            k['launches'] = launches[k['counter']]
    return rate


def slice_flagships(kernels):
    """Phases 7b and 7c, f32: the immediate flagship with the per-spot
    positions refined (K1 at N=23 with per-spot waves, K6), and the
    per-angle flagship with the positions and the projection offset
    refined (K1 at N=529 with the far field left out, K2), each beside
    its plain cell in the same call (those ran in phases 4 and 4d)."""
    imm = run_path(kernels, 'immediate_pos', False, 2, profile=False)
    ang = run_path(kernels, 'delta_beta_pos', False, 2)
    log(f'7b immediate flagship + positions {imm:.1f} patterns/s; 7c '
        f'per-angle flagship + positions + projection offset {ang:.1f} '
        f'patterns/s (their plain cells: phases 4d and 4 above); {CARD}')


def slice_api_runs(work):
    """Phase 7: the small CUDA-CPU agreements of each new path, then 7a
    and 7d through ``reconstruct_ptychography``."""
    want = {'2d': {}, 'band': {'K1_FWD': 24, 'K1_BWD': 24, 'K6': 24},
            'angle': {'K1_FWD': 6, 'K1_BWD': 6, 'K2': 6, 'K6': 0},
            'multidist': {}}
    for kind, expect in want.items():
        launches = small_refinables_agree(kind)
        expect = expect or {k: 0 for k in counters()}
        if any(launches[k] != v for k, v in expect.items()):
            raise AssertionError(f'7 small {kind}: launches {launches}, '
                                 f'expected {expect}')
    siemens = run_siemens(work)
    holo = run_multidist(work)
    log(f"phase 7: 7a {statistics.median(siemens['patterns_s']):.1f} "
        f"patterns/s, residual {siemens['residual'][0]:.4f} -> "
        f"{siemens['residual'][1]:.4f} px (after the delay "
        f"{siemens['refined'][-1][1]:.4f} px, correlation "
        f"{siemens['refined'][-1][2]:.3f}), peak {siemens['peak_gb']:.2f} GB;"
        f" 7d {statistics.median(holo['s_epoch']):.5f} s an epoch, distance "
        f"error {holo['dist_err'][0]:.5f} -> {holo['dist_err'][1]:.5f} cm, "
        f"peak {holo['peak_gb']:.3f} GB; {CARD}")


def finish(kernels, smi):
    """Check every recorded kernel has launches from its path's run, then
    print the card, the kernels' JSON line and the last line."""
    if not all(k.get('launches') for k in kernels if k['path']):
        raise AssertionError('a kernel has no launch count from the '
                             'flagship run')
    for k in kernels:
        if k['path'] is None:
            k['launches'] = 0
        del k['counter'], k['path']
    log(smi)
    log(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
