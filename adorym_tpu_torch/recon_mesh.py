"""The Reconstructor's structured mesh paths (``adorym_tpu/recon.py``'s
``_build_mc_layout``, ``_build_mc_step``, ``_build_mc_imm_layout`` and
``_build_mc_imm_step``), one rank's part of each, with every collective
written out (:mod:`.parallel.comm`).

Per angle (``update_scheme='per angle'`` with the rotation out of the
loop, grid-row scan tables): the object stays in y slabs; rotation about
the view axis acts on each y plane, so a rank rotates (and bins) its own
slab; a probe-height halo from the neighbouring slabs (:func:`.parallel.
halo.neighbor_extend`) lets the rank cut the windows of the grid rows that
start in its padded slab; 'dp' splits each row's spots (rows padded at
weight 0 to a multiple of ``data_axis``); the patch gradients go into a
slab accumulator row by row (K6); one sum over 'dp', one ring shift adds
the accumulator's halo into the next slab; the rotate-back is local.
Budget per angle: ring shifts in, one per nonzero halo side (``h1``,
``h2``: 2 with padding above and below, 1 without); out, 1 plus one per
nonzero side of the y padding; 1 accumulator sum over 'dp'; 1 auxiliary
sum (the other leaves' gradients and the losses, packed).

Immediate (the reference's default scheme, grid-row tables): every rank
takes part in every batch.  Each 'op' rank contributes its rows of the
batch's y band and one sum over 'op' assembles it; every rank rotates the
band and runs its ``mb / (data_axis * object_axis)`` spots (K1 at that N,
K6 into the band); one sum over the whole mesh assembles the band's
gradient; its rotate-back is the band step's; each rank keeps its own
rows.  Budget per batch: 2 band sums and 1 scalar/auxiliary sum.

The decline reasons are the JAX package's, word for word.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .models import ptychography as ptycho_model
from .ops import patches as patch_ops
from .ops.cuda_scatter_grid import scatter_rowgrid_add_kernel
from .ops.rotate import (rotate, rotate_adjoint, rotate_and_bin_z,
                         rotate_expanded_from_binned_z)
from .parallel.comm import flat_all_reduce
from .parallel.halo import neighbor_extend
from .utils import profiling as _prof


def _vacuum_like(t, unknown_type):
    v = torch.zeros_like(t)
    if unknown_type == 'real_imag':
        v[..., 0] = 1.0
    return v


def _row_grid(rec) -> Optional[tuple]:
    cfg = rec.cfg
    if (rec.model is ptycho_model and rec.probe_pos.ndim == 2
            and not cfg.train.randomize_probe_pos):
        return patch_ops.detect_row_grid_ragged(
            rec.probe_pos, cfg.train.minibatch_size,
            cfg.geometry.probe_size)
    return None


def _common_reasons(rec, why, rg):
    cfg = rec.cfg
    if rg is None:
        why.append('scan table is not a (possibly ragged) '
                   'constant-stride row grid')
    if rec.model is not ptycho_model:
        why.append('model is not far-field ptychography')
    elif not hasattr(rec.model, 'predict_from_patches'):
        why.append('model has no patch-granular forward')
    if rec.transform_measured is not None:
        why.append('measured-data transform active')
    if rec.second_order:
        why.append('second-order optimizer')
    if cfg.refine.tilt_active:
        why.append('tilt rotation active')


def build_mc_layout(rec) -> Optional[Dict]:
    """The per-angle mesh path's static layout, or None (with the reasons
    in ``rec._mc_decline_reasons``) where it does not apply."""
    cfg = rec.cfg
    geo = cfg.geometry
    why = rec._mc_decline_reasons = []
    rg = _row_grid(rec)
    _common_reasons(rec, why, rg)
    if rec.data is None:
        why.append('no in-memory dataset')
    if cfg.train.update_scheme != 'per angle':
        why.append("update_scheme is not 'per angle'")
    if cfg.train.n_batch_per_update > 1:
        why.append('n_batch_per_update > 1')
    if rec.external_algorithm is not None:
        why.append('external algorithm hook active')
    if why:
        return None
    mesh = rec.mesh
    n_dp, n_op = mesh.n_dp, mesh.n_op
    mb = cfg.train.minibatch_size
    Y, X, nz = geo.obj_size
    py, px = geo.probe_size
    stride, n_last = rg
    mp = -(-mb // n_dp)
    mb_pad = mp * n_dp
    p = rec.pad_arr
    p0, p1 = int(p[0][0]), int(p[0][1])
    px0, px1 = int(p[1][0]), int(p[1][1])
    px1 += stride * (mb_pad - mb)
    p1 += (-(Y + p0 + p1)) % n_op
    Y_p = Y + p0 + p1
    S_u = Y // n_op
    S_p = Y_p // n_op
    h1, h2 = p0, p1 + py
    if py > S_p or max(h1, h2, p0, p1) > S_u:
        why.append(f'probe height {py} or halo exceeds the per-shard '
                   f'slab ({S_p} padded / {S_u} unpadded rows)')
        return None
    from .recon import _band_prebin
    prebin = _band_prebin(cfg)
    nzb = -(-nz // geo.binning) if prebin else nz
    pos = np.round(rec.probe_pos).astype(np.int64)
    n_rows = -(-pos.shape[0] // mb)
    y0_pad = pos[::mb, 0] + p0
    owner = y0_pad // S_p
    rows_by = [np.nonzero(owner == k)[0] for k in range(n_op)]
    n_max = max((len(r) for r in rows_by), default=0) or 1
    hbm = _prof.hbm_limit_bytes(rec.device)
    slab_bytes = S_p * (X + px0 + px1) * nzb * 2 * 4
    patch_dev_bytes = mp * py * px * nzb * 2 * 4
    avail = (hbm - _prof.xla_reserve_bytes(hbm)) - 6 * slab_bytes
    g_rows = int(max(1, min(64, n_max, avail // max(
        1, rec._chunk_bufs * patch_dev_bytes))))
    n_c = -(-n_max // g_rows)
    R = n_c * g_rows
    row_ids = np.zeros((n_op, R), np.int64)
    w = np.zeros((n_op, R), np.float32)
    for k in range(n_op):
        rk = rows_by[k]
        if len(rk):
            row_ids[k, :len(rk)] = rk
            row_ids[k, len(rk):] = rk[-1]
            w[k, :len(rk)] = 1.0
    j_all = np.arange(mb_pad)
    nr_row = np.full(n_rows, mb, np.int64)
    nr_row[-1] = n_last
    wrow = np.zeros((n_rows, mb_pad), np.float32)
    for r in range(n_rows):
        wrow[r, :nr_row[r]] = 1.0
        wrow[r, nr_row[r] - 1] += mb - nr_row[r]
    spot = (row_ids[..., None] * mb
            + np.minimum(j_all, (nr_row[row_ids] - 1)[..., None])
            ).reshape(n_op, R, n_dp, mp)
    x_tab = (pos[row_ids * mb, 1][..., None]
             + stride * j_all).reshape(n_op, R, n_dp, mp)
    wsp = (w[..., None] * wrow[row_ids]).astype(np.float32).reshape(
        n_op, R, n_dp, mp)
    y_loc = (y0_pad[row_ids] - np.arange(n_op)[:, None] * S_p)
    pos_mc = np.zeros((n_c, n_op, n_dp, g_rows * mp, 2), np.float32)
    inds_mc = np.zeros((n_c, n_op, n_dp, g_rows * mp), np.int64)
    ws_mc = np.zeros((n_c, n_op, n_dp, g_rows * mp), np.float32)
    for k in range(n_op):
        for c in range(n_c):
            sl = slice(c * g_rows, (c + 1) * g_rows)
            for d in range(n_dp):
                inds_mc[c, k, d] = spot[k, sl, d].reshape(-1)
                pos_mc[c, k, d, :, 0] = np.repeat(y_loc[k, sl], mp)
                pos_mc[c, k, d, :, 1] = x_tab[k, sl, d].reshape(-1) + px0
                ws_mc[c, k, d] = wsp[k, sl, d].reshape(-1)
    data_dev_bytes = rec.n_theta * R * mp * py * px * 4
    if data_dev_bytes > ((hbm - _prof.data_headroom_bytes(hbm))
                         - (6 * slab_bytes + rec._chunk_bufs
                            * patch_dev_bytes * g_rows)):
        why.append(f'device-resident data share ({data_dev_bytes / 1e9:.2f}'
                   ' GB/device) does not fit next to the working set')
        return None
    # Each scan row's loss slot in the angle's [n_op, n_c, g_rows] slots.
    slot = np.zeros(n_rows, np.int64)
    for k in range(n_op):
        for j in range(R):
            if w[k, j] > 0:
                c, r = divmod(j, g_rows)
                slot[row_ids[k, j]] = (k * n_c + c) * g_rows + r
    return dict(n_dp=n_dp, n_op=n_op, mb=mb, mp=mp, g_rows=g_rows,
                n_c=n_c, R=R, S_u=S_u, S_p=S_p, p0=p0, p1=p1, px0=px0,
                px1=px1, h1=h1, h2=h2, py=py, px=px, Y=Y, X=X, nz=nz,
                nzb=nzb, prebin=prebin, n_rows=n_rows, stride=stride,
                n_last=n_last, row_ids=row_ids, w=w, pos_mc=pos_mc,
                inds_mc=inds_mc, ws_mc=ws_mc, loss_slot=slot, dev=None)


def mc_device_tables(rec) -> Dict:
    """This rank's tables and its share of the measured data on its
    device (made once a run)."""
    mc = rec._mc
    if mc['dev'] is not None:
        return mc['dev']
    k, d = rec.mesh.op, rec.mesh.dp
    dev = rec.device
    inds = mc['inds_mc'][:, k, d]                          # [n_c, g*mp]
    data = np.ascontiguousarray(rec.data[:, inds.reshape(-1)])
    mc['dev'] = dict(
        pos=mc['pos_mc'][:, k, d], inds=inds,
        w=torch.as_tensor(mc['ws_mc'][:, k, d], device=dev),
        data=torch.as_tensor(data, device=dev).reshape(
            (rec.n_theta,) + inds.shape + tuple(data.shape[2:])),
        slot=torch.as_tensor(mc['loss_slot'], device=dev))
    return mc['dev']


def mc_angle_step(rec, i_theta: int, n_b: int) -> torch.Tensor:
    """One angle (``n_b`` batches) of the per-angle mesh path on this
    rank: returns the angle's per-row losses (whole, on every rank), on
    the device."""
    cfg = rec.cfg
    geo = cfg.geometry
    t = cfg.train
    mc = rec._mc
    tab = mc_device_tables(rec)
    mesh = rec.mesh
    comm = mesh.comm
    k = mesh.op
    S_u, S_p, p0 = mc['S_u'], mc['S_p'], mc['p0']
    py, px = mc['py'], mc['px']
    gp, mp, mb = mc['g_rows'], mc['mp'], mc['mb']
    X, nz, Y = mc['X'], mc['nz'], mc['Y']
    prebin = mc['prebin']
    theta = float(rec.theta_ls[i_theta])
    two_d = geo.two_d_mode
    interp = t.interpolation
    ut = t.unknown_type
    obj = rec._obj_up()                                   # [S_u, X, nz, 2]
    if two_d:
        slab = obj
    elif prebin:
        slab = rotate_and_bin_z(obj, theta, geo.binning, method=interp)
    else:
        slab = rotate(obj, theta, method=interp)
    slab = patch_ops.pad_object(
        slab, np.array([[0, 0], [mc['px0'], mc['px1']]], np.int64), ut)
    ext = neighbor_extend(slab, mc['h1'], mc['h2'], mesh)
    start = k * (S_p - S_u)
    win = ext[start:start + S_p + py]
    u = k * S_p - p0 + np.arange(S_p + py)
    valid = (u >= 0) & (u < Y)
    if not valid.all():
        v = torch.as_tensor(valid, device=win.device).reshape(
            (-1,) + (1,) * (win.dim() - 1))
        win = torch.where(v, win, _vacuum_like(win, ut))
    del ext, slab
    if t.run_bfloat16:
        win = win.to(torch.bfloat16)
    zm = rec._zmajor()
    win_zx = win.permute(2, 3, 0, 1).contiguous() if zm else None
    acc = torch.zeros((S_p + py,) + tuple(win.shape[1:]),
                      dtype=torch.float32, device=win.device)
    acc_aux = {n: torch.zeros_like(rec.params[n]) for n in rec.specs
               if n != 'obj'}
    losses = []
    meas_all = tab['data'][i_theta]
    for c in range(mc['n_c']):
        pos_int = np.round(tab['pos'][c]).astype(np.int64)
        if zm:
            sub = patch_ops.extract_patches_zmajor(win_zx, pos_int, (py, px))
        else:
            sub = patch_ops.extract_patches(win, pos_int, (py, px))
        per_row, g_sub, g_aux = rec._patch_grads(
            sub, i_theta, theta, tab['inds'][c], meas_all[c], zm, gp,
            spot_w=tab['w'][c], mb=mb, prebin=prebin)
        for r in range(gp):
            scatter_rowgrid_add_kernel(
                acc, g_sub[r * mp:(r + 1) * mp], pos_int[r * mp, 0],
                pos_int[r * mp, 1], mc['stride'])
        for n, g in g_aux.items():
            acc_aux[n] += g
        losses.append(per_row)
    del win, win_zx
    acc = comm.all_reduce(acc, 'dp')
    # The other leaves' gradients (partial over both axes) and this rank's
    # loss slots, in one sum over the whole mesh.
    names = list(acc_aux)
    slots = torch.zeros((mesh.n_op, mc['n_c'] * gp), device=acc.device)
    slots[k] = torch.stack(losses).reshape(-1)
    red = flat_all_reduce(comm, [acc_aux[n] for n in names] + [slots],
                          ('dp', 'op'))
    grads = dict(zip(names, red[:-1]))
    row_losses = red[-1].reshape(-1)[tab['slot']]
    # Halo add: the accumulator's bottom py rows belong to the next
    # slab's top.
    recv = comm.ring_shift(acc[S_p:].contiguous(), 'op', +1)
    acc_slab = acc[:S_p]
    acc_slab[:py] += recv
    ext2 = neighbor_extend(acc_slab, mc['p1'], p0, mesh)
    start2 = p0 + mc['p1'] - k * (S_p - S_u)
    g_slab = ext2[start2:start2 + S_u, mc['px0']:mc['px0'] + X]
    del acc, ext2
    if two_d:
        g_obj = g_slab
    elif prebin and not t.exact_grad_rotation:
        g_obj = rotate_expanded_from_binned_z(g_slab, -theta, geo.binning,
                                              nz, method=interp)
    else:
        if prebin:
            g_slab = torch.repeat_interleave(g_slab, geo.binning,
                                             dim=2)[:, :, :nz]
        g_obj = (rotate_adjoint(g_slab, theta, method=interp)
                 if t.exact_grad_rotation
                 else rotate(g_slab, -theta, method=interp))
    if rec.reg_list:
        obj_r = obj if two_d else rotate(obj, theta, method=interp)
        rv, g_reg = rec._reg_value_and_grad(obj_r)
        if not two_d:
            g_reg = (rotate_adjoint(g_reg, theta, method=interp)
                     if t.exact_grad_rotation
                     else rotate(g_reg, -theta, method=interp))
        g_obj = g_obj + float(mc['n_rows']) * g_reg
        row_losses = row_losses + rv
    grads['obj'] = g_obj
    rec.apply_step(grads, rec.i_opt_batch, rec.global_batch)
    rec._obj_down()
    rec.i_opt_batch += 1
    rec.global_batch += n_b
    return row_losses


# -- immediate ---------------------------------------------------------------
def build_mc_imm_layout(rec) -> Optional[Dict]:
    """The immediate mesh path's static layout, or None (with the reasons
    in ``rec._mc_decline_reasons``)."""
    cfg = rec.cfg
    geo = cfg.geometry
    if cfg.train.update_scheme != 'immediate':
        return None
    why = rec._mc_decline_reasons
    rg = _row_grid(rec)
    _common_reasons(rec, why, rg)
    if cfg.train.rotate_out_of_loop:
        why.append('rotate_out_of_loop with immediate updates')
    if geo.two_d_mode:
        why.append('2D mode (generic path handles it)')
    if rec.data is None:
        why.append('no in-memory dataset')
    if cfg.train.n_batch_per_update > 1:
        why.append('n_batch_per_update > 1')
    if rec.external_algorithm is not None:
        why.append('external algorithm hook active')
    if rec._off_state:
        why.append('offloaded optimizer state (per-batch host '
                   'streaming would thrash)')
    if why:
        return None
    mesh = rec.mesh
    n_dp, n_op = mesh.n_dp, mesh.n_op
    n_dev = n_dp * n_op
    mb = cfg.train.minibatch_size
    Y, X, nz = geo.obj_size
    py, px = geo.probe_size
    stride, n_last = rg
    p = rec.pad_arr
    px0, px1 = int(p[1][0]), int(p[1][1])
    mpp = -(-mb // n_dev)
    mb_pad = mpp * n_dev
    px1 += stride * (mb_pad - mb)
    from .recon import _band_prebin
    prebin = _band_prebin(cfg)
    nzb = -(-nz // geo.binning) if prebin else nz
    pos = np.asarray(rec.probe_pos, np.float32)
    n_rows = -(-rec.n_pos // mb)
    y0 = np.round(pos[::mb, 0]).astype(np.int64)
    pos_imm = np.zeros((n_rows, mb_pad, 2), np.float32)
    inds_imm = np.zeros((n_rows, mb_pad), np.int64)
    ws_imm = np.zeros((n_rows, mb_pad), np.float32)
    for r in range(n_rows):
        st = r * mb
        n_real = min(mb, rec.n_pos - st)
        pos_imm[r, :n_real] = pos[st:st + n_real]
        j = np.arange(n_real, mb_pad)
        pos_imm[r, n_real:, 0] = pos[st, 0]
        pos_imm[r, n_real:, 1] = (pos[st + n_real - 1, 1]
                                  + stride * (j - (n_real - 1)))
        inds_imm[r] = st + np.minimum(np.arange(mb_pad), n_real - 1)
        ws_imm[r, :n_real] = 1.0
        ws_imm[r, n_real - 1] += mb - n_real
    pos_imm = pos_imm.reshape(n_rows, n_op, n_dp, mpp, 2)
    inds_imm = inds_imm.reshape(n_rows, n_op, n_dp, mpp)
    ws_imm = ws_imm.reshape(n_rows, n_op, n_dp, mpp)
    hbm = _prof.hbm_limit_bytes(rec.device)
    data_dev_bytes = rec.n_theta * n_rows * mpp * py * px * 4
    band_bytes = py * (X + px0 + px1) * nz * 2 * 4
    if data_dev_bytes > ((hbm - _prof.data_headroom_bytes(hbm))
                         - (6 * band_bytes + rec._chunk_bufs * mpp * py
                            * px * nzb * 2 * 4)):
        why.append(f'device-resident data share '
                   f'({data_dev_bytes / 1e9:.2f} GB/device) does not '
                   'fit next to the working set')
        return None
    return dict(n_dp=n_dp, n_op=n_op, mb=mb, mpp=mpp, mb_pad=mb_pad,
                stride=stride, n_last=n_last, px0=px0, px1=px1, py=py,
                px=px, Y=Y, X=X, nz=nz, nzb=nzb, prebin=prebin,
                n_rows=n_rows, y0=y0, pos_imm=pos_imm, inds_imm=inds_imm,
                ws_imm=ws_imm, dev=None)


def mc_imm_device_tables(rec) -> Dict:
    """This rank's immediate tables and data share on its device."""
    mci = rec._mci
    if mci['dev'] is not None:
        return mci['dev']
    k, d = rec.mesh.op, rec.mesh.dp
    inds = mci['inds_imm'][:, k, d]                        # [n_rows, mpp]
    data = np.ascontiguousarray(rec.data[:, inds.reshape(-1)])
    mci['dev'] = dict(
        pos=mci['pos_imm'][:, k, d], inds=inds,
        w=torch.as_tensor(mci['ws_imm'][:, k, d], device=rec.device),
        data=torch.as_tensor(data, device=rec.device).reshape(
            (rec.n_theta,) + inds.shape + tuple(data.shape[2:])))
    return mci['dev']


def mc_imm_ok(rec, batches) -> bool:
    """Whether an epoch's batches are the table's whole rows in scan order
    (the last one ragged, padded by repeats of its last spot)."""
    if (rec._mci is None or rec.loader is not None
            or rec.expand_indices is not None):
        return False
    mb = rec._mci['mb']
    for _, inds in batches:
        inds = np.asarray(inds)
        if len(inds) != mb or inds[0] % mb:
            return False
        expect = np.minimum(np.arange(inds[0], inds[0] + mb), rec.n_pos - 1)
        if not np.array_equal(inds, expect):
            return False
    return True


def mc_imm_step(rec, i_theta: int, i_row: int) -> torch.Tensor:
    """One immediate update on this rank from grid row ``i_row`` of angle
    ``i_theta``; returns the batch's loss (the mesh's sum), on the
    device."""
    from .recon import _band_grad_back, _band_rotate_fwd
    cfg = rec.cfg
    t = cfg.train
    mci = rec._mci
    tab = mc_imm_device_tables(rec)
    mesh = rec.mesh
    comm = mesh.comm
    k = mesh.op
    Y, X, nz = mci['Y'], mci['X'], mci['nz']
    py, px, mb = mci['py'], mci['px'], mci['mb']
    px0, px1 = mci['px0'], mci['px1']
    S_u = Y // mesh.n_op
    theta = float(rec.theta_ls[i_theta])
    obj = rec.params['obj']                               # [S_u, X, nz, 2]
    y0 = int(mci['y0'][i_row])
    u = y0 + np.arange(py)
    loc = u - k * S_u
    own = (loc >= 0) & (loc < S_u)
    band = obj.new_zeros((py,) + tuple(obj.shape[1:]))
    if own.any():
        band[np.nonzero(own)[0]] = obj[loc[own]]
    band = comm.all_reduce(band, 'op')
    valid = (u >= 0) & (u < Y)
    if not valid.all():
        v = torch.as_tensor(valid, device=band.device).reshape(
            (-1,) + (1,) * (band.dim() - 1))
        band = torch.where(v, band, _vacuum_like(band, t.unknown_type))
    rb = _band_rotate_fwd(band, theta, cfg, px0, px1)
    pos_r = tab['pos'][i_row]
    x0s = np.round(pos_r[:, 1]).astype(np.int64) + px0
    posi = np.stack([np.zeros_like(x0s), x0s], 1)
    zm = rec._zmajor()
    if zm:
        sub = patch_ops.extract_patches_zmajor(
            rb.permute(2, 3, 0, 1).contiguous(), posi, (py, px))
    else:
        sub = patch_ops.extract_patches(rb, posi, (py, px))
    loss_part, g_sub, g_aux = rec._patch_grads(
        sub, i_theta, theta, tab['inds'][i_row],
        tab['data'][i_theta, i_row], zm, 1, spot_w=tab['w'][i_row], mb=mb,
        prebin=mci['prebin'])
    acc = torch.zeros((py, X + px0 + px1) + tuple(rb.shape[2:]),
                      dtype=torch.float32, device=obj.device)
    scatter_rowgrid_add_kernel(acc, g_sub, 0, int(x0s[0]), mci['stride'])
    acc = comm.all_reduce(acc, ('dp', 'op'))
    names = list(g_aux)
    red = flat_all_reduce(comm, [g_aux[n] for n in names] + [loss_part],
                          ('dp', 'op'))
    grads = dict(zip(names, red[:-1]))
    loss = red[-1][0]
    g_band = _band_grad_back(acc, theta, cfg, px0, X, nz)
    if rec.reg_list:
        rv, g_obj = rec._reg_value_and_grad(obj)
        loss = loss + rv
    else:
        g_obj = torch.zeros_like(obj)
    if own.any():
        g_obj[loc[own]] += g_band[np.nonzero(own)[0]]
    grads['obj'] = g_obj
    rec.apply_step(grads, rec.i_opt_batch, rec.global_batch)
    rec.i_opt_batch += 1
    return loss
