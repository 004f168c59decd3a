"""The plain reference's run (:func:`.ptycho.follow`) kept to a band of the
object's y rows, for objects that no card holds whole with their Adam
state.

Each stage of the per-angle step keeps to rows: the rotation about the y
axis and the bin in z map each y row onto itself; a pattern's window reads
the ``py`` rows below its top row; the gradient goes back along the same
rows; Adam acts element by element.  So the reference's steps kept to the
rows ``[a, b)`` need, at step ``s`` of ``n``, the minibatches whose windows
reach ``[a, b)``'s cone ``T[s]`` (the rows whose value after step ``s`` a
later step reads), and the object before step ``s`` over the rows of their
windows, which is ``T[s - 1]``.  Given the starting object over ``T[0]``,
the steps are the whole reference's on those rows, exactly: the same
operations (:mod:`.ptycho`'s) on the same values, summed in another order.

Each minibatch's loss is reported by the band that holds its window's
first row in the object (the rows above the object, its vacuum padding,
count as row 0), so that bands that split the object report each once.
Norms are returned as sums of squares over the band, for bands to add up.

Imports only torch, numpy and :mod:`.ptycho`.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import ptycho

#: Object rows a rotation, a bin or an Adam update takes at a time.
ROW_CHUNK = 32
#: Bytes of transmissions one block of minibatches may hold (one
#: minibatch at the least): a few minibatches a block, since at the mesh
#: cells' sizes the sweep's small matmuls are paced by their launches.
BLOCK_BYTES = 4e9

Rows = Tuple[int, int]


def batch_rows(iy: np.ndarray, pad0: int, batch) -> Rows:
    """Object rows ``[lo, hi)`` of a minibatch's windows (below 0 and past
    the object: its vacuum padding)."""
    r = iy[np.asarray(batch)]
    return int(r.min()) - pad0, int(r.max()) + 1 - pad0


def cones(windows: Sequence[Sequence[Rows]], keep: Rows,
          n_rows: int) -> List[Rows]:
    """``T[0..n]``: ``T[n] = keep``; ``T[s - 1]`` holds ``T[s]`` and every
    window of step ``s`` (``windows[s - 1]``) that reaches ``T[s]``,
    cut to the object's ``n_rows``."""
    n = len(windows)
    t = [None] * (n + 1)
    t[n] = keep
    for s in range(n, 0, -1):
        lo, hi = t[s]
        for wlo, whi in windows[s - 1]:
            if whi > t[s][0] and wlo < t[s][1]:
                lo, hi = min(lo, max(wlo, 0)), max(hi, min(whi, n_rows))
        t[s - 1] = (lo, hi)
    return t


def _sq(t: torch.Tensor) -> float:
    return float(t.detach().double().square().sum())


def follow(cfg: dict, obj_rows: torch.Tensor, rows0: Rows, probe0,
           steps: Sequence[dict], positions, keep: Rows,
           precision: str = 'f32') -> Dict[str, object]:
    """:func:`.ptycho.follow` kept to the object rows ``keep``.
    ``obj_rows``: the starting object over the rows ``rows0``, which must
    hold :func:`cones`' ``T[0]`` (updated in place); ``steps``: each
    ``{'theta', 'batches', 'measured'}`` (the angle's magnitudes, every
    spot).  Returns ``{'losses': [{batch index: loss}] a step (the
    minibatches this band reports), 'grad1_sq': the first gradient's sum
    of squares over ``keep``, 'change_sq': the change's after the last
    step, 'seconds': [a step]}``; the probe is not refined."""
    if cfg.get('optimize_probe'):
        raise ValueError('the row-kept reference refines the object alone')
    dev = obj_rows.device
    ny, nx, nz = (int(v) for v in cfg['obj_size'])
    py, px = cfg['probe_size']
    binning = int(cfg['binning'])
    psize_nm = cfg['psize_cm'] * 1e7
    lmbda_nm = ptycho.HC_EV_NM / cfg['energy_ev']
    k1 = 2 * math.pi * psize_nm / lmbda_nm
    tr = ptycho.Transforms(py, px, psize_nm, lmbda_nm, psize_nm * binning,
                           dev, precision)
    lr = cfg['learning_rate']
    iy, ix, pads = ptycho.windows(positions, (py, px), (ny, nx))
    p0, (px0, px1) = pads[0][0], pads[1]
    wins = [[batch_rows(iy, p0, b) for b in st['batches']] for st in steps]
    t = cones(wins, keep, ny)
    r0 = rows0[0]
    if not (rows0[0] <= t[0][0] and t[0][1] <= rows0[1]
            and obj_rows.shape[0] == rows0[1] - rows0[0]):
        raise ValueError(f'the steps read the rows {t[0]}; given {rows0}')
    a, b = keep
    keep0 = obj_rows[a - r0:b - r0].to('cpu', copy=True)
    m1 = t[1] if steps else keep
    state = {'m': obj_rows.new_zeros((m1[1] - m1[0],) + obj_rows.shape[1:]),
             'v': obj_rows.new_zeros((m1[1] - m1[0],) + obj_rows.shape[1:])}
    nb = -(-nz // binning)
    width = nx + px0 + px1
    out: Dict[str, object] = {'losses': [], 'grad1_sq': 0.0,
                              'change_sq': 0.0, 'seconds': []}
    with tr.tf32_off():
        for s, st in enumerate(steps, start=1):
            t0 = time.perf_counter()
            theta = st['theta']
            reach = [j for j, (wlo, whi) in enumerate(wins[s - 1])
                     if whi > t[s][0] and wlo < t[s][1]]
            u_lo = min(wins[s - 1][j][0] for j in reach) + p0
            u_hi = max(wins[s - 1][j][1] for j in reach) + p0
            # The rotated, binned object over the windows' rows, in the
            # whole reference's padded frame, vacuum past the object.
            slab = obj_rows.new_zeros((u_hi - u_lo, width, nb, 2))
            y_lo, y_hi = max(u_lo - p0, 0), min(u_hi - p0, ny)
            for y in range(y_lo, y_hi, ROW_CHUNK):
                y1 = min(y + ROW_CHUNK, y_hi)
                slab[y + p0 - u_lo:y1 + p0 - u_lo, px0:px0 + nx] = \
                    ptycho.bin_z(ptycho.rotate_y(obj_rows[y - r0:y1 - r0],
                                                 theta), binning)
            slab.requires_grad_(True)
            g_slab = torch.zeros_like(slab)
            mb = len(st['batches'][0])
            per_block = max(1, int(BLOCK_BYTES // (nb * mb * py * px * 8)))
            losses = {}
            for k0 in range(0, len(reach), per_block):
                blk = reach[k0:k0 + per_block]
                spots = np.concatenate([np.asarray(st['batches'][j])
                                        for j in blk])
                ry = torch.from_numpy(iy[spots] - u_lo).to(dev)
                rx = torch.from_numpy(ix[spots]).to(dev)
                with torch.enable_grad():
                    patches = slab[ry[:, :, None], rx[:, None, :]]
                    mag = ptycho.magnitudes(tr, patches, probe0, k1)
                    meas = st['measured'][torch.from_numpy(spots).to(dev)]
                    per_batch = ((mag - meas) ** 2).mean((1, 2)).reshape(
                        len(blk), -1).mean(1)
                    (g,) = torch.autograd.grad(per_batch.sum(), [slab])
                g_slab += g
                for j, v in zip(blk, per_batch.detach().cpu()):
                    if a <= max(wins[s - 1][j][0], 0) < b:
                        losses[j] = float(v)
                del patches, mag, g
            out['losses'].append(losses)
            del slab
            # The gradient over T[s], expanded and rotated back row chunk
            # by row chunk, and Adam there.
            lo, hi = t[s]
            for y in range(lo, hi, ROW_CHUNK):
                y1 = min(y + ROW_CHUNK, hi)
                g_bin = g_slab.new_zeros((y1 - y, nx, nb, 2))
                c_lo, c_hi = max(y, u_lo - p0), min(y1, u_hi - p0)
                if c_lo < c_hi:
                    g_bin[c_lo - y:c_hi - y] = g_slab[
                        c_lo + p0 - u_lo:c_hi + p0 - u_lo, px0:px0 + nx]
                g_obj = ptycho.rotate_y(ptycho.expand_z(g_bin, binning, nz),
                                        -theta)
                if s == 1 and max(y, a) < min(y1, b):
                    out['grad1_sq'] += _sq(g_obj[max(y, a) - y:min(y1, b) - y])
                sl = slice(y - m1[0], y1 - m1[0])
                p, new = ptycho.adam(obj_rows[y - r0:y1 - r0], g_obj,
                                     {'m': state['m'][sl],
                                      'v': state['v'][sl]}, s, lr)
                obj_rows[y - r0:y1 - r0] = p
                state['m'][sl], state['v'][sl] = new['m'], new['v']
            del g_slab
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            out['seconds'].append(time.perf_counter() - t0)
    del state
    for y in range(a, b, ROW_CHUNK):
        y1 = min(y + ROW_CHUNK, b)
        out['change_sq'] += _sq(obj_rows[y - r0:y1 - r0]
                                - keep0[y - a:y1 - a].to(dev))
    return out
