#!/usr/bin/env python
"""Monitor a live reconstruction from its output folder, on the port (the
JAX package's ``tools/monitor_reconstruction.py``): tail the loss CSVs and
render the latest intermediate object and probe dumps.  One-shot by
default; ``--watch N`` refreshes every N seconds until interrupted.

Examples:
  python -m adorym_tpu_torch.tools.monitor_reconstruction recon_output
  python -m adorym_tpu_torch.tools.monitor_reconstruction recon_output --watch 10
  python -m adorym_tpu_torch.tools.monitor_reconstruction recon_output --save status.png
"""

import argparse
import glob
import os
import time

import numpy as np


def latest_tiff(folder, prefix):
    """Newest ``intermediate/<prefix>*.tiff`` (falls back to the final
    top-level dump)."""
    pats = [os.path.join(folder, 'intermediate', f'{prefix}*.tif*'),
            os.path.join(folder, f'{prefix}*.tif*')]
    cands = [p for pat in pats for p in glob.glob(pat)]
    if not cands:
        return None
    return max(cands, key=os.path.getmtime)


def read_loss_rows(folder):
    """``[N, 3]`` (epoch, batch, loss) rows averaged across the per-rank
    CSVs (``convergence/loss_rank_*.txt``, reference format
    ``i_epoch,i_batch,loss,time``)."""
    paths = sorted(glob.glob(os.path.join(folder, 'convergence',
                                          'loss_rank_*.txt')))
    curves = []
    for p in paths:
        try:
            rows = np.genfromtxt(p, delimiter=',', names=True)
        except Exception:
            continue
        if rows.size:
            curves.append(np.stack([np.atleast_1d(rows['i_epoch']),
                                    np.atleast_1d(rows['i_batch']),
                                    np.atleast_1d(rows['loss'])], -1))
    if not curves:
        return np.zeros((0, 3))
    n = min(len(c) for c in curves)
    out = curves[0][:n].copy()
    out[:, 2] = np.mean([c[:n, 2] for c in curves], axis=0)
    return out


def status(folder, tail=5):
    """Gather (loss rows, tail rows, latest object/probe dump paths).
    Objects dump as ``delta_*`` (delta_beta runs) or ``obj_mag_*``
    (real_imag runs)."""
    curve = read_loss_rows(folder)
    rows = curve[-tail:] if len(curve) else curve
    obj_path = (latest_tiff(folder, 'delta')
                or latest_tiff(folder, 'obj_mag'))
    return curve, rows, obj_path, latest_tiff(folder, 'probe_mag')


def report(folder, tail=5):
    curve, rows, obj_path, probe_path = status(folder, tail)
    lines = [f'== {folder} @ {time.strftime("%H:%M:%S")} ==']
    if len(curve):
        lines.append(f'{len(curve)} logged batches; last loss '
                     f'{curve[-1, 2]:.6e} (epoch {int(curve[-1, 0])}, '
                     f'batch {int(curve[-1, 1])})')
        for ep, b, l in rows:
            lines.append(f'  epoch {int(ep):4d} batch {int(b):4d} '
                         f'loss {l:.6e}')
    else:
        lines.append('no loss CSVs yet (convergence/loss_rank_*.txt)')
    lines.append(f'latest object dump: {obj_path or "(none)"}')
    lines.append(f'latest probe dump:  {probe_path or "(none)"}')
    return '\n'.join(lines), curve, obj_path, probe_path


def save_figure(path, curve, obj_path, probe_path):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from adorym_tpu_torch.io.output import read_tiff
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    ax = axes[0]
    if len(curve):
        ax.semilogy(np.arange(len(curve)), curve[:, 2])
    ax.set_title('loss')
    ax.set_xlabel('batch')
    for ax, p, title in ((axes[1], obj_path, 'object (delta)'),
                         (axes[2], probe_path, 'probe magnitude')):
        if p is not None:
            img = read_tiff(p)
            while img.ndim > 2:
                img = img[..., img.shape[-1] // 2] if img.shape[-1] < \
                    img.shape[0] else img[img.shape[0] // 2]
            ax.imshow(img, cmap='gray')
        ax.set_title(title)
        ax.axis('off')
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('output_folder')
    p.add_argument('--tail', type=int, default=5,
                   help='loss rows to print (default 5)')
    p.add_argument('--watch', type=float, metavar='SECONDS',
                   help='refresh every N seconds until Ctrl-C')
    p.add_argument('--save', metavar='PNG',
                   help='also write a status figure (loss curve + latest '
                        'object/probe dumps)')
    args = p.parse_args()

    while True:
        text, curve, obj_path, probe_path = report(args.output_folder,
                                                   args.tail)
        print(text, flush=True)
        if args.save:
            save_figure(args.save, curve, obj_path, probe_path)
            print(f'figure -> {args.save}', flush=True)
        if args.watch is None:
            break
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            break


if __name__ == '__main__':
    main()
