#!/usr/bin/env python
"""Plot (or print) the convergence curve from an output folder's loss
CSVs, on the port (the JAX package's ``tools/plot_loss_curve.py``).  It
reads files on the host, so the JAX tool's ``--platform`` has no
counterpart here.

    python -m adorym_tpu_torch.tools.plot_loss_curve OUTPUT_FOLDER [--save curve.png]
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('output_folder')
    p.add_argument('--save', help='write a PNG instead of printing')
    args = p.parse_args(argv)

    from adorym_tpu_torch.io.output import parse_loss_data
    curve = parse_loss_data(args.output_folder)
    if args.save:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        plt.semilogy(curve)
        plt.xlabel('batch')
        plt.ylabel('loss')
        plt.savefig(args.save, dpi=120)
        print(f'wrote {args.save}')
    else:
        for i, v in enumerate(curve):
            print(i, v)
    return curve


if __name__ == '__main__':
    main()
