"""Time phase 8e (sparse slices on the band step, K6 a row) of two or more
checkouts of the repo in turns, on one CUDA card.

    python tools/ab_sparse.py DIR_A DIR_B [--rounds 2] [--runs 3]

Each ``DIR`` is the root of a checkout (for example a ``git archive`` of a
parent commit).  For each round, every checkout runs
``chip_smoke.run_sparse_flagship`` ``--runs`` times (each a warmup and a
timed epoch of the flagship's probe and scan over a [256, 256, 2] object
at two slice positions, its launches checked) in a process of its own, in
the order A, B, ..., then reversed, so each checkout runs first and last
in turn.  Prints the card's name and power limit first, then each
process's median patterns/s and each checkout's median over all.
"""

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

RUN = ('import sys, chip_smoke as cs; '
       '[print("RATE", cs.run_sparse_flagship()[0], flush=True) '
       'for _ in range(int(sys.argv[1]))]')


def run(root, runs):
    """Patterns/s of ``runs`` 8e runs of the checkout at ``root``."""
    proc = subprocess.run([sys.executable, '-c', RUN, str(runs)], cwd=root,
                          capture_output=True, text=True, timeout=900)
    rates = [float(line.split()[1]) for line in proc.stdout.splitlines()
             if line.startswith('RATE ')]
    if proc.returncode or len(rates) != runs:
        raise RuntimeError(f'{root}:\n{proc.stdout}\n{proc.stderr}')
    return rates


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('dirs', nargs='+')
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--runs', type=int, default=3)
    args = ap.parse_args()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    roots = [str(Path(d).resolve()) for d in args.dirs]
    rates = {d: [] for d in args.dirs}
    for _ in range(args.rounds):
        for d, root in (list(zip(args.dirs, roots))
                        + list(zip(args.dirs, roots))[::-1]):
            r = run(root, args.runs)
            rates[d] += r
            print(f'8e {d}: median {statistics.median(r):.1f} patterns/s '
                  f'over {[round(x, 1) for x in r]}', flush=True)
    for d, r in rates.items():
        print(f'8e {d}: median {statistics.median(r):.1f} over '
              f'{[round(x, 1) for x in r]}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
