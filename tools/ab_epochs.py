"""Time the flagship epochs of two or more checkouts of the repo in turns,
on one CUDA card.

    python tools/ab_epochs.py DIR_A DIR_B [--paths delta_beta,...]
                              [--rounds 2] [--bf16]

Each ``DIR`` is the root of a checkout (for example a ``git archive`` of a
parent commit).  For each path and round, every checkout runs
``chip_smoke.run_flagship`` (a warmup epoch and 3 timed epochs of the
flagship through ``Reconstructor``, f32, or bf16 storage with
``--bf16``, its launch counts checked) in a process of its own, in the
order A, B, ..., then reversed, so each checkout runs first and last in
turn.  Prints the card's name and power
limit first and, per path, every run's median patterns/s by checkout.
"""

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

RUN = ('import sys, chip_smoke as cs; '
       'rate, _ = cs.run_flagship(sys.argv[2] == "bf16", sys.argv[1], 3); '
       'print("RATE", rate, flush=True)')


def run(root, path, bf16=False):
    """Median patterns/s of one flagship run of the checkout at ``root``."""
    proc = subprocess.run([sys.executable, '-c', RUN, path,
                           'bf16' if bf16 else 'f32'], cwd=root,
                          capture_output=True, text=True, timeout=900)
    rates = [float(line.split()[1]) for line in proc.stdout.splitlines()
             if line.startswith('RATE ')]
    if proc.returncode or not rates:
        raise RuntimeError(f'{root} {path}:\n{proc.stdout}\n{proc.stderr}')
    return rates[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('dirs', nargs='+')
    ap.add_argument('--paths', default='delta_beta,multimode_binned')
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--bf16', action='store_true')
    args = ap.parse_args()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    roots = [str(Path(d).resolve()) for d in args.dirs]
    for path in args.paths.split(','):
        rates = {d: [] for d in args.dirs}
        for _ in range(args.rounds):
            for d, root in (list(zip(args.dirs, roots))
                            + list(zip(args.dirs, roots))[::-1]):
                rates[d].append(run(root, path, args.bf16))
                print(f'{path} {d}: {rates[d][-1]:.1f} patterns/s',
                      flush=True)
        for d, r in rates.items():
            print(f'{path} {d}: median {statistics.median(r):.1f} over '
                  f'{[round(x, 1) for x in r]}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
