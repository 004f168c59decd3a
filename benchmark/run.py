"""Run one cell of the benchmark of adorym_tpu_torch on its NVIDIA cards.

    python3 benchmark/run.py --workload cone256_db.per_angle --seed 1 \
        --seconds 10 --trace 0

From the root of a checkout.  Prints the spans, then as its last line one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, last, ``check`` (each number the comparison holds to its
limit, which also end standard error).  Exits nonzero with no result
when there is no CUDA card (or fewer than the cell asks for), and when
JAX or the JAX package is loaded.  A cell whose traffic has a
``parallel`` object runs on one rank a card (``mesh.py``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every kernel cache at a fixed path inside the checkout: the port's nvcc
# libraries go to build/adorym_tpu_torch (utils/cuda_build.py); PyTorch's
# runtime-compiled kernels and any extension or Triton build go here.
for _var, _dir in (('PYTORCH_KERNEL_CACHE_PATH', 'torch_kernels'),
                   ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton')):
    os.environ[_var] = str(ROOT / 'build' / _dir)
# One host thread for PyTorch's and numpy's CPU pools: the per-angle path
# is partly paced by the host, and idle pool threads spinning beside the
# one that launches the card's work spread the runs.
for _var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
    os.environ[_var] = '1'
# The checkout's root in place of this folder: the benchmark's modules
# are imported as the package ``benchmark``.
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from benchmark import guard, harness, mesh
    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'{args.workload}: needs {cell.chips} CUDA device(s); '
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 3
    print(f'card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}', file=sys.stderr, flush=True)
    if mesh.parallel(cell) is not None:
        print(f'cards: {torch.cuda.device_count()}; power: '
              f'{harness.power_limit()}', file=sys.stderr, flush=True)
        wall0 = time.time() - (time.perf_counter() - T0)
        return mesh.main(cell, args.seed, args.seconds, bool(args.trace),
                         wall0)
    try:
        result = harness.run_cell(
            cell, args.seed, args.seconds, bool(args.trace), 'cuda:0', T0,
            before_check=lambda: print(f'power: {harness.power_limit()}',
                                       file=sys.stderr, flush=True))
    except guard.Violation as e:
        print(f'loaded: {e}', file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
