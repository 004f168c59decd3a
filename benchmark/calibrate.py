"""The readings that the comparison's limits are set from, for one cell,
over many seeds in one process: the program's own (``sound``), the
control (``control``: the plain reference with its DFTs' operands rounded
to TF32, the precision below the configuration's, put in the program's
place), and each planted fault (``half``, ``alter``, ``unchanged``; see
``faults.py``; ``stale`` shows only in the steps a run takes after its
window).  Each reading takes the program through its first steps at the
cell's own size, as a run's set-up does, and needs no measured window.

    python3 benchmark/calibrate.py --workload cone256_db.per_angle \
        --seeds 1-12 --modes sound,control --out calib.json

Prints one line a reading and writes them all to ``--out``.  Not run by
the benchmark's runs.  A mesh cell's readings are taken on its ranks
(``mesh.calibrate``: the program once a seed and mode, the reference once
a seed), where ``exchange`` (no halo between the ranks) is a fault too.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
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
sys.path[0] = str(ROOT)


def seeds(text: str):
    out = []
    for part in text.split(','):
        if '-' in part:
            a, b = part.split('-')
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def readings(cell, seed: int, mode: str, device, bench_root=None):
    """The comparison's numbers of one seed under ``mode``."""
    import torch
    from benchmark import check, faults, harness
    spans = harness.Spans(time.perf_counter())
    fault = mode if mode in faults.KINDS else None
    if fault:
        with faults.planted(fault):
            su = harness.set_up(cell, seed, device, spans,
                                n_warm=harness.N_CHECK)
    else:
        su = harness.set_up(cell, seed, device, spans, n_warm=harness.N_CHECK)
    su.rec = None
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    ref = harness.follow_reference(cell, su, device)
    if mode == 'control':
        prog = harness.follow_reference(cell, su, device, precision='tf32')
    else:
        prog = check.program_side(su.steps, su.obj0, su.probe0, su.leaves)
    return check.numbers(prog, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True, help='e.g. 1-12 or 5,9,40')
    p.add_argument('--modes', default='sound,control')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    import torch
    from benchmark import harness, mesh
    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 3
    print(f'card: {harness.power_limit()}', flush=True)
    rows = []
    if mesh.parallel(cell) is not None:
        code, rows = mesh.calibrate(cell, seeds(args.seeds),
                                    args.modes.split(','), time.time())
        for row in rows:
            print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(rows, indent=1))
        return code
    for mode in args.modes.split(','):
        for s in seeds(args.seeds):
            t = time.perf_counter()
            v = readings(cell, s, mode, 'cuda:0')
            rows.append({'cell': cell.name, 'mode': mode, 'seed': s, **v,
                         'seconds': time.perf_counter() - t})
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
