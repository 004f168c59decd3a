"""The import guard compares whole top-level names: the port's name
begins with the JAX package's."""

import subprocess
import sys
from pathlib import Path

from benchmark import guard

REPO = Path(__file__).resolve().parents[2]


def test_guard_names():
    assert guard.loaded(['adorym_tpu_torch', 'adorym_tpu_torch.recon',
                         'jaxtyping', 'flaxen', 'numpy']) == []
    assert guard.loaded(['adorym_tpu.recon', 'jax.numpy', 'jaxlib',
                         'flax.core', 'adorym_tpu_torch']) == [
        'adorym_tpu', 'flax', 'jax', 'jaxlib']


def test_the_benchmark_and_the_port_load_no_jax():
    code = ('import sys; sys.path.insert(0, %r); import torch; '
            'import adorym_tpu_torch, adorym_tpu_torch.recon; '
            'from benchmark import harness, calibrate, faults, check; '
            'from benchmark import guard; print(guard.loaded())' % str(REPO))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'cone256_db.per_angle', '--seed', '2147483650', '--seconds', '1',
         '--trace', '0'], capture_output=True, text=True, cwd=REPO,
        timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
