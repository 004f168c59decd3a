"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's folder
beside a ``BENCHMARK.json`` that adds the tiny cells of ``data/`` (the
cone configurations at 16^3 with an 8^2 probe, 9 positions an angle), as
a later change would add a cell: by files and entries alone."""

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / 'data'
TINY = ('tiny_db', 'tiny_mm')
TINY_MIX = 'tiny_grid'


def add_tiny(root: Path):
    """``root/benchmark`` (a copy) with the tiny cells' files, and
    ``root/BENCHMARK.json`` with their entries."""
    bench = root / 'benchmark'
    for n in TINY:
        shutil.copy(DATA / f'{n}.json', bench / 'configs' / f'{n}.json')
        shutil.copy(DATA / f'{n}.{TINY_MIX}.limits.json',
                    bench / 'limits' / f'{n}.{TINY_MIX}.json')
    shutil.copy(DATA / f'{TINY_MIX}.json', bench / 'traffic' / f'{TINY_MIX}.json')
    spec = json.loads((REPO / 'BENCHMARK.json').read_text())
    spec['configs'] += [{'name': n, 'source': 'test', 'reduced': [],
                         'file': f'benchmark/configs/{n}.json', 'why': 'test'}
                        for n in TINY]
    cells = [f'{n}.{TINY_MIX}' for n in TINY]
    spec['workloads'] += [{'name': c, 'config': c.split('.')[0],
                           'traffic': TINY_MIX, 'chips': 1, 'why': 'test'}
                          for c in cells]
    # A tiny cell joins each metric that lists the cone cell it shrinks.
    for m in spec['end_to_end'] + spec['per_layer']:
        if 'workloads' in m:
            m['workloads'] += [c for c in cells if any(
                w.startswith('cone256_' + c.split('.')[0].split('_')[1] + '.')
                for w in m['workloads'])]
    (root / 'BENCHMARK.json').write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(scope='session')
def bench_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('checkout')
    shutil.copytree(REPO / 'benchmark', root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    return add_tiny(root)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
