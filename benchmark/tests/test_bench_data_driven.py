"""A copy of the benchmark takes a new configuration, mix, cell, end-to-end
metric and per-layer metric from added files and BENCHMARK.json entries
alone (the tiny cells of ``data/`` are themselves added that way), and a
run's last line has the contract's shape."""

import json
import shutil
import time

import pytest

from benchmark import harness

from conftest import REPO, add_tiny


@pytest.fixture(scope='module')
def extended(tmp_path_factory):
    root = tmp_path_factory.mktemp('extended')
    shutil.copytree(REPO / 'benchmark', root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    add_tiny(root)
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / 'benchmark').rglob('*') if p.is_file()}
    bench = root / 'benchmark'
    (bench / 'metrics' / 'angles_traced.py').write_text(
        'def read(ctx):\n    return float(ctx.n_angles) or None\n')
    (bench / 'end_to_end' / 'window_wall_s.py').write_text(
        'def read(ctx):\n    return ctx.window_wall_s\n')
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    spec['per_layer'].append({
        'name': 'angles_traced', 'unit': 'angles', 'better': 'higher',
        'source': 'program_counter', 'layer': 'run driver',
        'moves': 'patterns_per_s.host_paced',
        'workloads': ['tiny_db.tiny_grid']})
    spec['end_to_end'].append({
        'name': 'window_wall_s', 'unit': 's', 'better': 'lower',
        'bound': 0.25, 'source': 'host_clock',
        'workloads': ['tiny_db.tiny_grid']})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / 'benchmark').rglob('*') if p.is_file()}
    assert all(after[k] == v for k, v in before.items())   # nothing edited
    return root


def run(root, cell, traced):
    c = harness.load_cell(cell, root, root / 'benchmark')
    return harness.run_cell(c, 3141592653, 0.0, traced, 'cpu',
                            time.perf_counter(), log=lambda *a: None,
                            err=lambda *a: None)


def test_new_cell_and_metrics_from_files(extended):
    untraced = run(extended, 'tiny_db.tiny_grid', False)
    assert set(untraced['metrics']) == {'patterns_per_s.host_paced',
                                        'setup_s', 'window_wall_s'}
    traced = run(extended, 'tiny_db.tiny_grid', True)
    # No card, no device trace: only the counter-based metric reads.
    assert set(traced['metrics']) == {'angles_traced'}
    other = run(extended, 'tiny_mm.tiny_grid', True)
    assert 'angles_traced' not in other['metrics']


def test_last_line_shape(extended):
    r = run(extended, 'tiny_mm.tiny_grid', False)
    line = json.dumps(r)
    back = json.loads(line)
    keys = list(back)
    assert keys[:5] == ['correct', 'attempted', 'failed', 'metrics', 'device']
    assert keys[-1] == 'check'
    assert back['correct'] is True and back['failed'] == 0
    assert back['attempted'] > 0 and back['attempted'] % 8 == 0
    for m in back['metrics'].values():
        assert set(m) == {'value', 'unit'} and m['value'] > 0
    assert set(back['device']) >= {'platform', 'kind', 'count',
                                   'memory_peak_bytes'}
    assert set(back['check']) == {
        f'{n}{when}' for n in ('loss_gap', 'grad_gap', 'change_gap')
        for when in ('', '.after_window')}
    for v in back['check'].values():
        assert set(v) == {'value', 'limit'}
