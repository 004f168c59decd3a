"""A copy of the benchmark takes a new configuration, mix, cell, end-to-end
metric and per-layer metric from added files and BENCHMARK.json entries
alone (the tiny cells of ``data/`` are themselves added that way), a
configuration's own reference module, object start and Reconstructor
setting too, and a run's last line has the contract's shape."""

import json
import shutil
import time

import pytest

from benchmark import harness

from conftest import DATA, REPO, add_tiny

#: Configurations added with a reference module of their own: the tiny
#: delta_beta cone's physics under another module's name, its start in the
#: per-channel form and one Reconstructor setting.
NAMED = {'tiny_named': 'ptycho_alias', 'tiny_judged': 'ptycho_doubled'}
REFERENCES = {
    'ptycho_alias': (
        '"""The ptycho reference under another name."""\n'
        'from benchmark.reference.ptycho import *  # noqa: F401,F403\n'),
    'ptycho_doubled': (
        '"""The ptycho reference with each loss doubled."""\n'
        'from benchmark.reference import ptycho\n'
        'from benchmark.reference.ptycho import *  # noqa: F401,F403\n'
        '\n\n'
        'def follow(*args, **kwargs):\n'
        '    out = ptycho.follow(*args, **kwargs)\n'
        "    out['losses'] = [2 * v for v in out['losses']]\n"
        '    return out\n'),
}
SETTING = ('train', 'max_nepochs', 7)


def add_named(root, spec):
    """The ``NAMED`` configurations, their reference modules and limits as
    files of ``root/benchmark``, and their cells on ``tiny_grid`` in
    ``spec``, each joining the metrics of ``tiny_db.tiny_grid``."""
    bench = root / 'benchmark'
    for mod, text in REFERENCES.items():
        (bench / 'reference' / f'{mod}.py').write_text(text)
    base = json.loads((DATA / 'tiny_db.json').read_text())
    o = base.pop('object_init')
    group, key, value = SETTING
    for name, mod in NAMED.items():
        cfg = dict(base, name=name, reference=mod,
                   object_init={'means': [o['delta_mean'], o['beta_mean']],
                                'sigmas': [o['delta_sigma'], o['beta_sigma']]},
                   settings={group: {key: value}})
        (bench / 'configs' / f'{name}.json').write_text(json.dumps(cfg))
        shutil.copy(DATA / 'tiny_db.tiny_grid.limits.json',
                    bench / 'limits' / f'{name}.tiny_grid.json')
        spec['configs'].append({'name': name, 'source': 'test',
                                'reduced': [], 'why': 'test',
                                'file': f'benchmark/configs/{name}.json'})
        spec['workloads'].append({'name': f'{name}.tiny_grid', 'config': name,
                                  'traffic': 'tiny_grid', 'chips': 1,
                                  'why': 'test'})
        for m in spec['end_to_end'] + spec['per_layer']:
            if 'tiny_db.tiny_grid' in m.get('workloads', []):
                m['workloads'].append(f'{name}.tiny_grid')


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
    add_named(root, spec)
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


def test_named_reference_object_start_and_setting_from_files(extended):
    cell = harness.load_cell('tiny_named.tiny_grid', extended,
                             extended / 'benchmark')
    assert cell.reference == (extended / 'benchmark' / 'reference'
                              / 'ptycho_alias.py')
    group, key, value = SETTING
    cfg = harness.reconstructor_config(cell, 5)
    assert getattr(getattr(cfg, group), key) == value
    r = run(extended, 'tiny_named.tiny_grid', False)
    assert r['correct'] is True, r['check']


def test_the_named_reference_judges(extended):
    """The same cell judged by a module whose losses are twice the
    reference's fails by ``loss_gap`` alone: |L - 2L| / 2L = 1/2."""
    r = run(extended, 'tiny_judged.tiny_grid', False)
    assert r['correct'] is False
    judged = r['check']
    for n, v in judged.items():
        if n.split('.')[0] == 'loss_gap':
            assert abs(v['value'] - 0.5) < 1e-3, (n, v)
        else:
            assert v['value'] <= v['limit'], (n, v)
