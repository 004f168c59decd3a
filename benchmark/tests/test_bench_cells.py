"""Every cell of BENCHMARK.json resolves to its files, and the file keeps
to the benchmark's contract as far as a reading can show."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness, mesh

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
CELLS = [w['name'] for w in SPEC['workloads']]


def test_top_level_keys():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['benchmark']
    assert 1 <= SPEC['run_seconds'] <= 51
    for word in SPEC['command']:
        assert not word.startswith('/') and '..' not in word
    assert (REPO / SPEC['command'][1]).exists()


def test_names_and_entries():
    names = [e['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for e in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k, keys in (('configs', {'name', 'source', 'file', 'reduced', 'why'}),
                    ('workloads', {'name', 'config', 'traffic', 'chips', 'why'}),
                    ('end_to_end', {'name', 'unit', 'better', 'bound', 'source'}),
                    ('per_layer', {'name', 'unit', 'better', 'source', 'layer',
                                   'moves'})):
        names = [e['name'] for e in SPEC[k]]
        assert len(names) == len(set(names))
        for e in SPEC[k]:
            assert set(e) - {'workloads'} == keys, e['name']
    e2e = {m['name'] for m in SPEC['end_to_end']}
    assert 'setup_s' in e2e
    for m in SPEC['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in SPEC['per_layer']:
        assert m['moves'] in e2e
        assert set(m.get('workloads', CELLS)) <= set(CELLS)


def test_every_config_is_used_and_its_file_is_under_paths():
    used = {w['config'] for w in SPEC['workloads']}
    assert used == {c['name'] for c in SPEC['configs']}
    for c in SPEC['configs']:
        assert c['file'].startswith('benchmark/')
        cfg = json.loads((REPO / c['file']).read_text())
        assert cfg['name'] == c['name'] and cfg['source'] == c['source']
        assert cfg['reduced'] == c['reduced']


@pytest.mark.parametrize('cell', CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell, REPO)
    par = mesh.parallel(c)
    assert c.chips == (1 if par is None else mesh.world_of(c))
    bench = REPO / 'benchmark'
    assert (bench / 'traffic' / f"{c.traffic['name']}.json").exists()
    assert set(c.limits) == {'loss_gap', 'grad_gap', 'change_gap'}
    for m in c.end_to_end:
        assert harness._named(bench / 'end_to_end', m['name']).exists()
    for m in c.per_layer:
        assert harness._named(bench / 'metrics', m['name']).exists()
    names = {m['name'] for m in c.end_to_end}
    assert 'setup_s' in names and len(names) >= 2 and c.per_layer
