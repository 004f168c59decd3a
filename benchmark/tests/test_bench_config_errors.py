"""A configuration whose reference, object start or settings cannot be run
fails before the program's Reconstructor is built, and the message names
the file or the key."""

import json
import shutil
import time

import pytest

from benchmark import harness, mesh

from conftest import DATA, REPO, TINY_MIX

SEED = 2 ** 31 + 3


@pytest.fixture
def no_reconstructor(monkeypatch):
    """The program's Reconstructor replaced by one that fails the test."""
    from adorym_tpu_torch import recon

    def built(*args, **kwargs):
        raise AssertionError('the Reconstructor was built')
    monkeypatch.setattr(recon, 'Reconstructor', built)


def tiny_cell(root, config: str, traffic: str, chips: int = 1,
              **changes) -> str:
    """``config`` of ``data/`` with ``changes``, as the configuration
    ``bad`` (``root/bad.json``) of a ``root/BENCHMARK.json`` whose one cell
    runs it on ``traffic``; returns the cell's name."""
    cfg = dict(json.loads((DATA / f'{config}.json').read_text()), name='bad',
               **changes)
    (root / 'bad.json').write_text(json.dumps(cfg))
    spec = json.loads((REPO / 'BENCHMARK.json').read_text())
    spec['configs'] = [{'name': 'bad', 'source': 'test', 'reduced': [],
                        'why': 'test', 'file': 'bad.json'}]
    spec['workloads'] = [{'name': f'bad.{traffic}', 'config': 'bad',
                          'traffic': traffic, 'chips': chips, 'why': 'test'}]
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    return f'bad.{traffic}'


def set_up(root, bench, **changes):
    name = tiny_cell(root, 'tiny_db', TINY_MIX, **changes)
    cell = harness.load_cell(name, root, bench)
    return harness.set_up(cell, SEED, 'cpu',
                          harness.Spans(time.perf_counter()), n_warm=3)


def test_unknown_reference(tmp_path, bench_root):
    bench = bench_root / 'benchmark'
    name = tiny_cell(tmp_path, 'tiny_db', TINY_MIX,
                     reference='nowhere')
    with pytest.raises(ValueError) as e:
        harness.load_cell(name, tmp_path, bench)
    assert 'bad.json' in str(e.value)
    assert str(bench / 'reference' / 'nowhere.py') in str(e.value)


@pytest.mark.parametrize('ref', ['../harness', 'sub/ptycho', '..',
                                 'ptycho.py', ''])
def test_reference_that_is_no_module_name(tmp_path, bench_root, ref):
    """``../harness`` would name a file that exists."""
    bench = bench_root / 'benchmark'
    name = tiny_cell(tmp_path, 'tiny_db', TINY_MIX, reference=ref)
    with pytest.raises(ValueError, match='"reference"') as e:
        harness.load_cell(name, tmp_path, bench)
    assert 'bad.json' in str(e.value)


@pytest.mark.parametrize('settings, key', [
    ({'train': {'no_such_field': 1}}, 'settings.train.no_such_field'),
    ({'geometry': {'run_bfloat16': True}}, 'settings.geometry.run_bfloat16'),
    ({'optics': {'binning': 2}}, 'settings.optics'),
])
def test_setting_that_no_dataclass_has(tmp_path, bench_root,
                                       no_reconstructor, settings, key):
    with pytest.raises(ValueError, match=key.replace('.', r'\.')):
        set_up(tmp_path, bench_root / 'benchmark', settings=settings)


@pytest.mark.parametrize('settings, key', [
    ({'train': {'learning_rate': 1e-6}}, 'settings.train.learning_rate'),
    ({'geometry': {'binning': 2}}, 'settings.geometry.binning'),
    ({'train': {'minibatch_size': 9}}, 'settings.train.minibatch_size'),
    ({'train': {'seed': 4}}, 'settings.train.seed'),
    ({'refine': {'probe_learning_rate': 1.0}},
     'settings.refine.probe_learning_rate'),
])
def test_setting_also_given_flat(tmp_path, bench_root, no_reconstructor,
                                 settings, key):
    with pytest.raises(ValueError, match=key.replace('.', r'\.')):
        set_up(tmp_path, bench_root / 'benchmark', settings=settings)


@pytest.mark.parametrize('start', [
    {'means': [1, 0], 'sigmas': [0, 0], 'delta_mean': 8.7e-07},
    {'means': [1, 0], 'delta_sigma': 1e-7, 'beta_mean': 0.0,
     'beta_sigma': 0.0},
    {'means': [1, 0, 0], 'sigmas': [0, 0, 0]},
])
def test_object_start_that_mixes_the_forms(tmp_path, bench_root,
                                           no_reconstructor, start):
    with pytest.raises(ValueError, match='object_init'):
        set_up(tmp_path, bench_root / 'benchmark', object_init=start)


@pytest.mark.parametrize('entry', ['main', 'calibrate'])
def test_mesh_refuses_another_reference(tmp_path, entry):
    """Before any rank starts."""
    bench = tmp_path / 'benchmark'
    shutil.copytree(REPO / 'benchmark', bench,
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    (bench / 'reference' / 'ptycho_alias.py').write_text(
        'from benchmark.reference.ptycho import *  # noqa: F401,F403\n')
    shutil.copy(DATA / 'tiny_dist.json', bench / 'traffic' / 'tiny_dist.json')
    name = tiny_cell(tmp_path, 'tiny_mesh', 'tiny_dist', chips=4,
                     reference='ptycho_alias')
    cell = harness.load_cell(name, tmp_path, bench)
    with pytest.raises(ValueError, match='"reference"') as e:
        if entry == 'main':
            mesh.main(cell, SEED, 0.0, False, time.time(), backend='gloo',
                      devices=['cpu'] * 4, log=lambda *a: None,
                      err=lambda *a: None)
        else:
            mesh.calibrate(cell, [SEED], ['sound'], time.time(),
                           backend='gloo', devices=['cpu'] * 4)
    assert str(bench / 'reference' / 'ptycho_alias.py') in str(e.value)
