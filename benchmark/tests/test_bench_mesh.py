"""The harness's mesh cells on four gloo ranks on the CPU: a tiny cut of
``cone1408_db.dist_object`` (a 96^3 object in four 24-row y slabs, a 16^2
probe, an 11x11 grid) added by files and entries alone; the row-kept
reference against the whole one; faults, failing ranks, and the one-card
cells resolved as before."""

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, harness, inputs, mesh
from benchmark.reference import ptycho, rows

from conftest import DATA, REPO

CELL = 'tiny_mesh.tiny_dist'
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def add_mesh(root: Path) -> Path:
    """``root/benchmark`` (a copy) and ``root/BENCHMARK.json`` with the
    tiny mesh cell, which joins every metric of the cell it shrinks."""
    bench = root / 'benchmark'
    shutil.copytree(REPO / 'benchmark', bench,
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(DATA / 'tiny_mesh.json', bench / 'configs' / 'tiny_mesh.json')
    shutil.copy(DATA / 'tiny_dist.json', bench / 'traffic' / 'tiny_dist.json')
    shutil.copy(DATA / f'{CELL}.limits.json',
                bench / 'limits' / f'{CELL}.json')
    spec = json.loads((REPO / 'BENCHMARK.json').read_text())
    spec['configs'].append({'name': 'tiny_mesh', 'source': 'test',
                            'reduced': [], 'why': 'test',
                            'file': 'benchmark/configs/tiny_mesh.json'})
    spec['workloads'].append({'name': CELL, 'config': 'tiny_mesh',
                              'traffic': 'tiny_dist', 'chips': 4,
                              'why': 'test'})
    for m in spec['end_to_end'] + spec['per_layer']:
        if 'cone1408_db.dist_object' in m.get('workloads', []):
            m['workloads'].append(CELL)
    (root / 'BENCHMARK.json').write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(scope='module')
def mesh_root(tmp_path_factory):
    return add_mesh(tmp_path_factory.mktemp('mesh_checkout'))


def run(root, fault=None, traced=False, seed=SEED):
    cell = harness.load_cell(CELL, root, root / 'benchmark')
    out, errs = [], []
    code = mesh.main(cell, seed, 0.0, traced, time.time(), backend='gloo',
                     devices=['cpu'] * 4, fault=fault, deadline_s=600,
                     log=out.append, err=errs.append)
    result = json.loads(out[-1]) if code == 0 else None
    return code, result, out, errs


def test_mesh_run_is_correct(mesh_root):
    code, result, out, errs = run(mesh_root)
    assert code == 0, errs
    assert result['correct'] is True, result['check']
    assert result['device']['count'] == 4
    assert result['attempted'] % 3 == 0 and result['failed'] == 0
    assert set(result['metrics']) == {'patterns_per_s.mesh', 'setup_s'}
    # The check's numbers end standard error, the result ends the output.
    assert errs[-1].startswith('check change_gap.after_window')
    assert list(result)[-1] == 'check'


@pytest.mark.parametrize('fault', ['exchange', 'slab', 'half'])
def test_fault_on_the_mesh_is_caught(mesh_root, fault):
    code, result, _, errs = run(mesh_root, fault=fault)
    assert code == 0, errs
    assert result['correct'] is False
    assert any(v['value'] > v['limit'] for v in result['check'].values())


def _fail_target(rank, world, port, t0, send, how):
    mesh_ = mesh._join(rank, world, port, 'gloo', ['cpu'] * world,
                       {'data_axis': 1, 'object_axis': world})
    if rank == 2:
        if how == 'raise':
            raise RuntimeError('a rank fails')
        import os
        import signal
        os.kill(os.getpid(), signal.SIGKILL)
    # The others wait in a collective that rank 2 never joins.
    mesh_.comm.barrier()
    if send is not None:
        send({'result': 'never'})


@pytest.mark.parametrize('how', ['raise', 'kill'])
def test_a_failing_rank_ends_the_run_with_no_result(how):
    got = []
    t = time.monotonic()
    code = mesh.supervise(4, _fail_target, (how,), time.time(),
                          deadline_s=120, on_message=got.append,
                          err=lambda *a: None)
    assert code != 0 and got == []
    assert time.monotonic() - t < 90


def test_row_kept_reference_equals_the_whole():
    """Four bands of rows, each from the object over its cone, give the
    whole reference's losses (each once) and its norms."""
    cfg = json.loads((DATA / 'tiny_mesh.json').read_text())
    traffic = json.loads((DATA / 'tiny_dist.json').read_text())
    inp = inputs.make(cfg, traffic, 123456789, 'cpu')
    batches = mesh.scan_batches(traffic)
    steps = [{'theta': float(inp.theta[i]), 'batches': batches,
              'measured': inp.data[i]} for i in (2, 0, 1)]
    whole = ptycho.follow(cfg, inp.obj, inp.probe, steps, inp.positions)
    iy, _, pads = ptycho.windows(inp.positions, cfg['probe_size'],
                                 cfg['obj_size'][:2])
    wins = [rows.batch_rows(iy, pads[0][0], b) for b in batches]
    losses = torch.zeros(3, len(batches), dtype=torch.float64)
    g_sq = c_sq = 0.0
    counted = np.zeros((3, len(batches)), int)
    ny = cfg['obj_size'][0]
    for k in range(4):
        keep = (ny // 4 * k, ny // 4 * (k + 1))
        cone = rows.cones([wins] * 3, keep, ny)[0]
        out = rows.follow(cfg, inp.obj[cone[0]:cone[1]].clone(), cone,
                          inp.probe, steps, inp.positions, keep)
        for s, d in enumerate(out['losses']):
            for j, v in d.items():
                losses[s, j] += v
                counted[s, j] += 1
        g_sq += out['grad1_sq']
        c_sq += out['change_sq']
    assert (counted == 1).all()
    for s in range(3):
        assert torch.allclose(losses[s], whole['losses'][s].double(),
                              rtol=1e-6, atol=0)
    g = float(whole['grad1']['obj'].double().norm())
    c = float(whole['change']['obj'].double().norm())
    assert abs(g_sq ** 0.5 - g) <= 1e-6 * g
    assert abs(c_sq ** 0.5 - c) <= 1e-6 * c
    # Far below the tiny cell's limits, which a sound run must pass.
    limits = check.load_limits(DATA / f'{CELL}.limits.json')
    assert abs(g_sq ** 0.5 - g) / g < limits['grad_gap'] / 100


def test_one_card_cells_resolve_as_before():
    """Every one-card cell's files, metrics, limits and Reconstructor
    configuration as the harness resolved them before the mesh cells."""
    import dataclasses
    want = json.loads((DATA / 'one_card_cells.json').read_text())
    spec = json.loads((REPO / 'BENCHMARK.json').read_text())
    one = [w['name'] for w in spec['workloads'] if w['chips'] == 1]
    assert sorted(one) == sorted(want)
    for name in one:
        cell = harness.load_cell(name, REPO)
        assert mesh.parallel(cell) is None
        cfg = harness.reconstructor_config(cell, 1234567891234)
        got = {'chips': cell.chips, 'traffic': cell.traffic,
               'config': cell.config, 'limits': cell.limits,
               'end_to_end': [m['name'] for m in cell.end_to_end],
               'per_layer': [m['name'] for m in cell.per_layer],
               'reconstructor_config': json.loads(json.dumps(
                   dataclasses.asdict(cfg), default=str))}
        assert got == want[name], name
