"""A run whose timed path is broken underneath comes out not correct: each
planted fault, and the control (the reference with its DFTs' operands
rounded to TF32, in the program's place).  The harness's look for a card is
skipped; the rest of a run is driven on the CPU at a tiny size."""

import time

import pytest

from benchmark import calibrate, check, faults, harness

from conftest import TINY, TINY_MIX


def run(cell):
    return harness.run_cell(cell, 987654321, 0.0, False, 'cpu',
                            time.perf_counter(), log=lambda *a: None,
                            err=lambda *a: None)


@pytest.mark.parametrize('config', TINY)
def test_sound_run_is_correct(bench_root, config):
    cell = harness.load_cell(f'{config}.{TINY_MIX}', bench_root,
                             bench_root / 'benchmark')
    assert run(cell)['correct'] is True


@pytest.mark.parametrize('kind', faults.KINDS)
@pytest.mark.parametrize('config', TINY)
def test_fault_is_caught(bench_root, config, kind):
    cell = harness.load_cell(f'{config}.{TINY_MIX}', bench_root,
                             bench_root / 'benchmark')
    with faults.planted(kind):
        result = run(cell)
    assert result['correct'] is False
    assert any(v['value'] > v['limit'] for v in result['check'].values())


@pytest.mark.parametrize('config', TINY)
def test_control_fails(bench_root, config):
    cell = harness.load_cell(f'{config}.{TINY_MIX}', bench_root,
                             bench_root / 'benchmark')
    values = calibrate.readings(cell, 55, 'control', 'cpu')
    ok, _ = check.judge(values, cell.limits)
    assert not ok


@pytest.mark.parametrize('config', TINY)
def test_state_left_by_the_window_is_checked(bench_root, config):
    """A cache that goes stale only once the window has run passes set-up's
    checked steps and fails the same check taken after the window."""
    cell = harness.load_cell(f'{config}.{TINY_MIX}', bench_root,
                             bench_root / 'benchmark')
    with faults.planted('stale'):
        result = run(cell)
    judged = result['check']
    assert all(v['value'] <= v['limit'] for n, v in judged.items()
               if '.' not in n)
    assert any(v['value'] > v['limit'] for n, v in judged.items()
               if n.endswith('.after_window'))
    assert result['correct'] is False
