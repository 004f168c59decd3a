"""The multislice work count against hand-computed values."""

import math

import pytest

from benchmark.work import multislice as w

PEAKS = {'f32_flops_per_s': 67e12, 'bytes_per_s': 3.35e12}


def test_fft_count():
    assert w.fft2_ops(2, 2) == 5 * 4 * 2
    assert w.fft2_ops(72, 72) == pytest.approx(5 * 5184 * math.log2(5184))


def test_tiny_sweep_by_hand():
    # 2 steps, 1 mode, 2x2 planes: n = 4, one 2-D FFT = 5*4*2 = 40 ops.
    fft, prod = 40.0, 6 * 4
    fwd = 1 * (2 * fft + prod) + fft + 2 * prod
    adj = 1 * (2 * fft + prod) + fft + 2 * 2 * prod
    assert w.ops_per_pattern(2, 1, 2, 2) == fwd + adj == 432
    assert w.ops_per_pattern(2, 3, 2, 2) == 3 * 432


def test_angle_work_and_bound():
    cfg = {'obj_size': [4, 4, 4], 'binning': 2, 'probe_size': [2, 2],
           'n_probe_modes': 1}
    traffic = {'grid': [2, 3], 'stride_px': 1}
    a = w.angle_work(cfg, traffic)
    assert a['patterns'] == 6
    assert a['ops'] == 6 * 432
    # footprint 3 x 4, 2 binned slices, 2 channels; object in and its
    # gradient out, one 2x2 complex probe, six 2x2 magnitudes.
    assert a['bytes'] == 2 * 3 * 4 * 2 * 2 * 4 + 2 * 2 * 2 * 4 + 6 * 4 * 4
    t, what = w.bound_seconds(a, PEAKS)
    assert what == 'bytes' and t == a['bytes'] / 3.35e12


def test_flagship_numbers():
    cfg = {'obj_size': [256, 256, 256], 'binning': 8, 'probe_size': [72, 72],
           'n_probe_modes': 1}
    a = w.angle_work(cfg, {'grid': [23, 23], 'stride_px': 8})
    assert a['ops'] / 1e9 == pytest.approx(23.919, abs=1e-3)
    t, what = w.bound_seconds(a, PEAKS)
    assert what == 'operations' and t * 1e3 == pytest.approx(0.357, abs=1e-3)
