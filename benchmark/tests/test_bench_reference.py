"""The plain reference against torch.fft and the port, on the CPU at tiny
sizes."""

import math
import time

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.reference import ptycho

from conftest import TINY, TINY_MIX


def test_dft_matches_torch_fft():
    g = torch.Generator().manual_seed(3)
    x = torch.complex(torch.randn(2, 12, 10, generator=g),
                      torch.randn(2, 12, 10, generator=g))
    tr = ptycho.Transforms(12, 10, 1.0, 0.248, 8.0, 'cpu')
    assert torch.allclose(tr.dft2(x), torch.fft.fft2(x), atol=1e-4)
    assert torch.allclose(tr.dft2(x, inverse=True), torch.fft.ifft2(x),
                          atol=1e-6)
    # The control's TF32 rounding is visibly less precise.
    t32 = ptycho.Transforms(12, 10, 1.0, 0.248, 8.0, 'cpu', 'tf32')
    err = (t32.dft2(x) - torch.fft.fft2(x)).abs().max()
    assert err > 1e-3


def test_bins_and_rotation():
    v = torch.arange(2 * 3 * 5 * 2, dtype=torch.float32).reshape(2, 3, 5, 2)
    b = ptycho.bin_z(v, 2)
    assert b.shape == (2, 3, 3, 2)
    assert torch.equal(b[:, :, 0], v[:, :, 0] + v[:, :, 1])
    assert torch.equal(b[:, :, 2], v[:, :, 4])
    assert torch.equal(ptycho.expand_z(b, 2, 5)[:, :, 3], b[:, :, 1])
    assert torch.equal(ptycho.rotate_y(v, 0.0), v)
    # a quarter turn moves x into z and back
    cube = torch.randn(3, 5, 5, 2)
    q = ptycho.rotate_y(ptycho.rotate_y(cube, math.pi / 2), -math.pi / 2)
    assert torch.allclose(q, cube, atol=1e-5)


def test_rotation_matches_the_port():
    from adorym_tpu_torch.ops import rotate as port_rotate
    v = torch.randn(4, 16, 12, 2)
    for th in np.linspace(0, 2 * np.pi, 7, endpoint=False).astype(np.float32):
        assert torch.equal(ptycho.rotate_y(v, float(th)),
                           port_rotate.rotate(v, float(th)))


@pytest.mark.parametrize('config', TINY)
def test_reference_follows_the_port(bench_root, config):
    """The port's first three steps at a tiny size against the reference:
    every comparison number well inside the tiny cell's limits."""
    cell = harness.load_cell(f'{config}.{TINY_MIX}', bench_root,
                             bench_root / 'benchmark')
    su = harness.set_up(cell, 2 ** 31 + 11, 'cpu',
                        harness.Spans(time.perf_counter()), n_warm=3)
    assert len(su.steps) == 3
    assert len({s['i_theta'] for s in su.steps}) == 3     # three angles
    su.rec = None
    values = harness.reference_numbers(cell, su, 'cpu')
    ok, judged = check.judge(values, cell.limits)
    assert ok, judged
    assert values['loss_gap'] < 1e-6
