"""Planes whose kernel block fits no shared-memory route: the route
functions say ``'global'`` exactly where neither the FFT route's block nor
the dense route's fits the shared memory the kernel really allocates, and
that route's operands (the dense route's matrices, a device-memory
workspace of the block's planes, no shared memory).  The card's side (the
kernels against their plain versions at 96^2 and 128^2, and
``fused_multislice='auto'`` at 96^2) is in ``tests/test_torch_cuda.py``
and chip_smoke's phase 3."""

import numpy as np
import pytest
import torch

from adorym_tpu_torch.ops import cuda_multislice as cm
from adorym_tpu_torch.ops import cuda_multislice_fused as cmf
from adorym_tpu_torch.ops import propagate as prop

#: (K1, K4, K5 at one mode, K5 at three modes) by plane side: 80 and 84
#: have no radix split (80 = 8 x 10), so K1 and K5 take their dense
#: routes, whose blocks fit to 84 (K1: two planes and two mats) and to 96
#: (K5 at one mode); K4's backward holds three planes and does not fit
#: from 80; 128 = 8 x 16 has no split either.
ROUTES = {64: ('fft', 'fft', 'fft', 'fft'), 72: ('fft', 'fft', 'fft', 'fft'),
          80: ('dense', 'global', 'dense', 'global'),
          84: ('dense', 'global', 'dense', 'global'),
          88: ('global', 'global', 'dense', 'global'),
          96: ('global', 'global', 'dense', 'global'),
          128: ('global', 'global', 'global', 'global')}


@pytest.mark.parametrize('n', list(ROUTES))
def test_routes_by_plane(n):
    got = (cm.k1_route(n, n), cm.k4_route(n, n), cmf.k5_route(n, n),
           cmf.k5_route(n, n, 3))
    assert got == ROUTES[n]
    # 'global' exactly where the dense block passes the limit.
    assert (got[0] == 'global') == (cm.smem_bytes(n, n, 2, 'dense')
                                    > cm.MAX_SMEM_BYTES)
    assert (got[3] == 'global') == (cmf.smem_bytes(3, n, n, 'dense', True)
                                    > cm.MAX_SMEM_BYTES)


@pytest.mark.parametrize('pair', ['K1', 'K4', 'K5'])
def test_global_route_operands(pair):
    """The global route takes no shared memory, the dense route's step
    operands, and a workspace of the block's planes for each block: two
    (K1, K4f) or three (K4b) a (patch, mode) block, M + 1 a K5 block (one
    a patch); the other routes take none."""
    n, m, patches = 96, 3, 5
    rng = np.random.default_rng(0)
    h = torch.tensor(np.exp(1j * rng.random((n, n))).astype(np.complex64))
    if pair == 'K5':
        assert cmf.smem_bytes(m, n, n, 'global', backward=True) == 0
        got, want = cmf.step_mats(h, 'global'), cmf.step_mats(h, 'dense')
        assert got['route'] == 'global'
        for k in ('fy', 'fx', 'h'):
            assert torch.equal(got[k], want[k])
        ws = cmf._workspace('global', m, patches, n, n, 'cpu')
        assert tuple(ws.shape) == (patches * (m + 1), n, n)
        assert cmf._workspace('dense', m, patches, n, n, 'cpu') is None
        return
    planes = 2 if pair == 'K1' else 3
    assert cm.smem_bytes(n, n, planes, 'global') == 0
    fm = prop.final_prop_mats((n, n), (1.0, 1.0, 1.0), 0.25, 'inf')
    got = cm.prop_mats(h, *fm, route='global')
    want = cm.prop_mats(h, *fm, route='dense')
    assert got.pop('route') == 'global' and want.pop('route') == 'dense'
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k])
    ws = cm.workspace('global', planes, m, patches, n, n, 'cpu')
    assert tuple(ws.shape) == (m * patches * planes, n, n)
    assert ws.dtype == torch.complex64
    for route in ('fft', 'dense'):
        assert cm.workspace(route, planes, m, patches, n, n, 'cpu') is None


def test_cpu_auto_runs_the_plain_scan_at_96():
    """On the CPU auto is the plain scan at every shape, and the large
    plane raises nothing."""
    rng = np.random.default_rng(0)
    delta = torch.tensor(rng.random((2, 96, 96, 4)).astype(np.float32) * 1e-3)
    beta = torch.tensor(rng.random((2, 96, 96, 4)).astype(np.float32) * 1e-5)
    wave = torch.ones((1, 2, 96, 96), dtype=torch.complex64)
    kw = dict(energy_ev=5000.0, psize_cm=1e-7)
    a = prop.multislice_propagate(delta, beta, wave, fused='auto', **kw)
    b = prop.multislice_propagate(delta, beta, wave, fused=False, **kw)
    assert torch.equal(a, b)
