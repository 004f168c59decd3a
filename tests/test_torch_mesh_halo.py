"""The port's mesh layer (``adorym_tpu_torch/parallel``) on gloo ranks on
the CPU: the collectives and their records, the process bootstrap across
real processes, the mesh and its layout helpers, the halo gather and its
transpose against the dense gather, the ring extension, and the
regularizers on y slabs against the whole object — the counterparts of
``tests/test_halo.py``'s unit tests and ``tests/test_bootstrap.py``, and
of the JAX package's mesh layout (``adorym_tpu/parallel/mesh.py``).  The
gather is exact; its VJP and the regularizers' values and gradients at
1e-5 of the largest value (f32 sums in another order)."""

import numpy as np
import pytest
import torch

import test_torch_mesh_ranks as C
from test_torch_mesh_setup import _one_torch_thread, pool_fixture  # noqa: F401

pool = pool_fixture(4)


def test_comm_collectives(pool):
    """Sums over each axis and both, the max, the ring shift both ways and
    the all-gather over 'op' on a (2, 2) mesh (rank r holds r + 1), each
    recorded by kind, axis and bytes."""
    out = pool.run(C.comm_basics)
    for r, o in enumerate(out):
        dp, op = o['coord']
        assert (dp, op) == divmod(r, 2)
        assert o['sum_dp'] == (op + 1) + (op + 3)
        assert o['sum_op'] == (2 * dp + 1) + (2 * dp + 2)
        assert o['sum_all'] == 10 and o['max_all'] == 4
        assert o['shift_fwd'] == 2 * dp + ((op - 1) % 2) + 1
        assert o['shift_bwd'] == 2 * dp + ((op + 1) % 2) + 1
        assert o['gather'] == [2 * dp + 1, 2 * dp + 2]
        assert [k[:2] for k in o['kinds']] == [
            ('all_reduce', 'dp'), ('all_reduce', 'op'),
            ('all_reduce', 'dp+op'), ('all_reduce', 'dp+op'),
            ('ring_shift', 'op'), ('ring_shift', 'op'), ('all_gather', 'op')]
        assert o['kinds'][0][2] == 4


def test_bootstrap_two_processes():
    """Two real processes joined by ``initialize_distributed``: a sum that
    is right only if it crossed the process boundary; joining again is a
    no-op, and a world size that differs from the group's raises."""
    from adorym_tpu_torch.parallel.launch import RankPool
    with RankPool(2, 'cpu', timeout_s=120) as p:
        out = p.run(C.bootstrap_case)
        again = p.run(C.bootstrap_reinit_case)
    assert [o['rank'] for o in out] == [0, 1]
    assert all(o['world'] == 2 and o['backend'] == 'gloo' for o in out)
    assert all(o['sum'] == 3.0 for o in out)
    assert out[0]['pid'] != out[1]['pid']
    for o in again:
        assert o['device'] == 'cpu'
        assert 'not 3' in o['raised']


def test_shutdown_leaves_no_process():
    """A program that closes its pools and calls ``launch.shutdown()``
    leaves no process of its session running when it exits (the fork
    server would outlive it otherwise)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = ('import os\n'
            'from adorym_tpu_torch.parallel import launch\n'
            "with launch.RankPool(2, 'cpu', timeout_s=120) as p:\n"
            '    pids = p.run(os.getpid)\n'
            'launch.shutdown()\n'
            'assert len(set(pids)) == 2 and os.getpid() not in pids\n')
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS='1')
    proc = subprocess.Popen([sys.executable, '-c', code], cwd=root, env=env,
                            start_new_session=True)
    assert proc.wait(timeout=300) == 0
    left = []
    for d in os.listdir('/proc'):
        try:
            if d.isdigit() and os.getsid(int(d)) == proc.pid:
                left.append(d)
        except OSError:
            continue
    assert not left


def test_auto_mesh(pool):
    """``auto_mesh(object_axis)`` lays every rank of the group out: the
    rest of the world on 'dp', ranks in dp-major order."""
    for r, o in enumerate(pool.run(C.auto_mesh_case, 2)):
        assert o['axes'] == (2, 2) and o['coord'] == divmod(r, 2)
    for r, o in enumerate(pool.run(C.auto_mesh_case, 4)):
        assert o['axes'] == (1, 4) and o['coord'] == (0, r)


def test_make_mesh_needs_a_matching_world(pool):
    """A mesh whose ``data_axis * object_axis`` is not the world raises."""
    for dp, op in ((2, 1), (4, 2)):
        msg = pool.run(C.mesh_mismatch_case, dp, op)[0]
        assert msg and 'ranks' in msg


def test_make_mesh_without_a_process_group_raises():
    """No process group, no mesh (no silent one-device run)."""
    import torch.distributed as dist
    from adorym_tpu_torch.config import ParallelConfig
    from adorym_tpu_torch.parallel.mesh import make_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match='process group'):
        make_mesh(ParallelConfig(data_axis=2, object_axis=2), device='cpu')


def test_backend_rules():
    """nccl needs a card a rank: two ranks on one card, or the CPU, raise;
    the default is nccl only where every rank has its own card."""
    from adorym_tpu_torch.parallel.comm import (check_backend,
                                                default_backend)
    cuda, cpu = torch.device('cuda', 0), torch.device('cpu')
    with pytest.raises(ValueError, match='one card a rank'):
        check_backend('nccl', cuda, 2)
    with pytest.raises(ValueError, match='CUDA'):
        check_backend('nccl', cpu, 1)
    check_backend('gloo', cuda, 4)
    check_backend('nccl', cuda, 1)
    assert default_backend(cuda, 1) == 'nccl'
    assert default_backend(cuda, 2) == 'gloo'
    assert default_backend(cpu, 1) == 'gloo'


def test_memory_budget_per_rank(monkeypatch):
    """Ranks that share a card budget their share of it (every budget
    reads ``hbm_limit_bytes``); the CPU's figure is per rank as it is."""
    from types import SimpleNamespace
    from adorym_tpu_torch.utils import profiling as prof
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda d: SimpleNamespace(total_memory=80e9))
    n = prof.ranks_per_device()
    try:
        prof.set_ranks_per_device(4)
        assert prof.hbm_limit_bytes('cuda:0') == 20e9
        assert prof.hbm_limit_bytes('cpu') == prof.DEFAULT_DEVICE_BYTES
    finally:
        prof.set_ranks_per_device(n)
    assert prof.hbm_limit_bytes('cuda:0') == 80e9 / n


def test_layout_helpers_and_convert(pool):
    """The object's y slab on each 'op' rank, every other leaf whole; the
    batch's dp share where ``data_axis`` divides it; the JAX package's
    whole parameters and moments slabbed by ``convert.params_from_jax``."""
    rng = np.random.default_rng(0)
    obj = rng.random((8, 4, 3, 2)).astype(np.float32)
    probe = rng.random((1, 4, 4, 2)).astype(np.float32)
    batch = {'i_theta': 0, 'pos_batch': np.zeros((6, 2)),
             'ind_batch': np.arange(6)}
    meas = np.arange(6.0)
    out = pool.run(C.shard_helpers_case, {'obj': obj, 'probe': probe},
                   batch, meas)
    for o in out:
        dp, op = o['coord']
        assert o['specs'] == {'obj': ('op',), 'probe': ()}
        np.testing.assert_array_equal(o['obj'], obj[op * 4:(op + 1) * 4])
        np.testing.assert_array_equal(o['probe'], probe)
        np.testing.assert_array_equal(o['ind'], np.arange(3) + 3 * dp)
        np.testing.assert_array_equal(o['measured'], meas[3 * dp:3 * dp + 3])
        np.testing.assert_array_equal(o['conv_obj'], obj[op * 4:op * 4 + 4])
        np.testing.assert_array_equal(o['conv_m'], obj[op * 4:op * 4 + 4])
        assert o['split']


class TestHaloGather:
    def test_matches_dense_gather(self, pool):
        """Windows that straddle slabs come out exactly; one ring shift
        and one sum over 'op' a call."""
        for o in pool.run(C.halo_gather_case, 0):
            assert o['fwd_err'] == 0.0
            assert o['comm_fwd']['ring_shift@op']['count'] == 1
            assert o['comm_fwd']['all_reduce@op']['count'] == 1
            assert set(o['comm_fwd']) == {'ring_shift@op', 'all_reduce@op'}

    def test_vjp_is_scatter_add(self, pool):
        """The written-out backward equals autograd through the dense
        gather; it sends the halo rows' cotangent back by one ring shift
        and sums nothing."""
        for o in pool.run(C.halo_gather_case, 1):
            assert o['vjp_err'] <= 1e-6
            assert set(o['comm_bwd']) == {'ring_shift@op'}

    def test_explicit_scatter_add(self, pool):
        """``sharded_patch_scatter_add`` is the dense scatter-add's slab."""
        for o in pool.run(C.halo_gather_case, 2):
            assert o['scatter_err'] <= 1e-6

    def test_rejects_probe_taller_than_shard(self, pool):
        """A window taller than a slab is refused, as in the JAX
        package."""
        for o in pool.run(C.halo_gather_case, 0, (16, 8)):
            assert 'taller' in o['assert']


@pytest.mark.parametrize('h1,h2', [(1, 2), (2, 0), (0, 3), (6, 6)])
def test_neighbor_extend(pool, h1, h2):
    """The previous slab's last rows and the next one's first, on the
    ring; the backward adds each row's cotangent at its source row."""
    for o in pool.run(C.neighbor_extend_case, 3, h1, h2):
        assert o['fwd'] == 0.0 and o['bwd'] <= 1e-6


@pytest.mark.parametrize('unknown_type', ['delta_beta', 'real_imag'])
def test_regularizers_on_slabs(pool, unknown_type):
    """L1, reweighted L1, TV, the inter-slice correlation and the
    gradient correlation on 'op' slabs: the whole object's value on every
    rank and its gradient's slab (the correlations at 1e-4: their product
    over the slices of centred values cancels, and the slabs' sums add in
    another order)."""
    for o in pool.run(C.reg_case, None, 4, unknown_type):
        for name, (v, vs, gerr, gscale) in o.items():
            tol = 1e-4 if name in ('corr', 'gcorr') else 1e-5
            assert abs(vs - v) <= tol * abs(v), (name, v, vs)
            assert gerr <= tol * gscale, (name, gerr, gscale)
