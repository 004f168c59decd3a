"""Rank bodies for the mesh tests (``tests/test_torch_mesh_*.py``).

The tests start a world of gloo ranks on the CPU
(:class:`adorym_tpu_torch.parallel.launch.RankPool`) and send it these
functions.  The ranks import this module afresh, without
``tests/conftest.py``, so it imports neither JAX nor the JAX package:
each function builds the port's mesh run and returns what the test holds
against the JAX package's mesh run and the port's one-device run.
"""

from __future__ import annotations


import numpy as np
import torch

import adorym_tpu_torch as pt
from adorym_tpu_torch import recon_mesh as mc_lib
from adorym_tpu_torch.parallel.mesh import make_mesh


def _mesh(cfg):
    return make_mesh(cfg.parallel, device='cpu')


def _comm_out(mesh):
    return {'records': [dict(r) for r in mesh.comm.records],
            'summary': mesh.comm.summary()}


def recon_run(cfg, kw, n_epochs, run_epochs=False, callback=False,
              step_comm=False, probe=False, keys=()):
    """``n_epochs`` epochs of a mesh run; rank 0 returns the losses, the
    whole object and the layout, every rank its comm summary.
    ``step_comm``: the records of the first epoch alone."""
    mesh = _mesh(cfg)
    rec = pt.Reconstructor(cfg, mesh=mesh, device='cpu', **kw)
    out = {'mc': rec._mc is not None, 'mci': rec._mci is not None,
           'reasons': list(rec._mc_decline_reasons),
           'halo': rec._gather_fn is not None,
           'off_state': rec._off_state, 'obj_off_mesh': rec._obj_off_mesh,
           'rank': mesh.rank}
    for k in ('mp', 'mb_pad', 'mpp', 'n_last', 'n_rows', 'p0', 'px0', 'h1',
              'h2', 'p1'):
        lay = rec._mc or rec._mci
        if lay is not None and k in lay:
            out['lay_' + k] = lay[k]
    if rec._mc is not None:
        out['ws_sum'] = float(rec._mc['ws_mc'].sum())
    if rec._mci is not None:
        out['ws_sum'] = float(rec._mci['ws_imm'].sum())
        out['ws_last'] = rec._mci['ws_imm'][-1].reshape(-1).copy()
    mesh.comm.reset()
    cb = []
    if run_epochs:
        out['losses'] = rec.run_epochs(n_epochs, start_epoch=0)
    else:
        losses = []
        for ep in range(n_epochs):
            losses.append(rec.run_epoch(
                ep, callback=(lambda e, b, l: cb.append((e, b, l)))
                if callback else None))
            if step_comm and ep == 0:
                out['comm_epoch0'] = _comm_out(mesh)
        out['losses'] = losses
    out['batch_losses'] = cb
    out['comm'] = _comm_out(mesh)
    res = rec.results()
    if probe:
        out['probe'] = res['probe']
    for k in keys:
        out[k] = res[k]
    out['obj'] = res['obj']
    if rec.finite_support_mask is not None:
        out['mask'] = rec._gather_rows(rec.finite_support_mask).numpy()
    out['slab_shape'] = tuple(rec.params['obj'].shape)
    out['state_shapes'] = {n: tuple(a.shape) for n, a in
                           rec.opt_state.get('obj', {}).items()
                           if torch.is_tensor(a)}
    out['state_devices'] = sorted({str(a.device) for a in
                                   rec.opt_state.get('obj', {}).values()
                                   if torch.is_tensor(a)})
    if mesh.rank != 0:
        for k in ('obj', 'probe', 'mask'):
            out.pop(k, None)
    return out


def recon_build(cfg, kw, expect=None):
    """Build a mesh Reconstructor: its layout and decline reasons, or the
    ``expect``ed exception's message."""
    mesh = _mesh(cfg)
    try:
        import warnings
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            rec = pt.Reconstructor(cfg, mesh=mesh, device='cpu', **kw)
    except Exception as e:                               # noqa: BLE001
        if expect is not None and isinstance(e, expect):
            return {'raised': type(e).__name__, 'msg': str(e)}
        raise
    return {'mc': rec._mc is not None, 'mci': rec._mci is not None,
            'reasons': list(rec._mc_decline_reasons),
            'halo': rec._gather_fn is not None,
            'warnings': [str(x.message) for x in w],
            'obj_off_mesh': rec._obj_off_mesh, 'off_state': rec._off_state,
            'off_slabbed': rec._off_slabbed}


def grad_step(cfg, kw, i_theta, inds):
    """The generic path's loss and gradients of one batch, from the
    initial parameters (the whole object's gradient gathered)."""
    mesh = _mesh(cfg)
    rec = pt.Reconstructor(cfg, mesh=mesh, device='cpu', **kw)
    measured = torch.as_tensor(rec.data[i_theta][inds])
    mesh.comm.reset()
    loss, grads = rec._grad_step(i_theta, np.asarray(inds), measured)
    out = {'loss': float(loss), 'comm': _comm_out(mesh),
           'halo': rec._gather_fn is not None}
    mesh.comm.reset()
    g = rec._gather_rows(grads['obj'])
    out['g_obj'] = g.numpy()
    out.update({k: v.numpy() for k, v in grads.items() if k != 'obj'})
    return out


def halo_gather_case(seed, probe=(8, 8), n_dp=2, n_op=2):
    """``sharded_patch_gather`` and its VJP against the dense gather's,
    the explicit scatter-add, and the collectives a call makes."""
    from adorym_tpu_torch.config import ParallelConfig
    from adorym_tpu_torch.ops.patches import (extract_patches,
                                              scatter_patches_add)
    from adorym_tpu_torch.parallel import halo
    mesh = make_mesh(ParallelConfig(data_axis=n_dp, object_axis=n_op),
                     device='cpu')
    rng = np.random.default_rng(seed)
    Y, X, Z = 8 * n_op, 24, 3
    obj = rng.random((Y, X, Z, 2)).astype(np.float32)
    pos = np.asarray([[0, 0], [5, 3], [8, 8], [7, 16], [Y - 8, 0],
                      [Y - 9, 11]])
    st, sz = mesh.slab(Y)
    out = {}
    try:
        sl = torch.tensor(obj[st:st + sz], requires_grad=True)
        mesh.comm.reset()
        got = halo.sharded_patch_gather(sl, pos, probe, mesh)
        out['comm_fwd'] = mesh.comm.summary()
        ref = extract_patches(torch.tensor(obj), pos, probe)
        out['fwd_err'] = float((got - ref).abs().max())
        mesh.comm.reset()
        torch.sum(torch.sin(got)).backward()
        out['comm_bwd'] = mesh.comm.summary()
        o = torch.tensor(obj, requires_grad=True)
        torch.sum(torch.sin(extract_patches(o, pos, probe))).backward()
        out['vjp_err'] = float((sl.grad - o.grad[st:st + sz]).abs().max())
        patches = torch.ones((len(pos),) + tuple(probe) + (Z, 2))
        sc = halo.sharded_patch_scatter_add(torch.tensor(obj[st:st + sz]),
                                            patches, pos, mesh)
        ref_sc = scatter_patches_add(torch.tensor(obj), patches, pos)
        out['scatter_err'] = float((sc - ref_sc[st:st + sz]).abs().max())
    except AssertionError as e:
        out['assert'] = str(e)
    return out


def neighbor_extend_case(seed, h1, h2):
    """``neighbor_extend`` forward and VJP against the circular rows."""
    from adorym_tpu_torch.config import ParallelConfig
    from adorym_tpu_torch.parallel import halo
    mesh = make_mesh(ParallelConfig(data_axis=1,
                                    object_axis=torch.distributed
                                    .get_world_size()), device='cpu')
    rng = np.random.default_rng(seed)
    n = mesh.n_op
    Y = 6 * n
    obj = rng.random((Y, 5, 2)).astype(np.float32)
    st, sz = mesh.slab(Y)
    sl = torch.tensor(obj[st:st + sz], requires_grad=True)
    ext = halo.neighbor_extend(sl, h1, h2, mesh)
    rows = np.arange(st - h1, st + sz + h2) % Y
    fwd = float(np.abs(ext.detach().numpy() - obj[rows]).max())
    w = torch.as_tensor(rng.random(ext.shape).astype(np.float32))
    (ext * w).sum().backward()
    # The dense transpose: every row's weights added at its source row.
    g = np.zeros_like(obj)
    allw = torch.distributed  # the weights of every rank
    ws = [torch.empty_like(w) for _ in range(n)]
    allw.all_gather(ws, w)
    for k in range(n):
        r = np.arange(k * sz - h1, (k + 1) * sz + h2) % Y
        np.add.at(g, r, ws[k].numpy())
    bwd = float(np.abs(sl.grad.numpy() - g[st:st + sz]).max())
    return {'fwd': fwd, 'bwd': bwd}


def reg_case(cfg_loss_kw, seed, unknown_type='delta_beta', n_op=None):
    """Every regularizer's value and gradient on the slabs against the
    whole object's."""
    from adorym_tpu_torch.config import ParallelConfig
    from adorym_tpu_torch.models import regularizers as regs
    from adorym_tpu_torch.parallel import halo
    n = n_op or torch.distributed.get_world_size()
    mesh = make_mesh(ParallelConfig(data_axis=1, object_axis=n),
                     device='cpu')
    rng = np.random.default_rng(seed)
    Y = 4 * n
    obj = (rng.random((Y, 6, 5, 2)) * 1e-2).astype(np.float32)
    if unknown_type == 'real_imag':
        obj[..., 0] += 1.0
    w_l1 = rng.random(obj.shape).astype(np.float32) + 0.5
    st, sz = mesh.slab(Y)
    out = {}
    shard = halo.SlabShard(mesh)
    for name, reg in (
            ('l1', regs.L1Regularizer(unknown_type, 1.3, 0.7)),
            ('rwl1', regs.ReweightedL1Regularizer(unknown_type, 1.1, 0.4)),
            ('tv', regs.TVRegularizer(unknown_type, 0.9)),
            ('corr', regs.CorrRegularizer(unknown_type, 0.5)),
            ('gcorr', regs.GradCorrRegularizer(unknown_type, 0.5))):
        o = torch.tensor(obj, requires_grad=True)
        v = reg(o, weight_l1=torch.as_tensor(w_l1))
        v.backward()
        s = torch.tensor(obj[st:st + sz], requires_grad=True)
        vs = reg(s, weight_l1=torch.as_tensor(w_l1[st:st + sz]),
                 shard=shard)
        vs.backward()
        out[name] = (float(v), float(vs),
                     float(np.abs(o.grad.numpy()[st:st + sz]
                                  - s.grad.numpy()).max()),
                     float(np.abs(o.grad.numpy()).max()))
    return out


def comm_basics():
    """The comm's collectives on a world: sums over each axis, the ring
    shift both ways, the all-gather, and the records."""
    from adorym_tpu_torch.config import ParallelConfig
    n = torch.distributed.get_world_size()
    mesh = make_mesh(ParallelConfig(data_axis=2, object_axis=n // 2),
                     device='cpu')
    c = mesh.comm
    r = float(mesh.rank + 1)
    out = {'coord': (c.dp, c.op)}
    out['sum_dp'] = float(c.all_reduce(torch.tensor([r]), 'dp'))
    out['sum_op'] = float(c.all_reduce(torch.tensor([r]), 'op'))
    out['sum_all'] = float(c.all_reduce(torch.tensor([r]), ('dp', 'op')))
    out['max_all'] = float(c.all_reduce(torch.tensor([r]), ('dp', 'op'),
                                        op='max'))
    out['shift_fwd'] = float(c.ring_shift(torch.tensor([r]), 'op', +1))
    out['shift_bwd'] = float(c.ring_shift(torch.tensor([r]), 'op', -1))
    out['gather'] = c.all_gather(torch.tensor([r]), 'op').tolist()
    out['kinds'] = [(x['kind'], x['axis'], x['bytes']) for x in c.records]
    return out


def bootstrap_case():
    """The process group the pool joined: its size, this rank, the
    backend, and a sum that is right only if it crossed the process
    boundary (rank r contributes r + 1)."""
    import os
    import torch.distributed as dist
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    return {'world': dist.get_world_size(), 'rank': dist.get_rank(),
            'backend': dist.get_backend(), 'sum': float(t),
            'pid': os.getpid()}


def api_run(params):
    """``reconstruct_ptychography`` on a mesh rank (``parallel_*_axis``
    in ``params``)."""
    out = pt.reconstruct_ptychography(**params)
    return {k: out[k] for k in ('obj', 'loss_history')}



def imm_single_steps(cfg, kw, batches):
    """One immediate update from the initial parameters for each of
    ``batches`` (``(i_theta, inds)``): the mesh step's loss and whole
    object after it, from a fresh run each time."""
    out = []
    for i_theta, inds in batches:
        mesh = _mesh(cfg)
        rec = pt.Reconstructor(cfg, mesh=mesh, device='cpu', **kw)
        batch = [(i_theta, np.asarray(inds))]
        assert mc_lib.mc_imm_ok(rec, batch)
        loss = rec.epoch_fused(batch)
        out.append((float(loss[0]), rec.obj))
    return out


def multidist_grad_case(cfg, kw, inds):
    """The multi-distance model's loss and gradient of one batch on the
    mesh (the halo gather reads the tiles)."""
    from adorym_tpu_torch.models import multidist
    mesh = _mesh(cfg)
    rec = pt.Reconstructor(cfg, mesh=mesh, device='cpu', model=multidist,
                           **kw)
    rows = multidist.expand_indices(np.asarray(inds), rec.n_pos, cfg)
    measured = torch.as_tensor(rec.data[0][rows])
    mesh.comm.reset()
    loss, grads = rec._grad_step(0, np.asarray(inds), measured)
    comm = _comm_out(mesh)
    return {'loss': float(loss), 'g_obj': rec._gather_rows(
        grads['obj']).numpy(), 'halo': rec._gather_fn is not None,
        'comm': comm}


def offload_auto_case(cfg, kw, boundary_frac=None):
    """Whether ``offload_object='auto'`` keeps this rank's slab on the
    host; ``boundary_frac``: the auto boundary set to that fraction of
    the rank's share of the object."""
    from adorym_tpu_torch.utils import profiling as prof
    if boundary_frac is not None:
        share = (np.prod(cfg.geometry.obj_size) * 2 * 4
                 / cfg.parallel.object_axis)
        old = prof.obj_offload_auto_bytes
        prof.obj_offload_auto_bytes = lambda hbm=None: share * boundary_frac
    try:
        return recon_build(cfg, kw)
    finally:
        if boundary_frac is not None:
            prof.obj_offload_auto_bytes = old


def run_with_checkpoint(cfg, kw, folder, n_epochs):
    """``Reconstructor.run`` on the mesh with an output folder (rank 0
    writes the tree and the checkpoints); rank 0 returns the losses."""
    mesh = _mesh(cfg)
    rec = pt.Reconstructor(cfg, mesh=mesh, device='cpu',
                           output_folder=folder, **kw)
    res = rec.run(n_epochs=n_epochs)
    return {'losses': list(res['loss_history']), 'obj': res['obj']}


def matrix_case(cfg, kw, n_epochs):
    """A configuration matrix case on the mesh: per-epoch losses."""
    mesh = _mesh(cfg)
    rec = pt.Reconstructor(cfg, mesh=mesh, device='cpu', **kw)
    return {'losses': [float(rec.run_epoch(ep)) for ep in range(n_epochs)],
            'mc': rec._mc is not None, 'mci': rec._mci is not None,
            'off_state': rec._off_state}


def bootstrap_reinit_case():
    """``initialize_distributed`` inside a joined process group: no-op
    with the group's world size, raises with another."""
    from adorym_tpu_torch.parallel.bootstrap import initialize_distributed
    w = torch.distributed.get_world_size()
    dev = initialize_distributed(world_size=w, device='cpu')
    try:
        initialize_distributed(world_size=w + 1, device='cpu')
        raised = None
    except ValueError as e:
        raised = str(e)
    return {'device': str(dev), 'raised': raised}


def mesh_mismatch_case(dp, op):
    """``make_mesh`` for a mesh the world does not match: the error."""
    from adorym_tpu_torch.config import ParallelConfig
    try:
        make_mesh(ParallelConfig(data_axis=dp, object_axis=op),
                  device='cpu')
    except ValueError as e:
        return str(e)
    return None


def shard_helpers_case(params, batch, measured):
    """``param_specs``, ``shard_params``, ``batch_specs`` and
    ``shard_batch`` on this rank, and ``convert.params_from_jax`` with a
    mesh (the JAX package's whole arrays to this rank's slab)."""
    from adorym_tpu_torch import convert
    from adorym_tpu_torch.config import ParallelConfig
    from adorym_tpu_torch.parallel import mesh as mesh_lib
    pcfg = ParallelConfig(data_axis=2, object_axis=2)
    mesh = make_mesh(pcfg, device='cpu')
    sp = mesh_lib.shard_params(params, mesh)
    b, m = mesh_lib.shard_batch(batch, measured, mesh)
    conv, st = convert.params_from_jax(
        params, {'obj': {'m': params['obj'], 'v': params['obj']}},
        device='cpu', mesh=mesh)
    return {'coord': (mesh.dp, mesh.op),
            'specs': mesh_lib.param_specs(params, pcfg),
            'obj': sp['obj'], 'probe': sp['probe'], 'ind': b['ind_batch'],
            'measured': m, 'conv_obj': conv['obj'].numpy(),
            'conv_m': st['obj']['m'].numpy(),
            'split': mesh_lib.batch_specs(pcfg, len(batch['ind_batch']))}


def auto_mesh_case(object_axis):
    """``bootstrap.auto_mesh`` over the process group: the config and this
    rank's coordinates."""
    from adorym_tpu_torch.parallel.bootstrap import auto_mesh
    mesh, pcfg = auto_mesh(object_axis, device='cpu')
    return {'axes': (pcfg.data_axis, pcfg.object_axis),
            'coord': (mesh.dp, mesh.op)}


def sharded_write_case(cfg, kw, folder, n_epochs):
    """``n_epochs`` epochs of a mesh run with an output folder, then one
    ``save_checkpoint(n_epochs, 0)``: the losses (rank 0), and every
    rank's collectives during the write alone and its slab's rows."""
    mesh = _mesh(cfg)
    rec = pt.Reconstructor(cfg, mesh=mesh, device='cpu',
                           output_folder=folder, **kw)
    losses = [rec.run_epoch(ep) for ep in range(n_epochs)]
    mesh.comm.reset()
    rec.save_checkpoint(n_epochs, 0)
    st, sz = mesh.slab(cfg.geometry.obj_size[0])
    return {'rank': mesh.rank, 'coord': (mesh.dp, mesh.op),
            'losses': losses, 'comm': _comm_out(mesh),
            'rows': (st, st + sz), 'mc': rec._mc is not None}


def resume_case(cfg, kw, folder, n_epochs):
    """A mesh run that resumes from ``folder``'s checkpoint and runs
    ``n_epochs`` epochs: its start, its losses and the whole object (rank
    0); and what ``convert.load_checkpoint`` and
    ``checkpoint.restore_sharded`` return for this rank's rows."""
    from adorym_tpu_torch import convert
    from adorym_tpu_torch.io import checkpoint as ckpt_lib
    mesh = _mesh(cfg)
    st, sz = mesh.slab(cfg.geometry.obj_size[0])
    ckpt = f'{folder}/checkpoint'
    ck = convert.load_checkpoint(ckpt, device='cpu', host_obj=True,
                                 host_obj_state=True, rows=(st, st + sz))
    sharded = ckpt_lib.restore_sharded(ckpt, rows=(st, st + sz))
    rec = pt.Reconstructor(cfg, mesh=mesh, device='cpu',
                           output_folder=folder, **kw)
    start = rec._start_epoch
    losses = [rec.run_epoch(ep) for ep in range(start, start + n_epochs)]
    out = {'rank': mesh.rank, 'coord': (mesh.dp, mesh.op), 'start': start,
           'losses': losses, 'rows': (st, st + sz),
           'loaded_obj': tuple(ck['params']['obj'].shape),
           'loaded_state': {n: tuple(a.shape) for n, a in
                            ck['opt_state'].get('obj', {}).items()},
           'read_slabs': (None if sharded is None
                          else sorted(sharded[0]['obj'])),
           'obj': rec.results()['obj']}
    if mesh.rank != 0:
        out.pop('obj')
    return out


def failed_step_case(cfg, kw, folder, step):
    """A sharded ``save_checkpoint`` in which rank 0's ``step`` of the
    commit (``_prepare`` or ``_commit``, which only rank 0 runs) raises:
    each rank's error, whether a ``dcp/`` was committed, and the epoch a
    second, working save then commits."""
    from adorym_tpu_torch.io import checkpoint as ckpt_lib
    mesh = _mesh(cfg)
    rec = pt.Reconstructor(cfg, mesh=mesh, device='cpu',
                           output_folder=folder, **kw)
    real = getattr(ckpt_lib, step)

    def fail(*args):
        raise OSError(f'{step} failed')
    setattr(ckpt_lib, step, fail)
    try:
        rec.save_checkpoint(1, 0)
        err = None
    except Exception as e:                              # noqa: BLE001
        err = f'{type(e).__name__}: {e}'
    finally:
        setattr(ckpt_lib, step, real)
    ckpt = f'{folder}/checkpoint'
    committed = ckpt_lib.sharded_path(ckpt) is not None
    rec.save_checkpoint(2, 0)
    return {'rank': mesh.rank, 'error': err, 'committed': committed,
            'then': ckpt_lib.restore_checkpoint(ckpt)[2]}
