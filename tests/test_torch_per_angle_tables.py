"""The port's per-angle path for every scan table and option, against the
JAX package on the same numpy inputs: chunk staging with weights (chunks
the batch count does not divide), the three extraction and scatter
branches of ``patch_accum`` (complete grid, grid rows one at a time, any
table patch by patch), the whole-object branch (jittered and randomized
tables, a model without a patch-granular form), per-angle scan tables on
every path, the streaming rotation and the exact rotate-back; then
``scatter_patches_add``, the rotation's y-chunk split and the padding of
a per-angle table.

The drive is ``tests/test_torch_recon.py``'s: a 32^3 object, a 16^2
probe, a 4x4 grid at stride 4, 3 angles, minibatch 4, binning 2, GD.
Losses are held at rtol 1e-5 and objects at 1e-5 of the largest value.
Chunks that do not divide the batch count are forced in both packages the
same way, by patching each package's device-capacity query
(``hbm_limit_bytes``): at 7e6 bytes both chunk budgets give 3 batches a
chunk to the binned patches of the patch-granular branches, at 11e6 to
the full-depth patches of the whole-object branch, and both rotations
split the 32 y planes into 8 chunks.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import adorym_tpu.config as jcfg
import adorym_tpu.recon as jrecon
import adorym_tpu.utils.profiling as jprof
from adorym_tpu.models import ptychography as jmodel
from adorym_tpu.ops import patches as jpatches
from adorym_tpu.ops import rotate as jrot
import adorym_tpu_torch as pt
import adorym_tpu_torch.utils.profiling as tprof
from adorym_tpu_torch.io.data import ArrayDataset
from adorym_tpu_torch.models import ptychography as tmodel
from adorym_tpu_torch.ops import patches as tpatches
from adorym_tpu_torch.ops import rotate as trot

N, PN, MB = 32, 16, 4


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors (several test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _capacity(monkeypatch, nbytes):
    """Both packages sized for a device of ``nbytes``."""
    monkeypatch.setattr(jprof, 'hbm_limit_bytes', lambda: nbytes)
    monkeypatch.setattr(tprof, 'hbm_limit_bytes',
                        lambda device=None: nbytes)


@pytest.fixture
def small_device(monkeypatch):
    """A 7e6-byte device: 3 batches a chunk at patch granularity, the
    rotation in 8 y chunks."""
    _capacity(monkeypatch, 7e6)


def _grid(k=4, stride=4):
    xs = np.arange(k) * stride
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    return np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)


def _jittered(seed=0, lo=-2, hi=3):
    return _grid() + np.random.default_rng(seed).integers(lo, hi, (16, 2))


def _staggered():
    """Odd rows shifted by half the stride: every row a constant-stride
    row, the rows no complete grid."""
    pos = _grid()
    pos[4:8, 1] += 2
    pos[12:16, 1] += 2
    return pos


def _per_angle(n_theta=3):
    """One jittered table an angle."""
    return np.stack([_jittered(seed=10 + i) for i in range(n_theta)])


TABLES = {'grid': _grid, 'jittered': _jittered, 'staggered': _staggered,
          'per_angle': _per_angle}


def _cfg(mod, loss=None, geo=None, **train):
    kw = dict(minibatch_size=MB, learning_rate=1e-3, optimizer='gd',
              rotate_out_of_loop=True, update_scheme='per angle',
              fused_multislice='off', zmajor_extract='off')
    kw.update(train)
    return mod.ReconConfig(
        geometry=mod.Geometry(obj_size=(N, N, N), probe_size=(PN, PN),
                              energy_ev=5000., psize_cm=1e-7,
                              free_prop_cm='inf', binning=2,
                              **(geo or {})),
        train=mod.TrainConfig(**kw), loss=mod.LossConfig(**(loss or {})))


def _inputs(pos, n_theta=3, seed=0):
    rng = np.random.default_rng(seed)
    n_pos = pos.shape[-2]
    data = rng.random((n_theta, n_pos, PN, PN)).astype(np.float32)
    obj0 = (rng.random((N, N, N, 2)) * 1e-3).astype(np.float32)
    theta = np.linspace(0, np.pi, n_theta, endpoint=False)
    return data, theta, obj0


def _pair(table, n_epochs=2, model=None, **kw):
    """Both packages' Reconstructors on the same inputs, ``n_epochs`` GD
    epochs.  Returns (jr, jl, tr, tl, obj0)."""
    pos = TABLES[table]() if isinstance(table, str) else table
    data, theta, obj0 = _inputs(pos)
    recs = []
    for mod, rmod, dev in ((jcfg, jrecon, None), (pt, pt, 'cpu')):
        extra = {} if dev is None else {'device': dev}
        if model is not None:
            extra['model'] = model[0 if dev is None else 1]
        rec = rmod.Reconstructor(_cfg(mod, **kw), data=data,
                                 probe_pos=pos, theta_ls=theta,
                                 obj_init=obj0.copy(), **extra)
        recs.append((rec, [rec.run_epoch(e) for e in range(n_epochs)]))
    (jr, jl), (tr, tl) = recs
    return jr, np.asarray(jl), tr, np.asarray(tl), obj0


def _obj_close(tr, jr, tol=1e-5):
    jo = np.asarray(jr.params['obj'])
    return np.max(np.abs(tr.obj - jo)) <= tol * np.max(np.abs(jo))


def _agree(jr, jl, tr, tl):
    assert tr._angles
    assert (tr.i_opt_batch, tr.global_batch) == (jr.i_opt_batch,
                                                 jr.global_batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert _obj_close(tr, jr)


# -- 0: the padding of a per-angle table --------------------------------------

def test_pad_of_per_angle_table_matches_jax():
    """``pad_arr`` of a 3-D table whose spots differ by angle (one angle
    reaches past the top-left corner, another past the bottom-right): the
    flattened table's extent, as in the JAX package."""
    pos = _per_angle()
    pos[0, 0] = (-5, -3)
    pos[2, -1] = (N - PN + 6, N - PN + 2)
    data, theta, obj0 = _inputs(pos)
    jr = jrecon.Reconstructor(_cfg(jcfg), data=data,
                              probe_pos=pos, theta_ls=theta, obj_init=obj0)
    tr = pt.Reconstructor(_cfg(pt), data=data, probe_pos=pos,
                          theta_ls=theta, obj_init=obj0, device='cpu')
    np.testing.assert_array_equal(tr.pad_arr, jr.pad_arr)
    np.testing.assert_array_equal(tr.pad_arr, [[5, 6], [3, 2]])


# -- 1 and 2: chunk staging and the scatter branches --------------------------

def test_stage_angle_pads_by_the_last_batch(small_device):
    """4 batches in chunks of 3: the second chunk is the last batch and
    two repeats of it at weight 0, positions from the angle's own table."""
    pos = _per_angle()
    data, theta, obj0 = _inputs(pos)
    tr = pt.Reconstructor(_cfg(pt, patch_grad=True), data=data,
                          probe_pos=pos, theta_ls=theta, obj_init=obj0,
                          device='cpu')
    jr = jrecon.Reconstructor(_cfg(jcfg, patch_grad=True), data=data,
                              probe_pos=pos, theta_ls=theta, obj_init=obj0)
    assert tr._fuse_g == jr._fuse_g == 3
    inds_list = [np.arange(4 * b, 4 * b + 4) for b in range(4)]
    got = tr._stage_angle(2, inds_list)
    want = jr._stage_angle(2, inds_list)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    inds, p, w, n_b = got
    assert n_b == 4 and inds.shape == (2, 12)
    np.testing.assert_array_equal(w, [[1, 1, 1], [1, 0, 0]])
    np.testing.assert_array_equal(p[1, 4:], np.tile(pos[2, 12:16], (2, 1)))


#: (table, train options, the branch patch_accum takes).
BRANCHES = {
    # Complete grid, chunks of 3 rows: the last chunk padded, so the grid
    # rows scatter one at a time (K6 on the card).
    'grid_rows_padded': ('grid', dict(), 'rows'),
    'grid_rows_padded_zmajor': ('grid', dict(zmajor_extract='on'), 'rows'),
    # Staggered rows: grid rows, no complete grid.
    'staggered': ('staggered', dict(), 'rows'),
    'staggered_zmajor': ('staggered', dict(zmajor_extract='on'), 'rows'),
    # Any other table under patch_grad: patch by patch.
    'jittered_patch_grad': ('jittered', dict(patch_grad=True), 'patches'),
    'jittered_patch_grad_zmajor': ('jittered', dict(patch_grad=True,
                                                    zmajor_extract='on'),
                                   'patches'),
    'randomized_patch_grad': ('grid', dict(randomize_probe_pos=True,
                                           patch_grad=True), 'patches'),
    'per_angle_patch_grad': ('per_angle', dict(patch_grad=True), 'patches'),
}


@pytest.mark.parametrize('case', list(BRANCHES))
def test_patch_branches_match_jax(case, small_device):
    """Each branch of ``patch_accum`` at chunks of 3 of the 4 batches an
    angle: the same batches, updates, losses and object as the JAX
    package's."""
    table, kw, branch = BRANCHES[case]
    jr, jl, tr, tl, _ = _pair(table, **kw)
    assert tr._patch_mode and tr._fuse_g == 3
    assert tr._grid_scatter_rows is None
    assert (tr._rowgrid_stride is not None) == (branch == 'rows')
    _agree(jr, jl, tr, tl)


def test_complete_grid_whole_chunks_unchanged():
    """The complete grid in whole chunks keeps the grid gather and
    scatter: one chunk an angle at the default capacity."""
    jr, jl, tr, tl, _ = _pair('grid', zmajor_extract='on',
                              fused_multislice='on')
    assert tr._grid_scatter_rows == jr._grid_scatter_rows == 4
    _agree(jr, jl, tr, tl)


# -- 3 and 7: the whole-object branch -----------------------------------------

WHOLE = {
    'jittered': ('jittered', dict()),
    'jittered_chunked': ('jittered', dict(small=True)),
    'randomized': ('grid', dict(randomize_probe_pos=True)),
    'per_angle': ('per_angle', dict()),
    'jittered_regularized': ('jittered', dict(
        loss=dict(alpha_d=1e-9, alpha_b=1e-10, gamma=1e-9))),
    'jittered_2d': ('jittered', dict(two_d=True)),
}


@pytest.mark.parametrize('case', list(WHOLE))
def test_whole_object_branch_matches_jax(case, monkeypatch):
    """Tables that are not grid rows, without ``patch_grad``: each chunk
    differentiated through ``predict`` on the whole rotated object, its
    regularizers inside the chunk's loss."""
    table, kw = WHOLE[case]
    kw = dict(kw)
    small = kw.pop('small', False)
    if small:
        _capacity(monkeypatch, 11e6)
    if kw.pop('two_d', False):
        _two_d(monkeypatch)
        return
    jr, jl, tr, tl, _ = _pair(table, **kw)
    assert not tr._patch_mode and not jr._patch_mode
    assert tr._fuse_g == jr._fuse_g == (3 if small else 64)
    _agree(jr, jl, tr, tl)


def _two_d(monkeypatch):
    """The 2D per-angle path on a jittered table: nothing rotates."""
    pos = _jittered()
    rng = np.random.default_rng(3)
    data = rng.random((1, len(pos), PN, PN)).astype(np.float32)
    obj0 = (rng.random((N, N, 1, 2)) * 1e-3).astype(np.float32)
    out = []
    for mod, rmod, extra in ((jcfg, jrecon, {}), (pt, pt, {'device': 'cpu'})):
        cfg = mod.ReconConfig(
            geometry=mod.Geometry(obj_size=(N, N, 1), probe_size=(PN, PN),
                                  energy_ev=5000., psize_cm=1e-7,
                                  free_prop_cm='inf', two_d_mode=True),
            train=mod.TrainConfig(minibatch_size=MB, learning_rate=1e-3,
                                  optimizer='gd', update_scheme='per angle'))
        rec = rmod.Reconstructor(cfg, data=data, probe_pos=pos,
                                 obj_init=obj0.copy(), **extra)
        out.append((rec, [rec.run_epoch(e) for e in range(2)]))
    (jr, jl), (tr, tl) = out
    _agree(jr, np.asarray(jl), tr, np.asarray(tl))


def test_model_without_patch_form_matches_jax():
    """A forward model with ``predict`` alone takes the whole-object
    branch on the complete grid."""
    jm = types.SimpleNamespace(predict=jmodel.predict)
    tm = types.SimpleNamespace(predict=tmodel.predict)
    jr, jl, tr, tl, _ = _pair('grid', model=(jm, tm))
    assert tr._rowgrid_stride is None and not tr._patch_mode
    _agree(jr, jl, tr, tl)


# -- 4: per-angle tables on the other paths -----------------------------------

@pytest.mark.parametrize('scheme', [
    dict(update_scheme='per angle', rotate_out_of_loop=False),
    dict(update_scheme='immediate', rotate_out_of_loop=True),
    dict(update_scheme='immediate', rotate_out_of_loop=False)])
def test_per_angle_tables_off_the_angle_path_match_jax(scheme):
    """3-D tables through the accumulate loop and the immediate scheme's
    generic step: each batch's positions from its angle's table."""
    jr, jl, tr, tl, _ = _pair('per_angle', **scheme)
    assert not tr._angles and not tr._band
    assert (tr.i_opt_batch, tr.global_batch) == (jr.i_opt_batch,
                                                 jr.global_batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert _obj_close(tr, jr)


def test_make_batches_same_draws_per_angle_and_randomized():
    """The JAX package's draws from the same Generator on a ragged 3-D
    table (random pads) and under ``randomize_probe_pos``."""
    pos = np.concatenate([_per_angle(), _per_angle()[:, :2]], axis=1)
    data, theta, obj0 = _inputs(pos)
    for table, kw in ((pos, {}), (_grid(), dict(randomize_probe_pos=True))):
        d = data[:, :table.shape[-2]]
        jr = jrecon.Reconstructor(_cfg(jcfg, **kw), data=d,
                                  probe_pos=table, theta_ls=theta,
                                  obj_init=obj0)
        tr = pt.Reconstructor(_cfg(pt, **kw), data=d, probe_pos=table,
                              theta_ls=theta, obj_init=obj0, device='cpu')
        for seed in range(2):
            jb = jr.make_batches(np.random.default_rng(seed))
            tb = tr.make_batches(np.random.default_rng(seed))
            assert ([(i, list(b)) for i, b in jb]
                    == [(i, list(b)) for i, b in tb])


def test_api_ragged_per_angle_tables_match_jax(tmp_path):
    """``reconstruct_ptychography(common_probe_pos=False)`` on an HDF5
    file whose angles hold 16, 14 and 11 spots (the data rows past an
    angle's count repeat its last pattern): the tables padded by the last
    spot, per angle, in both packages."""
    from adorym_tpu.api import reconstruct_ptychography as jrun
    from adorym_tpu.io.data import write_data_file
    pytest.importorskip('h5py')
    tables = [t[:n] for t, n in zip(_per_angle(), (16, 14, 11))]
    rng = np.random.default_rng(5)
    data = rng.random((3, 16, PN, PN)).astype(np.float32)
    for i, t in enumerate(tables):
        data[i, len(t):] = data[i, len(t) - 1]
    theta = np.linspace(0, np.pi, 3, endpoint=False)
    write_data_file(str(tmp_path / 'd.h5'), data, theta=theta,
                    energy_ev=5000.0, psize_cm=1e-7,
                    probe_pos_per_angle=tables)
    obj0 = (rng.random((N, N, N, 2)) * 1e-3).astype(np.float32)
    kw = dict(fname='d.h5', save_path=str(tmp_path), obj_size=(N, N, N),
              n_epochs=2, minibatch_size=MB, learning_rate=1e-3,
              optimizer='gd', common_probe_pos=False, binning=2,
              free_prop_cm='inf', update_scheme='per angle',
              rotate_out_of_loop=True,
              initial_guess=(obj0[..., 0], obj0[..., 1]),
              use_checkpoint=False, output_folder=None,
              probe_mag_sigma=4, probe_phase_sigma=4, probe_phase_max=0.3)
    want = jrun(**kw)
    got = pt.reconstruct_ptychography(device='cpu', **kw)
    np.testing.assert_allclose(got['loss_history'], want['loss_history'],
                               rtol=1e-5)
    jo = np.asarray(want['obj'])
    assert np.max(np.abs(got['obj'] - jo)) <= 1e-5 * np.max(np.abs(jo))


# -- 5 and 6: the streaming rotation and the exact rotate-back ----------------

@pytest.mark.parametrize('table', ['grid', 'staggered', 'jittered'])
def test_streaming_rotation_matches_jax_and_off(table, small_device):
    """``stream_rotation='on'`` (8 y chunks at the patched capacity): the
    JAX package's losses and object, and the port's own run with
    ``'off'`` exactly."""
    kw = dict(patch_grad=True) if table == 'jittered' else {}
    jr, jl, tr, tl, _ = _pair(table, stream_rotation='on', **kw)
    assert tr._stream_rot
    _agree(jr, jl, tr, tl)
    _, _, off, ol, _ = _pair(table, stream_rotation='off', **kw)
    assert not off._stream_rot
    np.testing.assert_array_equal(tl, ol)
    np.testing.assert_array_equal(tr.obj, off.obj)


def test_streaming_auto_threshold(monkeypatch):
    """``'auto'`` streams past 1.5/16 of the device's capacity, in both
    packages, and regularizers or the exact rotate-back turn it off."""
    pos = _grid()
    data, theta, obj0 = _inputs(pos)
    obj_bytes = obj0.nbytes
    for cap, on in ((obj_bytes * 16 / 1.5 * 0.99, True),
                    (obj_bytes * 16 / 1.5 * 1.01, False)):
        monkeypatch.setattr(tprof, 'hbm_limit_bytes',
                            lambda device=None, c=cap: c)
        monkeypatch.setattr(jprof, 'hbm_limit_bytes', lambda c=cap: c)
        assert (jprof.stream_rotation_auto_bytes() < obj_bytes) == on
        for kw, want in ((dict(), on), (dict(exact_grad_rotation=True),
                                        False)):
            tr = pt.Reconstructor(_cfg(pt, **kw), data=data,
                                  probe_pos=pos, theta_ls=theta,
                                  obj_init=obj0, device='cpu')
            assert tr._stream_rot == want
        tr = pt.Reconstructor(_cfg(pt, loss=dict(gamma=1e-9)),
                              data=data, probe_pos=pos, theta_ls=theta,
                              obj_init=obj0, device='cpu')
        assert not tr._stream_rot


@pytest.mark.parametrize('table,kw', [
    ('grid', dict()), ('staggered', dict(small=True)),
    ('jittered', dict()), ('jittered', dict(patch_grad=True))])
def test_exact_grad_rotation_matches_jax(table, kw, monkeypatch):
    """``exact_grad_rotation=True`` per angle: the gradient rotated back by
    the rotation's transpose, on the grid, row and patch branches and the
    whole-object branch."""
    kw = dict(kw)
    if kw.pop('small', False):
        _capacity(monkeypatch, 7e6)
    jr, jl, tr, tl, _ = _pair(table, exact_grad_rotation=True, **kw)
    _agree(jr, jl, tr, tl)


# -- the pieces alone ---------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_scatter_patches_add_matches_jax(dtype):
    """The transpose of the gather for any table, starts past every edge
    and negative ones included (clamped as the gather clamps them), f32
    or bf16 patches summed into an f32 accumulator."""
    rng = np.random.default_rng(6)
    acc = rng.normal(size=(20, 18, 3, 2)).astype(np.float32)
    pos = np.array([[0, 0], [-3, 5], [15, -4], [17, 15], [9, 9], [9, 10],
                    [30, 2], [-30, -30], [4, 40]])
    pat = torch.from_numpy(rng.normal(size=(len(pos), 6, 6, 3, 2)).astype(
        np.float32)).to(dtype)
    want = jpatches.scatter_patches_add(
        jnp.asarray(acc), jnp.asarray(pat.float().numpy()), jnp.asarray(pos))
    got = tpatches.scatter_patches_add(torch.from_numpy(acc.copy()), pat, pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # The gather's transpose: <scatter(p), o> == <p, gather(o)>.
    o = torch.from_numpy(rng.normal(size=acc.shape).astype(np.float32))
    lhs = (tpatches.scatter_patches_add(torch.zeros_like(o), pat.float(),
                                        pos) * o).sum()
    rhs = (pat.float() * tpatches.extract_patches(o, pos, (6, 6))).sum()
    assert abs(float(lhs - rhs)) < 1e-4 * abs(float(rhs))


@pytest.mark.parametrize('binning,nz', [(2, 12), (8, 24)])
@pytest.mark.parametrize('method', ['bilinear', 'nearest'])
def test_rotate_and_bin_z_in_chunks(binning, nz, method, monkeypatch):
    """The y-chunk split (8 chunks of 4 planes at a patched capacity):
    equal to the one-chunk form, and to the JAX package's split; the
    gradient's expanded rotate-back and the plain rotation likewise."""
    obj = np.random.default_rng(7).normal(size=(32, 11, nz, 2)).astype(
        np.float32)
    one = trot.rotate_and_bin_z(torch.from_numpy(obj), 0.7, binning,
                                method=method)
    g_b = one.clone()
    exp_one = trot.rotate_expanded_from_binned_z(g_b, -0.7, binning, nz,
                                                 method=method)
    rot_one = trot.rotate(torch.from_numpy(obj), 0.7, method=method)
    cap = obj.nbytes * 16.0
    monkeypatch.setattr(tprof, 'hbm_limit_bytes', lambda device=None: cap)
    monkeypatch.setattr(jprof, 'hbm_limit_bytes', lambda: cap)
    assert trot._carried_chunks(32, obj.nbytes, 'cpu') == 8
    assert jrot._carried_chunks(32, obj.nbytes) == 8
    got = trot.rotate_and_bin_z(torch.from_numpy(obj), 0.7, binning,
                                method=method)
    torch.testing.assert_close(got, one, rtol=0, atol=0)
    want = jrot.rotate_and_bin_z(jnp.asarray(obj), 0.7, binning,
                                 method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(obj).max())
    exp = trot.rotate_expanded_from_binned_z(g_b, -0.7, binning, nz,
                                             method=method)
    torch.testing.assert_close(exp, exp_one, rtol=0, atol=0)
    rot = trot.rotate(torch.from_numpy(obj), 0.7, method=method)
    torch.testing.assert_close(rot, rot_one, rtol=0, atol=0)


def test_chunked_rotation_differentiates():
    """Autograd through the chunked rotation: its transpose equals the
    one-chunk form's."""
    cot = torch.from_numpy(np.random.default_rng(8).normal(
        size=(32, 10, 12, 2)).astype(np.float32))
    want = trot.rotate_adjoint(cot, 0.4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tprof, 'hbm_limit_bytes',
                   lambda device=None: cot.numel() * 4 * 16.0)
        got = trot.rotate_adjoint(cot, 0.4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
