"""The program's spans (``adorym_tpu_torch.utils.profiling``) on the CPU:
off without a profiler, in the profiler's trace and the registry under
one, nested by layer, and with no effect on the arithmetic."""

import warnings

import numpy as np
import pytest
import torch

import adorym_tpu_torch as pt
from adorym_tpu_torch.utils import profiling

N, PN, STRIDE, N_THETA = 16, 8, 4, 3
#: The parent of each span on the patch-granular per-angle path (the
#: first ``stage``, the next angle's rows requested before the loop,
#: sits in the epoch).
PARENT = {'epoch': None, 'epoch.fetch': None, 'angle': 'epoch',
          'rotate': 'angle', 'layout': 'angle', 'chunk': 'angle',
          'rotate_back': 'angle', 'update': 'angle', 'extract': 'chunk',
          'model': 'chunk', 'scatter': 'chunk'}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors (several test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def registry(monkeypatch):
    """A fresh registry in place of the process's."""
    reg = profiling.Registry()
    monkeypatch.setattr(profiling, 'REGISTRY', reg)
    return reg


def _reconstructor(fuse_g=None):
    """A per-angle Reconstructor of a 16^3 delta_beta cone at binning 4:
    a 3x3 grid of 8^2 windows at stride 4, a row a minibatch, 3 angles,
    Adam; the data uniform.  ``fuse_g`` rows a gradient chunk (scattered
    row by row) in place of the whole angle."""
    cfg = pt.ReconConfig(
        geometry=pt.Geometry(obj_size=(N, N, N), probe_size=(PN, PN),
                             energy_ev=5000.0, psize_cm=1e-7,
                             free_prop_cm='inf', binning=4),
        train=pt.TrainConfig(minibatch_size=3, learning_rate=1e-7,
                             optimizer='adam', update_scheme='per angle',
                             rotate_out_of_loop=True, seed=3))
    rng = np.random.default_rng(7)
    xs = np.arange(0, N - PN + 1, STRIDE)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    obj = np.stack([rng.normal(8.7e-7, 1e-7, (N, N, N)),
                    rng.normal(5.1e-8, 1e-8, (N, N, N))],
                   -1).astype(np.float32)
    yc = np.arange(PN) - (PN - 1) / 2
    mag = np.exp(-(yc[:, None] ** 2 + yc[None] ** 2) / 8.0)
    probe = np.stack([mag, np.zeros_like(mag)], -1)[None].astype(np.float32)
    data = rng.random((N_THETA, len(pos), PN, PN)).astype(np.float32)
    rec = pt.Reconstructor(
        cfg, data=data, probe_pos=pos, obj_init=obj, probe_init=probe,
        theta_ls=np.linspace(0, np.pi, N_THETA, endpoint=False),
        device='cpu')
    assert rec._angles and rec._patch_mode
    if fuse_g is not None:
        rec._fuse_g = fuse_g
        rec._grid_scatter_rows = None
    return rec


def _chunks_an_epoch(rec):
    n_b = rec.n_pos // rec.cfg.train.minibatch_size
    return N_THETA * -(-n_b // min(rec._fuse_g, n_b))


def test_off_without_profiler(registry):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span('angle') is profiling._OFF
    with profiling.span('angle') as sp:
        assert sp is None
    _reconstructor().run_epoch(0)
    assert registry.first is None and not registry.recent
    assert registry.per_angle() is None and registry.summary() == ''


@pytest.mark.parametrize('fuse_g', [None, 2])
def test_spans_in_trace_and_registry(registry, fuse_g):
    """Under a CPU profiler every span is a user annotation ``adorym.*``
    nested by layer; the registry holds an ``angle`` an angle and a
    ``chunk`` a gradient chunk, each with its host time (no stream time
    off the card) and no host wait."""
    rec = _reconstructor(fuse_g)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec.run_epoch(0)
    ours = [e for e in prof.events()
            if e.name.startswith(profiling.PREFIX)]
    names = {e.name[len(profiling.PREFIX):] for e in ours}
    assert names >= set(PARENT) | {'stage'}
    for e in ours:
        assert e.is_user_annotation, e.name
        name = e.name[len(profiling.PREFIX):]
        parent = e.cpu_parent
        got = (None if parent is None
               or not parent.name.startswith(profiling.PREFIX)
               else parent.name[len(profiling.PREFIX):])
        want = PARENT.get(name, ('angle', 'epoch'))
        assert got in (want if isinstance(want, tuple) else (want,)), (
            name, got)
    pa = registry.per_angle()
    assert pa['epoch'] == 0 and pa['angles'] == N_THETA
    spans = pa['spans']
    assert spans['angle']['count'] == 1
    n_chunks = _chunks_an_epoch(rec)
    assert n_chunks == (N_THETA if fuse_g is None else 2 * N_THETA)
    assert spans['chunk']['count'] * N_THETA == n_chunks
    for leaf in ('extract', 'model', 'scatter'):
        assert spans[leaf]['count'] * N_THETA == n_chunks
    recs = registry.first.records
    assert all(r.parent == PARENT[r.name] for r in recs if r.name in PARENT)
    assert {r.parent for r in recs if r.name == 'stage'} == {'angle',
                                                              'epoch'}
    assert [r.angle for r in recs if r.name == 'angle'] == list(
        range(N_THETA))
    assert all(r.stream_ms is None and r.syncs == 0 for r in recs)
    assert all(s['stream_ms'] is None and s['host_ms'] >= 0
               for s in spans.values())
    assert spans['angle']['host_ms'] >= spans['chunk']['host_ms']
    assert 'spans (host ms an angle, 3 angles)' in registry.summary()


def test_bit_equal_with_and_without_profiler(registry):
    from torch.profiler import ProfilerActivity, profile
    plain, traced = _reconstructor(), _reconstructor()
    want = [plain.run_epoch(i) for i in range(2)]
    with profile(activities=[ProfilerActivity.CPU]):
        got = [traced.run_epoch(i) for i in range(2)]
    assert got == want
    for k in plain.params:
        assert torch.equal(plain.params[k], traced.params[k]), k
    assert registry.first.label == 0 and registry.recent[-1].label == 1


def test_verbose_line(registry, capsys):
    """The epoch line keeps its rate, and an epoch run under a profiler
    adds its spans an angle."""
    rec = _reconstructor()
    rec.verbose = True
    rec.run_epoch(0)
    out = capsys.readouterr().out
    assert '[epoch 0] loss=' in out and 'patterns/s' in out
    assert 'spans (' not in out
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        rec.run_epoch(1)
    out = capsys.readouterr().out
    assert 'patterns/s; spans (host ms an angle, 3 angles): ' in out
    assert 'chunk ' in out and 'update ' in out


def test_spans_outside_an_epoch(registry):
    """Spans opened outside any epoch (a profiler started inside one, or
    a step called directly) go to a record of their own, never into the
    last traced epoch's."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span('epoch', label=0):
            with profiling.span('angle'):
                pass
        for _ in range(2):
            with profiling.span('angle'):
                with profiling.span('update'):
                    pass
    assert registry.first.label == 0 and registry.first.angles == 1
    loose = registry.recent[-1]
    assert loose.label is None and loose.angles == 2
    assert registry.per_angle(loose)['spans']['update']['count'] == 1


def test_syncs_counted_by_innermost_span(registry, monkeypatch):
    """PyTorch's sync warnings count against the innermost open span and
    are not shown; other warnings pass; the sync debug mode and the
    warning filters come back when the outermost span closes."""
    modes = [0]
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    monkeypatch.setattr(torch.cuda, 'get_sync_debug_mode',
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, 'set_sync_debug_mode',
                        lambda m: modes.append(m))
    monkeypatch.setattr(registry, 'event', lambda: None)
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter('always')
        filters = list(warnings.filters)
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span('epoch', label=4):
                with profiling.span('angle'):
                    assert modes[-1] == 'warn'
                    warnings.warn(profiling.SYNC_WARNING)
                    with profiling.span('update'):
                        for _ in range(2):
                            warnings.warn(profiling.SYNC_WARNING)
                    warnings.warn('another warning')
            with profiling.span('epoch.fetch', registry.first):
                warnings.warn(profiling.SYNC_WARNING)
        assert warnings.filters == filters
    assert modes[-1] == 0
    assert [str(w.message) for w in shown] == ['another warning']
    pa = registry.per_angle()
    assert pa['epoch'] == 4 and pa['syncs'] == 4
    assert {k: s['syncs'] for k, s in pa['spans'].items()} == {
        'update': 2, 'angle': 1, 'epoch': 0, 'epoch.fetch': 1}
    assert 'update 0.' in registry.summary() and '2 syncs' in (
        registry.summary())


def test_resolve_waits_for_nothing(registry):
    """A record's stream time is read when its epoch is read, once both
    its events are passed, and never by waiting: an event not passed
    keeps it pending."""

    class Ev:
        def __init__(self, done, t):
            self.done, self.t = done, t

        def query(self):
            return self.done

        def elapsed_time(self, other):
            return other.t - self.t

    ep = profiling.Epoch(2)
    ep.angles = 2
    registry.first = ep
    a, b, c = Ev(True, 1.0), Ev(True, 4.0), Ev(False, 9.0)
    for name, evs in (('chunk', (a, b)), ('update', (b, c))):
        r = profiling.Record(name, 'angle', 0, 1.0, events=evs)
        ep.records.append(r)
        ep.pending.append(r)
    pa = registry.per_angle()
    assert pa['spans']['chunk']['stream_ms'] == 1.5
    assert pa['spans']['update']['stream_ms'] is None
    assert registry.pool == [a, b] and len(ep.pending) == 1
    c.done = True
    assert registry.per_angle()['spans']['update']['stream_ms'] == 2.5
    assert not ep.pending
