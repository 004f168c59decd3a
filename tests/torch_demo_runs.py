"""Runs of a demo of the JAX package (``demos/<name>.py``) and of its port
(``adorym_tpu_torch/demos/<name>.py``) side by side, for
``tests/test_torch_demos_2d.py`` and ``tests/test_torch_demos_3d.py``.

Each package's ``reconstruct_ptychography``, its ``api.Reconstructor`` and
the port's ``simulate`` are wrapped while the demo's ``main`` runs, so a
test sees the results dict (``main`` returns only the correlation), the
Reconstructor's arguments (the initial object and probe, the data) and the
arrays the port's demo simulated from; the wrappers pass every argument
through unchanged."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import os
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def load_jax_demo(name):
    spec = importlib.util.spec_from_file_location(
        'jax_demo_' + name, REPO / 'demos' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_port_demo(name):
    return importlib.import_module(f'adorym_tpu_torch.demos.{name}')


@contextlib.contextmanager
def reconstructors(api):
    """Subclass ``api.Reconstructor`` for the block; yields the list of
    ``(reconstructor, args, kwargs)`` it built."""
    built = []
    orig = api.Reconstructor

    class Recording(orig):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append((self, args, kwargs))

    api.Reconstructor = Recording
    try:
        yield built
    finally:
        api.Reconstructor = orig


@contextlib.contextmanager
def recording(pkg, names):
    """Wrap ``pkg.<name>`` for each name; yields ``{name: [(args, kwargs,
    output), ...]}`` (an array output copied as it was returned)."""
    calls = {n: [] for n in names}
    orig = {n: getattr(pkg, n) for n in names}

    def wrap(n):
        def f(*args, **kwargs):
            out = orig[n](*args, **kwargs)
            # A copy: a demo may post-process its simulated data in place.
            calls[n].append((args, kwargs, out.copy()
                             if isinstance(out, np.ndarray) else out))
            return out
        return f

    for n in names:
        setattr(pkg, n, wrap(n))
    try:
        yield calls
    finally:
        for n, f in orig.items():
            setattr(pkg, n, f)


def first_losses(out_dir):
    """The per-batch losses of the run's loss log
    (``convergence/loss_rank_0.txt``), in logged order."""
    rows = np.genfromtxt(os.path.join(out_dir, 'convergence',
                                      'loss_rank_0.txt'),
                         delimiter=',', names=True)
    return np.atleast_1d(rows['loss'])


def run_demo(package, name, work, setup, **kwargs):
    """``main(**kwargs)`` of the demo ``name`` of ``package`` ('jax' or
    'torch'), with ``setup(module, work)`` pointing its data and outputs
    into ``work``.  Returns the return value, the ``reconstruct_ptychography``
    call's results and keywords, and (the port) the ``simulate`` calls."""
    import adorym_tpu_torch as pt
    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    if package == 'jax':
        import adorym_tpu as pkg
        from adorym_tpu import api
        mod = load_jax_demo(name)
        names = ['reconstruct_ptychography']
    else:
        pkg = pt
        from adorym_tpu_torch import api
        mod = load_port_demo(name)
        kwargs = dict(kwargs, device='cpu')
        names = ['reconstruct_ptychography', 'simulate']
    saved = {k: getattr(mod, k) for k in ('DATA', 'DATA_DIR')
             if hasattr(mod, k)}
    setup(mod, work)
    try:
        with recording(pkg, names) as calls, reconstructors(api) as recs:
            ret = mod.main(**kwargs)
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)
    (_, rkw, results), = calls['reconstruct_ptychography']
    out_dir = os.path.join(rkw['save_path'], rkw['output_folder'])
    (rec, rec_args, rec_kw), = recs
    return {'ret': ret, 'results': results, 'kwargs': rkw,
            'losses': first_losses(out_dir), 'rec': (rec, rec_args, rec_kw),
            'sims': calls.get('simulate', [])}


def first_batch_loss_f64(package, run):
    """The first minibatch's ``lsq`` loss in float64, from the package's
    own f32 prediction at the run's initial object and probe (its
    ``simulate``: the bare forward model, which is the model's prediction
    before any refined leaf has moved)."""
    rec, (cfg,), kw = run['rec']
    # The run's first draw of its batches (``run`` seeds its Generator with
    # ``train.seed``).
    i_theta, inds = rec.make_batches(np.random.default_rng(cfg.train.seed))[0]
    if package == 'jax':
        from adorym_tpu.simulate import simulate
        sim_kw = {}
    else:
        from adorym_tpu_torch.simulate import simulate
        sim_kw = {'device': 'cpu'}
    pos = np.asarray(kw['probe_pos'], np.float64)
    theta = np.asarray(kw['theta_ls'], np.float64)[i_theta:i_theta + 1]
    pred = np.asarray(simulate(cfg, kw['obj_init'], kw['probe_init'],
                               pos[inds], theta_ls=theta,
                               model=kw.get('model'), **sim_kw))[0]
    data = np.abs(np.asarray(kw['data'][i_theta], np.float64))
    # A multi-distance model's batch of blocks covers every distance.
    rows = data if len(pred) != len(inds) else data[inds]
    if cfg.loss.raw_data_type == 'intensity':
        rows = np.sqrt(rows)
    return float(np.mean((pred.astype(np.float64) - rows) ** 2))


def jax_config(cfg):
    """The JAX package's ``ReconConfig`` with the port's config's values
    (the two packages' config dataclasses have the same fields)."""
    import adorym_tpu as jp
    parts = {}
    for f in dataclasses.fields(cfg):
        sub = getattr(cfg, f.name)
        cls = getattr(jp, type(sub).__name__)
        parts[f.name] = cls(**{g.name: getattr(sub, g.name)
                               for g in dataclasses.fields(sub)})
    return jp.ReconConfig(**parts)


def jax_simulate(args, kwargs):
    """The JAX package's ``simulate`` on a port ``simulate`` call's
    arguments (the port's model module mapped to the JAX package's)."""
    from adorym_tpu.simulate import simulate
    cfg, *rest = args
    kw = {k: v for k, v in kwargs.items() if k != 'device'}
    if kw.get('model') is not None:
        kw['model'] = importlib.import_module(
            'adorym_tpu.models.' + kw['model'].__name__.rsplit('.', 1)[-1])
    return simulate(jax_config(cfg), *rest, **kw)
