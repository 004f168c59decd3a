"""The port's 2-D demos (``adorym_tpu_torch/demos/2d_*.py``) against the
JAX package's (``demos/2d_*.py``) on the CPU: each demo's simulated data,
then its ``main`` at the CI size of ``tests/test_demos.py`` cut to 2
epochs, both packages reading the data file the port's demo simulated,
each writing its outputs under ``tmp_path``; then each demo's whole CI run
on the port, held to that file's threshold.

Tolerances: the port's ``simulate`` output within 1e-5 of the largest
magnitude of the JAX package's on the same phantom, probe and positions;
the first batch's loss (before any update) within 1e-5 relative (see
:func:`test_first_batch_loss_matches_jax`); the two epochs' mean losses
within 1e-4 relative (Adam turns f32 rounding into
single-step sign flips; ROADMAP, "How a slice is held against the
reference")."""

import os

import numpy as np
import pytest

import torch_demo_runs as runs


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors: under a parallel
    test run, several workers' thread pools oversubscribe the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _into(mod, work):
    """The demo's data file and outputs under ``work``."""
    if hasattr(mod, 'DATA_DIR'):
        mod.DATA_DIR = str(work)
    mod.DATA = str(work / os.path.basename(mod.DATA))


#: The demos and their ``main`` keywords: the CI sizes of
#: ``tests/test_demos.py`` at 2 epochs.  The position-correction demo's
#: ``main`` takes none (its 40 epochs are a few seconds); its first two
#: epochs are compared.
DEMOS = {
    '2d_ptychography_experimental_data': dict(n_epochs=2,
                                              output_folder='recon_ci'),
    '2d_multidist_holography_w_affine': dict(n_epochs=2,
                                             output_folder='recon_ci'),
    '2d_ptychography_w_probe_optimization': dict(n_epochs=2,
                                                 output_folder='recon_ci'),
    '2d_multidist_holography_w_position_correction': dict(
        n_epochs=2, output_folder='recon_ci'),
    '2d_ptychography_position_correction': {},
}

LOSS_RTOL = 1e-4


@pytest.fixture(scope='module', params=list(DEMOS))
def pair(request, tmp_path_factory):
    name = request.param
    root = tmp_path_factory.mktemp(name[:24])
    # The port's demo simulates its data file; the JAX package's demo then
    # reads the same file, so both reconstruct from the same data.
    return name, {pkg: runs.run_demo(pkg, name, root, _into, **DEMOS[name])
                  for pkg in ('torch', 'jax')}


def test_simulation_matches_jax(pair):
    name, r = pair
    sims = r['torch']['sims']
    assert sims, f'{name}: the port simulated nothing'
    for args, kwargs, got in sims:
        want = runs.jax_simulate(args, kwargs)
        assert got.shape == want.shape
        err = np.abs(got - want).max() / np.abs(want).max()
        print(f'{name}: simulate max |diff| {err:.2e} of the largest value')
        assert err <= 1e-5, (name, err)


def test_first_batch_loss_matches_jax(pair):
    """The first batch's loss (each run's loss log) within 1e-5 relative.
    Where the JAX package's own f32 mean is off the float64 mean of its
    own prediction by more than that (the probe-retrieval demo: 1.6e-5 of
    64 patterns of 64^2, XLA:CPU's f32 reduction; the port's is 1.4e-8),
    the port's is held to that float64 mean instead."""
    name, r = pair
    got = r['torch']['losses'][0]
    want = r['jax']['losses'][0]
    f64 = runs.first_batch_loss_f64('jax', r['jax'])
    print(f"{name}: first batch loss {got!r} against {want!r} (float64 of "
          f"the JAX package's prediction {f64!r}, of the port's "
          f"{runs.first_batch_loss_f64('torch', r['torch'])!r})")
    if abs(want - f64) > 1e-5 * abs(f64):
        want = f64
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_two_epochs_match_jax(pair):
    name, r = pair
    got = r['torch']['results']['loss_history'][:2]
    want = r['jax']['results']['loss_history'][:2]
    print(f'{name}: epoch losses {list(got)} against {list(want)}; '
          f"return {r['torch']['ret']} against {r['jax']['ret']}")
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


#: ``tests/test_demos.py``'s CI runs: ``main``'s keywords and the
#: threshold (the phase correlation; the probe demo's phase and probe
#: correlations; the position-correction demo's refined positions nearer
#: the truth than the nominal grid).
CI = {
    '2d_ptychography_experimental_data': (dict(n_epochs=30), 0.45),
    '2d_multidist_holography_w_affine': (dict(n_epochs=150), 0.6),
    '2d_ptychography_w_probe_optimization': (dict(n_epochs=400), (0.9, 0.9)),
    '2d_multidist_holography_w_position_correction': (dict(n_epochs=150),
                                                      0.85),
    '2d_ptychography_position_correction': ({}, None),
}


@pytest.mark.parametrize('name', list(CI))
def test_demo_ci_run_meets_threshold(name, tmp_path):
    """Each 2-D demo's CI run (``tests/test_demos.py``) on the port on
    the CPU, held to that file's threshold."""
    kwargs, threshold = CI[name]
    if kwargs:
        kwargs = dict(kwargs, output_folder='recon_ci')
    r = runs.run_demo('torch', name, tmp_path, _into, **kwargs)
    value = r['ret']
    if threshold is None:
        nominal, true, _ = runs.load_port_demo(name).problem()
        err = true - nominal
        err = err - err.mean(0)
        value = (np.abs(err).mean(),
                 np.abs(r['results']['probe_pos_correction'][0]
                        - err).mean())
        print(f'{name}: position residual {value[0]:.4f} -> '
              f'{value[1]:.4f} px')
        assert value[1] < value[0], value
        return
    print(f'{name}: {value}')
    for v, t in zip(np.atleast_1d(value), np.atleast_1d(threshold)):
        assert v > t, (value, threshold)
