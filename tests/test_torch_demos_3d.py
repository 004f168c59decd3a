"""The port's 3-D demos (``adorym_tpu_torch/demos/multislice_*.py``,
BASELINE #1 and #5) against the JAX package's on the CPU: each demo's
simulated data, then its ``main`` at the CI size of
``tests/test_demos.py`` cut to 2 epochs, both packages reading the data
file the port's demo simulated; then both demos' whole CI runs on the
port, held to that file's thresholds.

Tolerances (``TOL``): the port's ``simulate`` output within 1e-5 of the
largest magnitude of the JAX package's on the same phantom, probe and
positions; the cone demo's first batch loss (before any update) within
1e-5 relative and its two epochs' mean losses within 1e-4.  The
tomography demo (the reference's CI configuration) is held looser, for
two measured reasons.  Its first batch's residual is 2.4e-3 of the
detected magnitudes (a near-vacuum start against a 1e-3 phantom), so the
two packages' f32 forward models, 2.4e-6 of the largest magnitude apart,
give first-batch losses 3.2e-5 apart even in float64: 1e-4.  And Adam
with reweighted L1 steps entries near zero on the sign of f32 noise:
perturbing the JAX package's own start by 1e-7 moves its second epoch's
loss by 1.4e-3 (``tests/test_torch_api.py::
test_adhesin_configuration_matches_jax``): epoch 1 at 1e-3, epoch 2 at
1e-2."""

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


def _nothing(mod, work):
    """The 3-D demos take their data file as an argument."""


def _ci(name, work, n_epochs):
    """``main``'s keywords at the CI size of ``tests/test_demos.py``."""
    if name == 'multislice_tomography_64':
        return dict(n_epochs=n_epochs, n_theta=12, output_folder='recon_ci',
                    data=str(work / 'd64.h5'))
    return dict(n_theta=8, n_epochs=n_epochs, scale=4,
                data=str(work / 'cone.h5'), output_folder='recon_ci')


DEMOS = ['multislice_tomography_64', 'multislice_ptycho_256_theta']

#: rtol of the first batch's loss and of each epoch's mean loss.
TOL = {'multislice_tomography_64': (1e-4, (1e-3, 1e-2)),
       'multislice_ptycho_256_theta': (1e-5, (1e-4, 1e-4))}


@pytest.fixture(scope='module', params=DEMOS)
def pair(request, tmp_path_factory):
    name = request.param
    root = tmp_path_factory.mktemp(name[:24])
    # The port's demo simulates its data file; the JAX package's demo then
    # reads the same file, so both reconstruct from the same data.
    return name, {pkg: runs.run_demo(pkg, name, root / pkg, _nothing,
                                     **_ci(name, root, 2))
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
    name, r = pair
    got, want = r['torch']['losses'][0], r['jax']['losses'][0]
    print(f'{name}: first batch loss {got!r} against {want!r}')
    np.testing.assert_allclose(got, want, rtol=TOL[name][0])


def test_two_epochs_match_jax(pair):
    name, r = pair
    got = r['torch']['results']['loss_history']
    want = r['jax']['results']['loss_history']
    print(f'{name}: epoch losses {list(got)} against {list(want)}; '
          f"correlation {r['torch']['ret']} against {r['jax']['ret']}")
    assert len(got) == 2
    for i, rtol in enumerate(TOL[name][1]):
        np.testing.assert_allclose(got[i], want[i], rtol=rtol)


def test_tomography_demo_ci_recovers_phantom(tmp_path):
    """BASELINE #1 at the CI size of ``tests/test_demos.py`` (12 angles,
    10 epochs) on the port, held to that file's threshold."""
    name = 'multislice_tomography_64'
    r = runs.run_demo('torch', name, tmp_path, _nothing,
                      **_ci(name, tmp_path, 10))
    print(f'tomography CI run: correlation {r["ret"]:.4f}')
    assert r['ret'] > 0.25, r['ret']


def test_cone_demo_ci_recovers_phantom(tmp_path):
    """BASELINE #5 at the CI size of ``tests/test_demos.py`` (scale 4: a
    64^3 cone, 24^2 probe, 8 angles, 12 epochs) on the port, held to that
    file's threshold."""
    name = 'multislice_ptycho_256_theta'
    r = runs.run_demo('torch', name, tmp_path, _nothing,
                      **_ci(name, tmp_path, 12))
    losses = r['results']['loss_history']
    print(f'cone CI run: correlation {r["ret"]:.4f}, losses {list(losses)}')
    assert np.all(np.diff(losses) < 0), losses
    assert r['ret'] > 0.3, r['ret']
