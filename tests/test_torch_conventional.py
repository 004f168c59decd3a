"""The port's conventional reconstruction (``adorym_tpu_torch.
conventional``) against the JAX package's on the CPU: ePIE after 3 epochs
(object and probe within 1e-5 of the largest value) with the probe
refined, with it fixed, with per-position probe corrections, and with
windows at and past the object's edges; the multi-distance CTF retrieval
with and without affines and a safe zone; the API's ``use_epie`` branch;
and the external CTF update (``update_using_external_algorithm='ctf'``)
on ``tests/test_multidist.py``'s configuration.  Inputs come from numpy
seeds."""

import numpy as np
import pytest
import torch

import adorym_tpu as jpkg
from adorym_tpu import conventional as jconv
from adorym_tpu.models import multidist as jmd
from adorym_tpu.recon import Reconstructor as JaxReconstructor
from adorym_tpu.simulate import simulate as jsimulate
from adorym_tpu.simulate import simulate_to_file
from adorym_tpu.utils.initialize import initialize_probe
import adorym_tpu_torch as pt
from adorym_tpu_torch import conventional as tconv
from adorym_tpu_torch.models import multidist as tmd


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's small tensors (several test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    """The largest difference over the largest value of ``b``."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


Y, P = 40, 16


def _epie_inputs(pos, seed=0):
    """A weak complex object, a structured probe, the Fraunhofer
    magnitudes of the object's windows at ``pos`` (starts as
    ``lax.dynamic_slice`` takes them) and a wider starting probe with a
    phase of its own.  (A starting probe without phase structure has
    dark far-field pixels, whose phase is f32 noise that the magnitude
    replacement amplifies: the packages then part at 5e-4.)"""
    rng = np.random.default_rng(seed)
    obj = (np.exp(0.5j * rng.random((Y, Y)))
           * (0.9 + 0.1 * rng.random((Y, Y)))).astype(np.complex64)
    yy, xx = np.mgrid[:P, :P] - (P - 1) / 2
    probe = (np.exp(-(yy ** 2 + xx ** 2) / 30)
             * np.exp(1j * rng.random((P, P)))).astype(np.complex64)
    starts = tconv._window_starts(pos, Y, P)
    data = np.stack([np.abs(np.fft.fftshift(np.fft.fft2(
        probe * obj[y:y + P, x:x + P]))) for y, x in starts])
    probe0 = (np.exp(-(yy ** 2 + xx ** 2) / 40)
              * np.exp(1j * rng.random((P, P)))).astype(np.complex64)
    return data.astype(np.float32), probe0


def _grid(lo, hi, step):
    ys = np.arange(lo, hi, step)
    yy, xx = np.meshgrid(ys, ys, indexing='ij')
    return np.stack([yy.ravel(), xx.ravel()], -1)


@pytest.mark.parametrize('case', ['probe', 'fixed_probe', 'corrections',
                                  'edges'])
def test_epie_matches_jax(case):
    """Three sequential sweeps: each window reads what the one before it
    wrote.  'edges' puts starts past both far edges (clamped) and before
    the near ones (a negative start counts from the far end, then
    clamps, as ``lax.dynamic_slice`` does by default)."""
    pos = _grid(0, Y - P + 1, 6)
    if case == 'edges':
        pos = np.concatenate([pos, [[Y - P + 5, 3], [7, Y - P + 2],
                                    [-3, 0], [0, -20]]])
    data, probe0 = _epie_inputs(pos)
    kw = dict(alpha=0.8, n_epochs=3, update_probe=case != 'fixed_probe')
    if case == 'corrections':
        kw['probe_pos_correction'] = (np.random.default_rng(1).normal(
            size=(len(pos), 2)) * 0.3).astype(np.float32)
    obj0 = np.ones((Y, Y), np.complex64)
    jo, jp = jconv.epie_reconstruct(data, probe0, pos, obj0, **kw)
    to, tp = tconv.epie_reconstruct(data, probe0, pos, obj0, device='cpu',
                                    **kw)
    assert to.dtype == torch.complex64 and to.shape == (Y, Y)
    assert _rel(to.numpy(), jo) < 1e-5
    assert _rel(tp.numpy(), jp) < 1e-5
    if case == 'fixed_probe':
        np.testing.assert_array_equal(tp.numpy(), probe0)
    assert _rel(to.numpy(), obj0) > 1e-2     # the object moved


def test_epie_window_starts():
    """``_window_starts`` against ``lax.dynamic_slice`` itself."""
    import jax
    import jax.numpy as jnp
    x = jnp.arange(10)
    for s in range(-12, 12):
        start = int(tconv._window_starts(np.asarray([s]), 10, 3)[0])
        np.testing.assert_array_equal(
            np.asarray(jax.lax.dynamic_slice(x, (s,), (3,))),
            np.arange(start, start + 3))


def test_epie_intensity_data():
    pos = _grid(0, Y - P + 1, 8)
    data, probe0 = _epie_inputs(pos, seed=2)
    inten = data ** 2
    obj0 = np.ones((Y, Y), np.complex64)
    jo, jp = jconv.epie_reconstruct(inten, probe0, pos, obj0, n_epochs=2,
                                    raw_data_type='intensity')
    to, tp = tconv.epie_reconstruct(inten, probe0, pos, obj0, n_epochs=2,
                                    raw_data_type='intensity', device='cpu')
    assert _rel(to.numpy(), jo) < 1e-5 and _rel(tp.numpy(), jp) < 1e-5


@pytest.mark.parametrize('affine,safe_zone', [(False, 0), (True, 6)])
def test_multidistance_ctf_matches_jax(affine, safe_zone):
    rng = np.random.default_rng(3)
    prj = (1.0 + 0.1 * rng.random((3, 32, 32))).astype(np.float32)
    aff = None
    if affine:
        aff = np.tile(np.asarray([[1, 0, 0], [0, 1, 0]], np.float32)[None],
                      (3, 1, 1))
        aff[1, 0, 2] = 0.05
        aff[2, 1, 1] = 1.02
    args = (prj, [1e-4, 2e-4, 3e-4], 8000.0, 1e-6)
    kw = dict(kappa=100.0, safe_zone_width=safe_zone, prj_affine_ls=aff)
    jp = np.asarray(jconv.multidistance_ctf(*args, **kw))
    tp = tconv.multidistance_ctf(*args, device='cpu', **kw)
    assert tp.shape == (32, 32) and tp.dtype == torch.float32
    assert _rel(tp.numpy(), jp) < 1e-5


@pytest.fixture(scope='module')
def epie_file(tmp_path_factory):
    """A small 2D ptychography file in the reference layout, with scan
    positions that start above and left of the object."""
    from scipy.ndimage import gaussian_filter
    root = tmp_path_factory.mktemp('epie')
    n, pn = 48, 24
    cfg = jpkg.ReconConfig(
        geometry=jpkg.Geometry(obj_size=(n, n, 1), probe_size=(pn, pn),
                               energy_ev=5000.0, psize_cm=1e-7,
                               free_prop_cm='inf', two_d_mode=True),
        train=jpkg.TrainConfig(minibatch_size=8))
    rng = np.random.default_rng(0)
    sm = gaussian_filter(rng.random((n, n, 1)), (4, 4, 0))
    sm = (sm - sm.min()) / np.ptp(sm)
    obj_true = np.stack([sm * 2e-2, sm * 5e-4], -1).astype(np.float32)
    probe = initialize_probe((pn, pn), 'gaussian', energy_ev=5000.0,
                             psize_cm=1e-7, probe_mag_sigma=5,
                             probe_phase_sigma=5, probe_phase_max=0.4)
    xs = np.arange(0, n - pn + 1, 6)
    yy, xx = np.meshgrid(xs, xs, indexing='ij')
    pos = np.stack([yy.ravel(), xx.ravel()], -1).astype(float)
    simulate_to_file(str(root / 'data.h5'), cfg, obj_true, probe, pos)
    return root, pos


@pytest.mark.parametrize('unknown_type', ['delta_beta', 'real_imag'])
def test_api_use_epie_matches_jax(epie_file, unknown_type):
    """``reconstruct_ptychography(use_epie=True)``: the first view's data,
    the first probe mode, the object from the initial guess under
    real_imag (else ones), the positions shifted to be non-negative.  The
    supplied probe has a phase of its own (see :func:`_epie_inputs`)."""
    root, pos = epie_file
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[:24, :24] - 11.5
    mag = np.exp(-(yy ** 2 + xx ** 2) / 50).astype(np.float32)
    phase = rng.random((24, 24)).astype(np.float32)
    params = dict(fname='data.h5', save_path=str(root), obj_size=(48, 48, 1),
                  probe_pos=pos - 3.0, n_epochs=3, use_epie=True,
                  epie_alpha=0.8, probe_type='supplied',
                  probe_initial=(mag, phase), free_prop_cm='inf',
                  unknown_type=unknown_type, output_folder=None)
    jr = jpkg.reconstruct_ptychography(**params)
    tr = pt.reconstruct_ptychography(**params, device='cpu')
    assert set(tr) == {'obj', 'probe'}
    assert tr['obj'].shape == (48, 48) and tr['probe'].shape == (24, 24)
    assert _rel(tr['obj'], jr['obj']) < 1e-5
    assert _rel(tr['probe'], jr['probe']) < 1e-5


N_MD, DISTS = 64, (0.05, 0.12, 0.3, 0.7)


def _md_cfg(mod, **train):
    return mod.ReconConfig(
        geometry=mod.Geometry(obj_size=(N_MD, N_MD, 1),
                              probe_size=(N_MD, N_MD), energy_ev=17500.0,
                              psize_cm=1e-5, free_prop_cm=DISTS,
                              n_dists=len(DISTS), two_d_mode=True,
                              safe_zone_width=0),
        train=mod.TrainConfig(minibatch_size=1, seed=0, **train))


@pytest.mark.parametrize('optimizer,lr', [('gd', 0.0), ('adam', 1e-3)])
def test_external_ctf_hook_matches_jax(optimizer, lr):
    """``tests/test_multidist.py``'s hook test: after each update the
    delta channel becomes the CTF retrieval of the measured holograms
    (in both packages, the same numbers); with Adam the gradient step
    comes first, and the retrieval overwrites its delta channel."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(7)
    kappa = 200.0
    ph = gaussian_filter(rng.normal(size=(N_MD, N_MD, 1)), (5, 5, 0))
    ph = ph / np.abs(ph).max() * 0.05
    mag = np.exp(ph[..., 0] / kappa)
    obj_true = np.stack([mag[..., None] * np.cos(ph),
                         mag[..., None] * np.sin(ph)], -1).astype(np.float32)
    sim = _md_cfg(jpkg, unknown_type='real_imag')
    probe = initialize_probe((N_MD, N_MD), 'plane')
    pos = np.array([[0.0, 0.0]])
    data = jsimulate(sim, obj_true, probe, pos, model=jmd) ** 2
    objs = []
    for mod, recon, model, kw in (
            (jpkg, JaxReconstructor, jmd, {}),
            (pt, pt.Reconstructor, tmd, {'device': 'cpu'})):
        cfg = _md_cfg(mod, learning_rate=lr, optimizer=optimizer,
                      unknown_type='delta_beta', ctf_kappa=kappa)
        rec = recon(cfg, data=data, probe_pos=pos, probe_init=probe,
                    obj_init=np.zeros((N_MD, N_MD, 1, 2), np.float32),
                    model=model, external_algorithm='ctf', **kw)
        rec.run_epoch(0)
        objs.append(np.asarray(rec.obj))
    assert _rel(objs[1], objs[0]) < 1e-5
    corr = np.corrcoef(objs[1][6:58, 6:58, 0, 0].ravel(),
                       ph[6:58, 6:58, 0].ravel())[0, 1]
    assert abs(corr) > 0.95, corr


def test_external_algorithm_unknown_raises():
    cfg = _md_cfg(pt, unknown_type='delta_beta')
    with pytest.raises(ValueError, match='external_algorithm'):
        pt.Reconstructor(cfg, data=np.ones((1, 4, N_MD, N_MD), np.float32),
                         probe_pos=np.zeros((1, 2)), model=tmd,
                         external_algorithm='foo', device='cpu')


def test_visualization_reexports_parse_loss_data():
    from adorym_tpu_torch import visualization
    from adorym_tpu_torch.io.output import parse_loss_data
    assert visualization.parse_loss_data is parse_loss_data


def test_epie_phaseless_probe_against_complex128():
    """C.7: ePIE's first position update from a phaseless starting probe,
    each package against a complex128 evaluation of the same update: the
    port is no farther than the JAX package (the window 3.9e-5 against
    7.2e-5 of its largest value, the probe 8.0e-5 against 9.7e-5; the
    dark far-field pixels' f32 phase, amplified by the magnitude
    replacement, sets both)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / 'tools' / 'settle_c7_c8.py'
    spec = importlib.util.spec_from_file_location('settle_c7_c8', path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tool.c7_epie()
    assert out['port_obj'] <= out['jax_obj'] < 2e-4
    assert out['port_probe'] <= out['jax_probe'] < 2e-4
