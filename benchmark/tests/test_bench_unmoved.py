"""What the accepted cells run did not move when a configuration became
able to name its reference, object start and Reconstructor settings: each
cell's Reconstructor configuration and the tiny cells' inputs are as the
harness made them before (``data/unmoved.json``), and the per-channel
object start makes the delta_beta start's object from the same draws."""

import dataclasses
import hashlib
import json

import pytest
import torch

from benchmark import harness, inputs, mesh

from conftest import DATA, REPO, TINY, TINY_MIX

PINS = json.loads((DATA / 'unmoved.json').read_text())
TRAFFIC = json.loads((DATA / f'{TINY_MIX}.json').read_text())
FIELDS = ('data', 'obj', 'probe', 'positions', 'theta')


def _sha256(inp) -> dict:
    out = {}
    for k in FIELDS:
        v = getattr(inp, k)
        v = v.numpy() if isinstance(v, torch.Tensor) else v
        out[k] = hashlib.sha256(v.tobytes()).hexdigest()
    return out


@pytest.mark.parametrize('cell', sorted(PINS['reconstructor_config']))
def test_reconstructor_config_as_before(cell):
    c = harness.load_cell(cell, REPO)
    build = (harness.reconstructor_config if mesh.parallel(c) is None
             else mesh.reconstructor_config)
    got = json.loads(json.dumps(dataclasses.asdict(build(c, PINS['seed'])),
                                default=str))
    assert got == PINS['reconstructor_config'][cell]


@pytest.mark.parametrize('config', TINY)
def test_inputs_as_before(config):
    cfg = json.loads((DATA / f'{config}.json').read_text())
    inp = inputs.make(cfg, TRAFFIC, PINS['inputs']['seed'], 'cpu')
    assert _sha256(inp) == PINS['inputs']['sha256'][config]


@pytest.mark.parametrize('start, want', [
    ({'means': [8.7e-7, 5.1e-8], 'sigmas': [1e-7, 1e-8]}, None),
    ({'means': [1, 0], 'sigmas': [0, 0]}, (1.0, 0.0)),
])
def test_object_start_by_channel(start, want):
    """The per-channel form with the delta_beta start's numbers makes its
    object; a vacuum start (1, 0) makes a constant object.  Both make the
    same draws in the same order: the data and probe do not change."""
    cfg = json.loads((DATA / 'tiny_db.json').read_text())
    seed = 2 ** 31 + 19
    a = inputs.make(cfg, TRAFFIC, seed, 'cpu')
    b = inputs.make(dict(cfg, object_init=start), TRAFFIC, seed, 'cpu')
    assert torch.equal(a.data, b.data) and torch.equal(a.probe, b.probe)
    if want is None:
        assert torch.equal(a.obj, b.obj)
    else:
        assert torch.equal(b.obj, torch.tensor(want).expand_as(b.obj))
