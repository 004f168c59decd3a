"""Faults planted under the timed path, to show that the comparison sees
them: a step that leaves the state unchanged, half of each minibatch left
out (the mean taken over the rest), an answer altered where it is
produced (the first pattern's predicted magnitudes of each gradient chunk
1% high), and a stale cache (each rotation kept by its angle and never
refreshed: right on an angle's first visit, the state of that visit
after).  On a mesh (``MESH_KINDS``) also: the exchange between the ranks
left out (each ring shift of the object axis hands back zeros, so a
window that crosses into the next slab sees vacuum there), and one rank's
slab altered (the rank at object-axis 1 never updates).  Used by
``calibrate.py`` on the card and by the CPU tests; the benchmark's own
runs plant nothing."""

from __future__ import annotations

import contextlib

import torch

KINDS = ('unchanged', 'half', 'alter', 'stale')
MESH_KINDS = ('exchange', 'slab')


@contextlib.contextmanager
def planted(kind: str):
    from adorym_tpu_torch import recon
    from adorym_tpu_torch.models import base, ptychography
    if kind == 'unchanged':
        owner, name = recon.Reconstructor, 'apply_step'

        def fault(self, grads, *args, **kwargs):
            return None
    elif kind == 'half':
        owner, name = base, 'mismatch_loss'
        orig = base.mismatch_loss

        def fault(*args, **kwargs):
            out = orig(*args, **kwargs)
            if kwargs.get('per_item'):
                out = out.clone()
                odd = out[1::2].shape[0]
                out[1::2] = out[0::2][:odd]
            return out
    elif kind == 'alter':
        owner, name = ptychography, 'incoherent_mode_sum'
        orig = ptychography.incoherent_mode_sum

        def fault(waves):
            out = orig(waves)
            return torch.cat([out[:1] * 1.01, out[1:]])
    elif kind == 'stale':
        owner, name = recon, 'rotate'
        orig = recon.rotate
        kept = {}

        def fault(vol, theta, *args, **kwargs):
            key = (repr(float(theta)), tuple(vol.shape))
            if key not in kept:
                kept[key] = orig(vol, theta, *args, **kwargs)
            return kept[key]
    elif kind == 'exchange':
        from adorym_tpu_torch.parallel.comm import Comm
        owner, name = Comm, 'ring_shift'

        def fault(self, t, *args, **kwargs):
            return torch.zeros_like(t)
    elif kind == 'slab':
        owner, name = recon.Reconstructor, 'apply_step'
        orig = recon.Reconstructor.apply_step

        def fault(self, *args, **kwargs):
            if self.mesh is None or self.mesh.op != 1:
                return orig(self, *args, **kwargs)
            return None
    else:
        raise ValueError(f'unknown fault {kind!r}')
    saved = owner.__dict__[name]
    setattr(owner, name, fault)
    try:
        yield
    finally:
        setattr(owner, name, saved)
