"""The comparison that decides ``correct``: the program's first steps,
taken in set-up through the window's own ``run_epoch``, against the plain
reference's steps from the same inputs; and the same steps taken again
after the window, from the same parameters and a fresh Adam state, the
program's other state as the window left it (``<number>.after_window``,
held to the same limits).

Three numbers, each a relative gap held to its limit in
``limits/<cell>.json``:

* ``loss_gap``: the largest over the steps and their minibatches of
  ``|L - L_ref| / |L_ref|``, ``L`` a minibatch's loss as the step
  returns it;
* ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after one step over ``1 - b1``), by the worst leaf: the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change_gap``: each leaf's change after the last step, by the worst
  leaf, measured as ``grad_gap``; a leaf whose reference gradient is
  under a thousandth of the median leaf's (nought to rounding, moved by
  round-off alone) is left out.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, List, Tuple

import torch

GRAD_FLOOR = 1e-3
NUMBERS = ('loss_gap', 'grad_gap', 'change_gap')


def _norm(t: torch.Tensor) -> float:
    return float(t.detach().double().norm())


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``{'losses': [per-step minibatch losses],
    'grad1': {leaf: gradient}, 'change': {leaf: change}}``."""
    if len(prog['losses']) != len(ref['losses']) or not prog['losses']:
        return {n: math.inf for n in NUMBERS}
    loss_gap = max(float(((p.double() - r.double()).abs()
                          / r.double().abs()).max())
                   if p.shape == r.shape else math.inf
                   for p, r in zip(prog['losses'], ref['losses']))
    rg = {k: _norm(v) for k, v in ref['grad1'].items()}
    pg = {k: _norm(prog['grad1'][k]) for k in rg}
    med = statistics.median(rg.values())
    grad_gap = max(abs(pg[k] - rg[k]) / max(rg[k], med) for k in rg)
    counted = [k for k in rg if rg[k] >= GRAD_FLOOR * med]
    rc = {k: _norm(ref['change'][k]) for k in counted}
    pc = {k: _norm(prog['change'][k]) for k in counted}
    medc = statistics.median(rc.values())
    change_gap = max(abs(pc[k] - rc[k]) / max(rc[k], medc) for k in counted)
    return {'loss_gap': loss_gap, 'grad_gap': grad_gap,
            'change_gap': change_gap}


def program_side(steps: List[dict], obj0, probe0, leaves) -> dict:
    """The program's numbers from the recorded steps: each step's losses,
    the first gradient as read from Adam's first moment, the change after
    the last recorded step."""
    first, last = steps[0], steps[-1]
    p0 = {'obj': obj0, 'probe': probe0}
    return {'losses': [s['losses'] for s in steps],
            'grad1': {k: first['grad1'][k] for k in leaves},
            'change': {k: last['params'][k] - p0[k] for k in leaves}}


def load_limits(path: Path) -> Dict[str, float]:
    if not path.exists():
        return {}
    return {k: float(v['limit']) for k, v in json.loads(path.read_text()).items()
            if k in NUMBERS}


def judge(values: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Whether every number is finite and within its limit (a number with
    no limit fails), and ``{name: {'value', 'limit'}}``.  A number named
    ``<number>.<when>`` (the same steps taken at another time) is held to
    ``<number>``'s limit."""
    names = list(NUMBERS) + [n for n in values if n not in NUMBERS]
    out = {n: {'value': values.get(n, math.inf),
               'limit': limits.get(n.split('.')[0])} for n in names}
    ok = all(v['limit'] is not None and math.isfinite(v['value'])
             and v['value'] <= v['limit'] for v in out.values())
    return ok, out
