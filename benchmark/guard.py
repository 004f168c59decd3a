"""The check that nothing of JAX or of the JAX package is loaded: module
names are compared by their top-level part as a whole, since the port's
name begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = frozenset({'jax', 'jaxlib', 'flax', 'adorym_tpu'})


class Violation(RuntimeError):
    pass


def loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.', 1)[0] for m in list(names)} & FORBIDDEN)
