"""Convergence-data helpers (``adorym_tpu/visualization.py``)."""

from .io.output import parse_loss_data  # noqa: F401
