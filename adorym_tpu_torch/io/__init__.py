"""Measurement files, run outputs and checkpoints in the reference's
layouts (``adorym_tpu/io/``)."""
