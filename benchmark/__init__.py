"""The benchmark of adorym_tpu_torch on one NVIDIA card: ``run.py`` runs one
cell of ``BENCHMARK.json`` (see ``harness.py``)."""
