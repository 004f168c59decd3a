"""The repository's demos on the port: one module per demo of the top-level
``demos/`` folder, under the same file name, with the same ``main(...)``
(plus ``device``: CUDA unless ``'cpu'`` is passed) and the same return
value.  Run one as ``python -m adorym_tpu_torch.demos.<name>
[--device cpu]``.  Each reads the demo's HDF5 file where ``h5py``
imports (simulating and writing it first when it is absent) and otherwise
simulates its data in memory (:mod:`._data`)."""
