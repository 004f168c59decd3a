"""The repository's user tools on the port: one module per tool of the
top-level ``tools/`` folder that works through the JAX package, under the
same file name, with the same functions and flags (``--device`` in place
of the JAX tools' ``--platform`` where the tool computes on a device).
Run one as ``python -m adorym_tpu_torch.tools.<name> ...``.
``convert_checkpoint`` is the port's own: a port checkpoint of either form
to the npz form the JAX package restores (its counterpart the other way is
the top-level ``tools/orbax_to_npz.py``, which needs JAX).

Not ported: ``create_noisy_data.py`` and ``convert_aps_2idd_to_adorym.py``
(numpy and h5py only; they serve both packages as they are) and the JAX
package's own measuring tools (``benchmark_hbm_offload.py``,
``profile_flagship.py``, ``probe_*.py``)."""
