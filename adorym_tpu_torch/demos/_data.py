"""Where a demo's measurements come from.

Where ``h5py`` imports, the demo's HDF5 file: the one in the repository's
``demos/`` folder if it is there, else simulated once by the port and
written in the reference layout, as the JAX package's demos do.  Without
``h5py`` (the H100 machine has none) the port simulates the data in memory
and hands them to ``reconstruct_ptychography`` as an
:class:`~adorym_tpu_torch.io.data.ArrayDataset`.  This chooses storage
only; the simulation and the reconstruction run on the same device either
way.
"""

from __future__ import annotations

import argparse
import os

from ..io.data import ArrayDataset, write_data_file

#: The top-level ``demos/`` folder of the repository, where the JAX
#: package's demos keep their data files.
DEMOS_DIR = os.path.normpath(os.path.join(os.path.dirname(__file__), '..',
                                          '..', 'demos'))


def have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def measured(path: str, make):
    """The ``dataset`` argument of ``reconstruct_ptychography`` for the
    data file ``path``: None where the file is read (``h5py`` imports;
    ``make()`` simulates it and it is written first when it is absent),
    else an ``ArrayDataset`` of ``make()``'s arrays.  ``make()`` returns
    ``(data, metadata)``, the metadata in ``write_data_file``'s keywords
    (``theta``, ``probe_pos``, ``energy_ev``, ``psize_cm``,
    ``free_prop_cm``).  Prints which of the two it took."""
    if have_h5py():
        if not os.path.exists(path):
            print('simulating dataset ...', flush=True)
            data, meta = make()
            write_data_file(path, data, **meta)
        print(f'data: the HDF5 file {path}', flush=True)
        return None
    print('data: h5py is not installed; simulated in memory and passed as '
          'an ArrayDataset', flush=True)
    data, meta = make()
    return ArrayDataset(data, theta=meta.get('theta'),
                        probe_pos_px=meta.get('probe_pos'),
                        energy_ev=meta.get('energy_ev'),
                        psize_cm=meta.get('psize_cm'),
                        free_prop_cm=meta.get('free_prop_cm'))


def device_parser(description: str) -> argparse.ArgumentParser:
    """A demo's argument parser with its ``--device`` flag."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument('--device', default=None,
                   help="'cpu' to run on the CPU (default: the CUDA card)")
    return p
