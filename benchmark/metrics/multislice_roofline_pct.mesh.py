"""The multislice sweep's share of its roofline on a mesh: the least time
of the whole angle's sweeps (every position once, ``work/multislice.py``)
over the device time of the sweep's kernels summed over the ranks, so
that work the ranks repeat reads as a lost share.  Each rank reads
``multislice_roofline_pct``'s share against its own kernels' time; the
whole is the reciprocal of the sum of the ranks' reciprocals."""

from pathlib import Path

from benchmark import harness

read = harness.load_reader(Path(__file__).with_name(
    'multislice_roofline_pct.py'))


def combine(values):
    if any(v is None or v <= 0 for v in values):
        return None
    return 1.0 / sum(1.0 / v for v in values)
