"""The multislice sweep's share of its roofline: the least time of the
traced angles' forward and adjoint sweeps at the cell's shapes
(``work/multislice.py``, against the card's peaks in ``peaks.json``) over
the device time of the kernels that compute them.  Those kernels are
matched by the regular expressions in every ``*.txt`` file of this
metric's folder (one a line; ``#`` starts a comment), so a form of the
sweep under another kernel name adds a file there."""

import re


def patterns(folder):
    out = []
    for f in sorted(folder.glob('*.txt')):
        for line in f.read_text().splitlines():
            line = line.split('#', 1)[0].strip()
            if line:
                out.append(re.compile(line))
    return out


def kernel_ns(device_ops, pats):
    return sum(ns for name, ns in device_ops.items()
               if any(p.search(name) for p in pats))


def read(ctx):
    s = ctx.summary
    if s is None or ctx.peaks is None or not ctx.n_angles:
        return None
    ns = kernel_ns(s.device_ops, patterns(ctx.folder))
    if ns <= 0:
        return None
    work = ctx.work.multislice.angle_work(ctx.config, ctx.traffic)
    bound, _ = ctx.work.multislice.bound_seconds(work, ctx.peaks)
    return 100.0 * bound * ctx.n_angles / (ns / 1e9)
