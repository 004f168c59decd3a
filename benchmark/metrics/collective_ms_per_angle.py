"""Device time an angle of the collectives' kernels in a rank's traced
epoch (NCCL's: the halo's ring shifts, the sums over the mesh, the flags
of the window), the kernels matched by the regular expressions in every
``*.txt`` file of this metric's folder (one a line; ``#`` starts a
comment).  A rank's kernel runs while it waits for its peers, so the time
holds the exchange and any imbalance between the ranks; the ranks'
readings are averaged.  None where the trace holds no such kernel."""

import re


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.n_angles:
        return None
    pats = []
    for f in sorted(ctx.folder.glob('*.txt')):
        for line in f.read_text().splitlines():
            line = line.split('#', 1)[0].strip()
            if line:
                pats.append(re.compile(line))
    ns = sum(v for name, v in s.device_ops.items()
             if any(p.search(name) for p in pats))
    if ns <= 0:
        return None
    return ns / 1e6 / ctx.n_angles
