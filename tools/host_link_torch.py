"""The host side of one CUDA card, for sizing out-of-core runs.

    python tools/host_link_torch.py [--sizes-gb 1,2,4] [--reps 3]

Prints the card's name and power limit (as ``nvidia-smi`` gives them), the
card count, ``MemTotal`` and ``MemAvailable`` from ``/proc/meminfo``, then:

- the pinned host<->device copy rate for each block size, host to device,
  device to host, and both at once (one copy each way on two streams), by
  CUDA events around ``reps`` copies after a warmup;
- what a pinned block costs the host: the growth of the process's RSS and
  the drop of ``MemAvailable`` when ``torch.empty(..., pin_memory=True)``
  allocates it (PyTorch's caching host allocator may round a block up),
  beside the same for a plain block registered with ``cudaHostRegister``,
  and that block's copy rate.

The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch


def meminfo():
    out = {}
    with open('/proc/meminfo') as f:
        for line in f:
            k, v = line.split(':')
            if k in ('MemTotal', 'MemAvailable'):
                out[k] = int(v.split()[0]) * 1024
    return out


def rss_bytes():
    import os
    with open('/proc/self/statm') as f:
        return int(f.read().split()[1]) * os.sysconf('SC_PAGE_SIZE')


def rate(fn, nbytes, reps):
    """GB/s of ``fn`` (which queues copies of ``nbytes`` in all) by CUDA
    events, after one warmup call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return nbytes * reps / (start.elapsed_time(end) * 1e-3) / 1e9


def copy_rates(host_a, host_b, reps):
    """Host to device, device to host and both at once, in GB/s."""
    n = host_a.numel()
    dev_a = torch.empty(n, dtype=torch.uint8, device='cuda')
    dev_b = torch.empty(n, dtype=torch.uint8, device='cuda')
    s_up, s_down = torch.cuda.Stream(), torch.cuda.Stream()
    cur = torch.cuda.current_stream()

    def both():
        s_up.wait_stream(cur)
        s_down.wait_stream(cur)
        with torch.cuda.stream(s_up):
            dev_a.copy_(host_a, non_blocking=True)
        with torch.cuda.stream(s_down):
            host_b.copy_(dev_b, non_blocking=True)
        cur.wait_stream(s_up)
        cur.wait_stream(s_down)

    out = {'h2d': rate(lambda: dev_a.copy_(host_a, non_blocking=True), n,
                       reps),
           'd2h': rate(lambda: host_b.copy_(dev_b, non_blocking=True), n,
                       reps),
           'both': rate(both, 2 * n, reps)}
    del dev_a, dev_b
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--sizes-gb', default='1,2,4')
    ap.add_argument('--reps', type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {'card': smi, 'count': torch.cuda.device_count(),
           'meminfo': meminfo(), 'pinned': {}, 'registered': {}}
    print(smi)
    print(f"cards {res['count']}; MemTotal {res['meminfo']['MemTotal']} B, "
          f"MemAvailable {res['meminfo']['MemAvailable']} B")
    torch.cuda.init()
    for gb in (float(s) for s in args.sizes_gb.split(',')):
        n = int(gb * 1e9)
        r0, a0 = rss_bytes(), meminfo()['MemAvailable']
        host_a = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        r1, a1 = rss_bytes(), meminfo()['MemAvailable']
        host_b = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        rates = copy_rates(host_a, host_b, args.reps)
        rates.update(asked=n, rss_growth=r1 - r0, avail_drop=a0 - a1)
        res['pinned'][gb] = rates
        print(f'pinned {gb:g} GB: h2d {rates["h2d"]:.2f} GB/s, d2h '
              f'{rates["d2h"]:.2f}, both at once {rates["both"]:.2f}; '
              f'one block of {n} B grew RSS by {r1 - r0} B and took '
              f'{a0 - a1} B of MemAvailable')
        del host_a, host_b
        torch.cuda.synchronize()
        getattr(torch._C, '_host_emptyCache', lambda: None)()
        # The same block as plain memory registered with cudaHostRegister.
        cudart = torch.cuda.cudart()
        r0, a0 = rss_bytes(), meminfo()['MemAvailable']
        blocks = []
        for _ in range(2):
            t = torch.zeros(n, dtype=torch.uint8)
            err = cudart.cudaHostRegister(t.data_ptr(), n, 0)
            if int(err) != 0:
                raise RuntimeError(f'cudaHostRegister failed: {err}')
            blocks.append(t)
        r1, a1 = rss_bytes(), meminfo()['MemAvailable']
        rates = copy_rates(blocks[0], blocks[1], args.reps)
        rates.update(asked=2 * n, rss_growth=r1 - r0, avail_drop=a0 - a1,
                     is_pinned=bool(blocks[0].is_pinned()))
        res['registered'][gb] = rates
        print(f'registered {gb:g} GB: h2d {rates["h2d"]:.2f} GB/s, d2h '
              f'{rates["d2h"]:.2f}, both {rates["both"]:.2f}; two blocks '
              f'of {n} B grew RSS by {r1 - r0} B, MemAvailable by '
              f'{a0 - a1} B; is_pinned {rates["is_pinned"]}')
        for t in blocks:
            cudart.cudaHostUnregister(t.data_ptr())
        del blocks
    print(json.dumps(res))


if __name__ == '__main__':
    main()
