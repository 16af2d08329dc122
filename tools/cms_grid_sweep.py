#!/usr/bin/env python3
"""Grid shapes of the fused CMS monitor step (``cms_update_query``,
``src/repro_torch/kernels/csrc/cms.cu``) on one GPU.

For each case (the write engine's sketch at its batch of 4096 ids with the
decay off, configured and quiet, firing, and masked; and 2^20 ids) it
checks every (blocks, threads) of ``GRIDS`` exactly against the plain
version, then times it: device time from the profiler's trace and the time
between CUDA events, by ``chip_smoke.py``'s functions. A grid of one block
is one block of 1024 threads with ``__syncthreads`` for its barriers; the
others are one cluster. K5 then K6, and the monitor step as ``CMSMonitor``
takes it without the fused kernel (``update`` then ``query``), are timed
on the same inputs.

    python3 tools/cms_grid_sweep.py

Run from the root of a checkout; needs a CUDA device and ``nvcc``.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import CMSMonitor, MonitorState  # noqa: E402
from repro_torch.kernels import (build, cms_query, cms_update,  # noqa: E402
                                 cms_update_query_ref)
from repro_torch.kernels.cms import fused_grid  # noqa: E402

GRIDS = [(1, 1024), (8, 512), (16, 128), (16, 256), (16, 512), (16, 1024)]
# (depth, k, n, total_in, decay_every, masked)
CASES = [(4, 16, 4096, 0, 0, False), (4, 16, 4096, 0, 65536, False),
         (4, 16, 4096, 8191, 8192, False), (4, 16, 4096, 0, 65536, True),
         (4, 12, 1 << 20, 0, 0, False), (4, 16, 1 << 20, 0, 0, False),
         (4, 16, 1 << 20, 0, 0, True)]


def launch(lib, counts, total, ids, decay, blocks, threads, mask):
    n = ids.numel()
    total_out = torch.empty((), dtype=torch.int64, device=cs.DEV)
    est = torch.empty((n,), dtype=torch.int32, device=cs.DEV)
    err = lib.cms_update_query_launch(
        counts.data_ptr(), total.data_ptr(), total_out.data_ptr(),
        ids.data_ptr(), ids.element_size(),
        0 if mask is None else mask.data_ptr(), est.data_ptr(), n,
        counts.shape[0], counts.shape[1].bit_length() - 1, decay, blocks,
        threads, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch {blocks}x{threads}: CUDA error {err}")
    return counts, total_out, est


def main():
    print(cs.phase_env(), flush=True)
    cs.phase_build()
    lib = build.load_library()
    gen = torch.Generator(device=cs.DEV).manual_seed(7)
    out = {}
    for depth, k, n, t_in, decay, masked in CASES:
        counts = torch.randint(0, 100, (depth, 1 << k), generator=gen,
                               device=cs.DEV, dtype=torch.int32)
        ids = torch.randint(0, 1 << 20, (n,), generator=gen, device=cs.DEV)
        total = torch.tensor(t_in, dtype=torch.int64, device=cs.DEV)
        mask = ((torch.rand((n,), generator=gen, device=cs.DEV) > 0.3)
                if masked else None)
        case = (f"counts[{depth},{1 << k}] n={n} decay_every={decay} "
                f"total_in={t_in} masked={masked}")
        want = cms_update_query_ref(counts, total, ids, mask, decay)
        row = {"wrapper_grid": list(fused_grid(n))}
        for b, t in GRIDS:
            got = launch(lib, counts.clone(), total, ids, decay, b, t, mask)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{case} {b}x{t}: differs from the "
                                     f"plain version")
            c = counts.clone()

            def run():
                return launch(lib, c, total, ids, decay, b, t, mask)
            row[f"{b}x{t}"] = dict(ms=cs.device_ms(run, f"{case} {b}x{t}"),
                                   event_ms=cs.time_ms(run))
        c = counts.clone()
        row["K5 then K6"] = dict(ms=cs.device_ms(
            lambda: (cms_update(c, ids, mask), cms_query(c, ids)),
            f"{case} K5 then K6"))
        mon = CMSMonitor(depth=depth, log2_width=k, decay_every=decay)
        st = MonitorState(c, total)
        row["update then query"] = dict(ms=cs.device_ms(
            lambda: mon.query(mon.update(st, ids, mask), ids),
            f"{case} update then query"))
        out[case] = row
        print(json.dumps({case: row}), flush=True)
    print(json.dumps(dict(grid_sweep=out,
                          traces_without_device_time=cs.TRACE_MISSES)))


if __name__ == "__main__":
    main()
