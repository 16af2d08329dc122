"""Port of repro/configs/paper_urdma.py: the paper's own experiment
configuration (section 4, Preliminary Evaluation).

Two servers, NVIDIA ConnectX-5 Ex RNICs back-to-back. 5 million sequential
16 B inlined RDMA writes; each write targets a 4 KB memory region drawn from
a discrete Zipfian distribution with skew 0.5; region count swept 1..2^20.
RTT measured: post write -> observe 32-bit response locally.

These constants drive ``core/simulator.py``. The latency constants live in
``core/types.LatencyModel``; they and ``FIG3_CLAIMS`` are the paper's
microseconds, model constants, not times of any device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PaperWorkload:
    n_writes: int = 5_000_000        # paper: 5M sequential writes
    write_bytes: int = 16            # 16 B inlined
    region_bytes: int = 4096         # 4 KB regions
    zipf_skew: float = 0.5           # discrete Zipfian, 0.5 skew
    region_counts: Tuple[int, ...] = tuple(4 ** i for i in range(11))  # 1..2^20
    adaptive_top_k: int = 4096       # hint policy: offload top-4096 regions

    # evaluation-scale knobs (the steady-state average does not need all
    # 5M writes)
    sim_writes: int = 200_000
    sim_warmup: int = 20_000


PAPER_WORKLOAD = PaperWorkload()

# Paper Fig. 3 claims the simulator is validated against (us, the paper's):
FIG3_CLAIMS = {
    "offload_rtt_1_region": 2.6,     # ~2.6 us with 1 region (all MTT hits)
    "offload_rtt_2e20_regions": 5.1,  # ~5.1 us at 2^20 regions (mostly misses)
    "unload_rtt_flat": 3.4,          # ~3.4 us, ~flat across region counts
    "unload_rtt_2e20_regions": 3.5,  # ~3.5 us at 2^20
    "improvement_at_2e20": 0.31,     # ~31% latency improvement
}
