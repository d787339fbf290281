"""The paper's own 'architecture': the stream-analytics testbed (§VI-A).

Not an LM — this config describes the cluster + workloads used by the
reproduction runs: 10 machines (8 workers), a 1 GbE SDN switch
(big-switch model) and the fat-tree testbed (Fig. 2), the TT/TI apps, the
10/15/20 Mbps bottleneck settings, 600 s runs, Δt = 5 s. It registers no
model, so the architecture registry never lists it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StreamTestbedConfig:
    n_workers: int = 8
    caps_mbps: tuple = (10, 15, 20)
    mb_per_s: tuple = (1.25, 1.875, 2.5)
    seconds: float = 600.0
    dt: float = 0.5           # fluid tick
    alloc_interval_s: float = 5.0
    sample_hz: float = 1.0
    # fat-tree testbed (Fig. 2): 4 racks × 2 machines, 2 cores
    n_racks: int = 4
    machines_per_rack: int = 2
    n_cores: int = 2


def config() -> StreamTestbedConfig:
    return StreamTestbedConfig()
