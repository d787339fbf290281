"""Fleet simulation demo on the PyTorch port: a capacity × workload
parameter sweep through one `FleetRunner` per study.

Builds the paper's §VI grid — {TT, TI} × {10, 15, 20 Mbps} × {single-hop,
multi-hop} — as 12 scenarios and runs TCP and App-aware across the whole
grid: the runner plans shape buckets, stacks each bucket's scenarios on
the device and drives every bucket's tick loop together. The second
(warm) sweep reuses the staged packs, so it shows what a repeat study
costs. Compare `port_stream_allocator_demo.py`, which walks the same grid
one scenario at a time.

    PYTHONPATH=src python examples/port_fleet_sweep.py [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.device import resolve_device
from repro_torch.streams import FleetRunner, capacity_sweep, compile_fleet

SECONDS = 600.0


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    scenarios = capacity_sweep(multihop=False) + capacity_sweep(multihop=True)
    # scenario state on the host; the runner copies each bucket's pack to
    # the device once
    sims = compile_fleet(scenarios, device="cpu")
    runner = FleetRunner(device=dev)
    print(f"fleet: {len(sims)} scenarios "
          f"(one runner, every bucket's tick loop driven together)\n")

    t0 = time.time()
    tcp = runner.run(sims, "tcp", seconds=SECONDS)
    tcp_stats = dict(runner.last_stats)
    aa = runner.run(sims, "appaware", seconds=SECONDS)
    aa_stats = dict(runner.last_stats)
    cold = time.time() - t0

    # warm repeat: staging reused — a parameter re-study pays execution only
    t0 = time.time()
    runner.run(sims, "tcp", seconds=SECONDS)
    runner.run(sims, "appaware", seconds=SECONDS)
    warm = time.time() - t0

    print(f"{'scenario':28s} {'tcp t/s':>9s} {'appaware t/s':>13s} {'Δ%':>7s}")
    for sc, r_tcp, r_aa in zip(scenarios, tcp, aa):
        gain = (r_aa.throughput_tps / max(r_tcp.throughput_tps, 1e-9) - 1) * 100
        print(f"{sc.name:28s} {r_tcp.throughput_tps:9.1f} "
              f"{r_aa.throughput_tps:13.1f} {gain:+6.1f}%")
    print(f"\nwhole sweep (both policies, {SECONDS:.0f}s runs): "
          f"{cold:.1f}s cold (staging included), {warm:.2f}s warm repeat")
    for name, st in (("tcp", tcp_stats), ("appaware", aa_stats)):
        print(f"  {name}: {st['n_dispatches']} dispatch(es), "
              f"{st['n_buckets']} shape bucket(s), padded rows {st['rows']}")
    per_scen = warm / 2 / len(sims) * 1e3
    print(f"  warm cost: {per_scen:.1f} ms/scenario/policy")


if __name__ == "__main__":
    main()
