"""Paper reproduction demo (§VI) on the PyTorch port: both test
applications, both bottleneck settings, TCP vs App-aware — the core result
of the paper in one script.

    PYTHONPATH=src python examples/port_stream_allocator_demo.py [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.net import LinkKind, big_switch, fat_tree
from repro_torch.streams import (
    compile_sim,
    parallelize,
    round_robin,
    simulate,
    trending_topics,
    trucking_iot,
)

CAPS = {"10Mbps": 1.25, "15Mbps": 1.875, "20Mbps": 2.5}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    for setting, topo_fn in (
        ("single-hop (up/downlink bottleneck)", lambda c: big_switch(8, c)),
        ("multi-hop (fat-tree, throttled internals)",
         lambda c: fat_tree(up=12.5).set_capacity(LinkKind.INTERNAL, c)),
    ):
        print(f"=== {setting} ===")
        for app_name, mk in (("TT", trending_topics), ("TI", trucking_iot)):
            for cap_name, cap in CAPS.items():
                topo = topo_fn(cap)
                g = parallelize(mk(), seed=0)
                sim = compile_sim(g, topo, round_robin(g, topo.n_machines),
                                  device=dev)
                tcp = simulate(sim, "tcp", seconds=600.0, device=dev)
                aa = simulate(sim, "appaware", seconds=600.0, device=dev)
                dthpt = (aa.throughput_tps / tcp.throughput_tps - 1) * 100
                dlat = (1 - aa.avg_latency_s / tcp.avg_latency_s) * 100
                print(f"  {app_name} @{cap_name:7s}: "
                      f"throughput {tcp.throughput_tps:7.1f} -> "
                      f"{aa.throughput_tps:7.1f} t/s ({dthpt:+5.1f}%)   "
                      f"latency {tcp.avg_latency_s:6.1f} -> "
                      f"{aa.avg_latency_s:6.1f}s ({dlat:+5.1f}%)")


if __name__ == "__main__":
    main()
