"""In-run network dynamics demo on the PyTorch port: a mid-run link failure
and recovery, TCP vs the paper's app-aware allocator.

Links 0-3 drop to 10% capacity at t=50s and recover at t=70s — *inside*
one simulation run (a `LinkSchedule`, evaluated per tick). The interesting
regime is the transient: how deep does throughput dip, how fast does each
policy recover, and who ends up better off after the event.

    PYTHONPATH=src python examples/port_dynamic_failure.py [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.net import big_switch, link_failure_schedule
from repro_torch.streams import (
    compile_sim,
    parallelize,
    round_robin,
    simulate,
    trending_topics,
)

T_FAIL, T_RECOVER = 50.0, 70.0
SECONDS = 120.0


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    g = parallelize(trending_topics(), seed=0)
    topo = big_switch(8, 1.25)
    sched = link_failure_schedule(topo, [0, 1, 2, 3], t_fail=T_FAIL,
                                  t_recover=T_RECOVER, degrade=0.1)
    sim = compile_sim(g, topo, round_robin(g, 8), schedule=sched, device=dev)

    print(f"{'policy':10s} {'tput t/s':>9s} {'post-event':>11s} "
          f"{'dip':>6s} {'recovery s':>11s}")
    out = {}
    for policy in ("tcp", "appaware"):
        r = simulate(sim, policy, seconds=SECONDS, dt=0.5, device=dev)
        i = int(T_FAIL / r.dt)
        post = float(r.sink_mb[i:].mean() / r.dt * r.tuples_per_mb)
        row = (r.throughput_tps, post, r.dip_depth(T_FAIL),
               r.recovery_time_s(T_FAIL))
        print(f"{policy:10s} {row[0]:9.1f} {row[1]:11.1f} "
              f"{row[2]:6.2f} {row[3]:11.1f}")
        out[policy] = row
    return out


if __name__ == "__main__":
    main()
