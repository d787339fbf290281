"""Streaming campaign demo on the PyTorch port: a 2048-scenario
capacity-grid × failure-axis study with bounded memory — no trajectory
array is ever held.

Builds `campaign_fleet(2048)` — {TT, TI} × the paper's {10, 15, 20 Mbps}
grid × {static, in-run link failure, in-run diurnal cycle}, each scenario
jittered by a seeded rng — and streams it through
`FleetRunner.run_campaign`: the bucket plan is computed over the whole
campaign, scenarios flow through fixed-shape chunks packed into rotating
host slots, chunk k+1's host-to-device copy is issued on a transfer worker
while chunk k runs, and only the on-device metric epilogue's [rows, 7]
summary comes back. Host staging stays ≤ 3 chunk slots and device
residency ≤ 2 in-flight chunks however large the campaign — `last_stats`
prints the evidence.

The per-axis table below is pure `CampaignResult` column math: group the
[N, 7] metric matrix by the generator's (app, capacity, kind) axes and
aggregate.

    PYTHONPATH=src python examples/port_campaign_sweep.py [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.streams import FleetRunner, campaign_fleet, compile_fleet

N = 2048
SECONDS = 120.0
POLICY = "tcp"


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    scenarios = campaign_fleet(N, seed=0)
    sims = compile_fleet(scenarios, device="cpu")
    runner = FleetRunner(device=dev)
    print(f"campaign: {N} scenarios, policy={POLICY}, "
          f"{SECONDS:.0f}s horizon (streaming, metrics-only)\n")

    t0 = time.time()
    cr = runner.run_campaign(sims, POLICY, seconds=SECONDS)
    wall = time.time() - t0
    st = runner.last_stats

    # ---- per-axis summary straight off the [N, 7] metric matrix ----
    # scenario names encode the axes: "<app>_<kind><k>"; capacity cycles
    # with the generator's index, so recover it the same way
    caps_cycle = ("10Mbps", "15Mbps", "20Mbps")
    axis = [(s.name.split("_")[0],                       # app
             caps_cycle[(k // 2) % 3],                   # capacity
             s.name.split("_")[1].rstrip("0123456789"))  # kind
            for k, s in enumerate(scenarios)]

    def table(title, key_of):
        groups: dict[str, list[int]] = {}
        for i, key in enumerate(map(key_of, axis)):
            groups.setdefault(key, []).append(i)
        print(f"{title:16s} {'n':>5s} {'tput t/s':>9s} {'lat s':>7s} "
              f"{'util':>6s} {'dip':>6s} {'rec s':>7s}")
        for key in sorted(groups):
            idx = np.asarray(groups[key])
            rec = cr.recovery_time_s[idx]
            rec_med = float(np.median(rec[np.isfinite(rec)])) \
                if np.isfinite(rec).any() else float("inf")
            print(f"{key:16s} {len(idx):5d} "
                  f"{cr.throughput_tps[idx].mean():9.1f} "
                  f"{cr.avg_latency_s[idx].mean():7.2f} "
                  f"{cr.utilization[idx].mean():6.3f} "
                  f"{cr.dip_depth[idx].mean():6.3f} {rec_med:7.1f}")
        print()

    table("by app", lambda a: a[0])
    table("by capacity", lambda a: a[1])
    table("by schedule", lambda a: a[2])
    table("app x kind", lambda a: f"{a[0]}/{a[2]}")

    # ---- the memory story ----
    print(f"wall: {wall:.1f}s total ({N / wall:.0f} scenarios/s), "
          f"{st['n_chunks']} chunks over {st['n_buckets']} buckets")
    print(f"host staging: peak {st['peak_staged_rows']} rows "
          f"({st['peak_staged_bytes'] / 1e6:.1f} MB) — rotating-slot "
          f"bound 3 x {st['chunk_rows']} rows x {st['n_streams']} "
          f"stream(s), independent of N")
    print(f"staging overlap: {st['overlap_fraction']:.0%} of "
          f"{st['stage_s']:.2f}s staging hidden behind device compute; "
          f"metric fetches blocked {st['block_s']:.2f}s")
    print(f"H2D prefetch: {st['transfer_s']:.2f}s of copies on the "
          f"transfer worker, {st['transfer_overlap']:.0%} overlapped "
          f"(dispatch thread waited {st['transfer_wait_s']:.2f}s)")
    held = cr.metrics.nbytes + cr.tuples_per_mb.nbytes
    print(f"retained per campaign: {held / 1e3:.0f} kB of metrics "
          f"({N} x {cr.metrics.shape[1]} floats) — no [T, ...] "
          f"trajectory was transferred or kept "
          f"(results={cr.results!r})")


if __name__ == "__main__":
    main()
