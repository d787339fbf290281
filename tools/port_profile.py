"""Where the time goes in the PyTorch port, on one CUDA card.

    python3 tools/port_profile.py

Simulation: for the paper-grid cell (TT on big_switch(8, 1.25)) and the
datacenter cell (TT at 64-way parallelism on a 256-machine fat-tree, as in
chip_smoke.py), and for tcp and appaware (solver="waterfill"): a warm-up
30 s simulation (60 ticks), a timed one, and one under torch.profiler.

Serving: zamba2-1.2b at full width (bf16, random weights from a seed), one
wave of chip_smoke.py's serving run: the prefill of 4 × 512 tokens, and 8
decode steps of 4 tokens, each warmed up, timed and profiled the same way.

Prints per unit (tick, prefill, decode step) the wall time of the timed
run, the summed device time of all device activities in the profiled run,
the device's idle share (1 − device/wall), and the kernels that take most
device time. Imports no JAX; needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

SECONDS, DT = 30.0, 0.5


def _cells():
    from repro_torch.net import big_switch, fat_tree
    from repro_torch.streams import (compile_sim, parallelize, round_robin,
                                     trending_topics)

    g = parallelize(trending_topics(), seed=0)
    yield "paper TT@1.25", compile_sim(g, big_switch(8, 1.25),
                                       round_robin(g, 8))
    g = parallelize(trending_topics(parallelism=64, n_wct=128,
                                    tweets_per_sec=38400.0), seed=0)
    topo = fat_tree(n_racks=16, machines_per_rack=16, n_cores=4, up=1.875,
                    internal=7.5)
    yield "datacenter", compile_sim(g, topo, round_robin(g, topo.n_machines))


def _report(label: str, fn, n_units: int, unit: str) -> None:
    """Warm up, time and profile ``fn`` (``n_units`` units of work)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n_units
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0) / n_units
    # device activities only (kernels, copies, fills): the CPU-side aten ops
    # that launched them carry the same device time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels)
    busy_ms = 1e-3 * busy_us / n_units
    print(f"\n{label}: wall {wall_ms:.3f} ms/{unit} ({prof_ms:.3f} "
          f"profiled), device {busy_ms:.3f} ms/{unit}, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {n_launch / n_units:.1f} device "
          f"activities/{unit}")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:8]:
        print(f"  {e.self_device_time_total / busy_us:6.1%} "
              f"{1e-3 * e.self_device_time_total / n_units:8.4f} "
              f"ms/{unit} x{e.count / n_units:6.1f}  {e.key[:90]}")


def _serve(n_decode: int = 8) -> None:
    import numpy as np
    import torch

    from repro_torch.models.registry import get_config, get_model

    B, S, max_len = 4, 512, 544
    api = get_model(get_config("zamba2-1.2b"))
    model = api.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, api.cfg.vocab, (B, S)), dtype=torch.long, device="cuda")
    _report("zamba2-1.2b serving [4 x 512 tokens] prefill",
            lambda: api.prefill(model, {"tokens": toks}, max_len), 1,
            "wave")
    _, cache = api.prefill(model, {"tokens": toks}, max_len)
    nxt = toks[:, -1:]

    def decode():
        for i in range(n_decode):
            api.decode(model, cache, nxt, S + i)
    _report("zamba2-1.2b serving [4 x 512 tokens] decode", decode,
            n_decode, "step")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.streams import simulate

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    n_ticks = int(SECONDS / DT)
    for cell, sim in _cells():
        F, L = sim.R.shape
        for policy, solver in (("tcp", "sort"), ("appaware", "waterfill")):
            _report(f"{cell} [{F} flows x {L} links] {policy}/{solver}",
                    lambda: simulate(sim, policy, seconds=SECONDS, dt=DT,
                                     solver=solver), n_ticks, "tick")
    _serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())
