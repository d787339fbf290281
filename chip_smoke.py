#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. device: the card's name and power limit (``nvidia-smi``), its PyTorch
   name and the device count; no CUDA device means exit 1;
2. build: compiles the waterfill kernel from ``src/repro_torch/kernels``
   with nvcc (``sm_90a``) and prints the build time and ptxas's register and
   shared-memory report;
3. kernel vs plain version on the card, in the shared-row and the dense
   layout, at the allocator benchmark's shape (10⁴ links × 10³ flows) and
   at the datacenter scenario's (640 links × 12,417 flows): max |Δ| ≤
   1e-4·max(cap) and every masked row sums to its capacity (rtol 1e-3);
   prints the kernel's and the plain version's times (CUDA events) and the
   kernel's bound on this card;
4. paper grid: TT and TI on ``big_switch(8, c)`` at the paper's three
   capacities, 600 s, tcp and appaware (``solver="waterfill"``): appaware
   beats tcp in every cell, throughput is within 1% of the JAX reference's
   values, and each appaware run launches the kernel 120 times;
5. datacenter scenario: TT at 64-way parallelism on a 256-machine fat-tree,
   600 s, tcp and appaware (``"waterfill"`` and ``"sort"``): finite metrics,
   appaware beats tcp, the two solvers agree within 2%. This appaware
   ``"waterfill"`` run is the main-path run whose kernel launches are
   reported.

Before its last line the script prints one JSON object describing each
kernel, then the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# JAX reference (repro.streams.simulate, 600 s, dt 0.5, big_switch(8, c)):
# throughput in tuples/s, tcp -> appaware; the same with the Pallas and
# the sort solver
GOLDEN_TPS = {
    ("TT", 1.25): (48.1, 61.2), ("TT", 1.875): (72.2, 92.8),
    ("TT", 2.5): (96.3, 120.0),
    ("TI", 1.25): (57.7, 75.0), ("TI", 1.875): (86.5, 112.5),
    ("TI", 2.5): (115.4, 150.0),
}
GOLDEN_RTOL = 0.01
WATERFILL_DT = 5.0   # the allocator's interval: upd_every 10 × dt 0.5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def waterfill_bound_ms(mask, kind01, dense: bool) -> tuple[float, str]:
    """Least time for one waterfill call on this card: bytes (mask read and
    output written once, the flow rows, capacity and kind read once) over
    the memory rate against the operations the data needs (~5 flops per
    masked downlink pair per bisection round and for the mass pass, ~10
    per masked pair for the reductions and the emit) over the fp32 rate."""
    L, F = mask.shape
    flow_elems = 3 * (L * F if dense else F)
    n_bytes = 4 * (2 * L * F + flow_elems + 2 * L)
    nnz = float(mask.sum())
    nnz_down = float(mask[kind01 == 1].sum())
    from repro_torch.kernels.waterfill.ref import N_BISECT
    ops = 5 * (N_BISECT + 1) * nnz_down + 10 * nnz
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bench_problem(rng, L: int, F: int):
    """The allocator benchmark's random program (benchmarks/allocator.py):
    each flow crosses 4 links; kinds 40/40/20 up/down/internal."""
    import numpy as np

    R = np.zeros((F, L), np.float32)
    for f in range(F):
        R[f, rng.choice(L, size=min(4, L), replace=False)] = 1.0
    kind = rng.choice([0, 1, 2], size=L, p=[0.4, 0.4, 0.2]).astype(np.int32)
    cap = rng.uniform(1.0, 50.0, L).astype(np.float32)
    return R, cap, kind


def kernel_inputs(R, cap, kind, seed: int, dev):
    """Waterfill inputs as ``allocate(solver="waterfill")`` builds them, from
    a random flow state (five [F] vectors, uniform 0..10, from ``seed``)."""
    import numpy as np
    import torch

    from repro_torch.core.flowstate import flowstate_from_numpy

    rng = np.random.default_rng(seed)
    F = R.shape[0]
    st = flowstate_from_numpy([rng.uniform(0, 10, F) for _ in range(5)],
                              dev)
    R = torch.as_tensor(R, dtype=torch.float32, device=dev)
    mask = (R.T > 0).to(torch.float32).contiguous()
    kind01 = (torch.as_tensor(kind, device=dev) == 1).to(torch.int32)
    return (st.uplink_demand().contiguous(), st.lr_t1.contiguous(),
            st.drain_rate(WATERFILL_DT).contiguous(), mask,
            torch.as_tensor(cap, dtype=torch.float32, device=dev), kind01)


def phase_kernel(name, args) -> dict:
    import torch

    from repro_torch.kernels.waterfill import ops
    from repro_torch.kernels.waterfill.ref import waterfill_plain

    w, b, r, mask, cap, kind01 = args
    L, F = mask.shape
    dense = [v.expand(L, F).contiguous() for v in (w, b, r)]
    tol = 1e-4 * float(cap.max())
    has = mask.sum(1) > 0
    res = {}
    for layout, fn, flow in (("shared", ops.waterfill_flows, (w, b, r)),
                             ("dense", ops.waterfill, dense)):
        out = fn(*flow, mask, cap, kind01, dt=WATERFILL_DT)
        torch.cuda.synchronize()
        plain = waterfill_plain(*flow, mask, cap, kind01, WATERFILL_DT)
        err = float((out - plain).abs().max())
        rows = out.sum(1)
        row_err = float(((rows - cap).abs() / cap)[has].max())
        check(bool(torch.isfinite(out).all()), f"{name} {layout}: finite")
        check(err <= tol, f"{name} {layout}: max|Δ| {err} > {tol}")
        check(row_err <= 1e-3, f"{name} {layout}: row sums off cap by "
                               f"{row_err} (rtol 1e-3)")
        ms = event_ms(lambda: fn(*flow, mask, cap, kind01,
                                 dt=WATERFILL_DT), reps=50)
        plain_ms = event_ms(lambda: waterfill_plain(
            *flow, mask, cap, kind01, WATERFILL_DT), reps=5, warmup=1)
        bound_ms, bound_by = waterfill_bound_ms(mask, kind01,
                                                layout == "dense")
        print(f"kernel {name} [{L}x{F}] {layout}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e}), row-sum rel err {row_err:.3e}, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), "
              f"bound/kernel {bound_ms / ms:.4f}")
        res[layout] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
    return res


def run_sim(sim, policy, solver, dev):
    """One 600 s run; returns the result and its wall time (the result's
    host copies synchronise the card)."""
    import numpy as np
    import torch

    from repro_torch.streams import simulate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = simulate(sim, policy, seconds=600.0, solver=solver, device=dev)
    wall = time.perf_counter() - t0
    check(bool(np.isfinite(r.metrics).all()),
          f"{policy}/{solver}: metrics finite ({r.metrics})")
    return r, wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.kernels.waterfill import ops
    from repro_torch.net import big_switch, fat_tree
    from repro_torch.streams import (
        compile_sim, parallelize, round_robin, trending_topics, trucking_iot)

    # ---- 1. device ------------------------------------------------------
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {smi} | torch: {kind} | count {count} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda:0")

    # ---- 2. build -------------------------------------------------------
    (build.BUILD_DIR / "libwaterfill.so").unlink(missing_ok=True)
    ops._lib()
    info = build.BUILD_INFO["waterfill"]
    usage = [ln.strip() for ln in info["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: waterfill.cu in {info['seconds']:.2f} s; "
          + " | ".join(usage))

    # ---- 3. kernel vs plain ---------------------------------------------
    results = {}
    R, cap, knd = bench_problem(np.random.default_rng(0), 10_000, 1_000)
    results["bench"] = phase_kernel("bench",
                                    kernel_inputs(R, cap, knd, 0, dev))
    g_dc = parallelize(trending_topics(parallelism=64, n_wct=128,
                                       tweets_per_sec=38400.0), seed=0)
    topo_dc = fat_tree(n_racks=16, machines_per_rack=16, n_cores=4,
                       up=1.875, internal=7.5)
    sim_dc = compile_sim(g_dc, topo_dc, round_robin(g_dc, topo_dc.n_machines),
                         device=dev)
    results["datacenter"] = phase_kernel(
        "datacenter",
        kernel_inputs(sim_dc.R.cpu().numpy(), topo_dc.capacities,
                      topo_dc.link_kinds, 0, dev))

    # ---- 4. paper grid --------------------------------------------------
    for app, mk in (("TT", trending_topics), ("TI", trucking_iot)):
        g = parallelize(mk(), seed=0)
        for c in (1.25, 1.875, 2.5):
            sim = compile_sim(g, big_switch(8, c), round_robin(g, 8),
                              device=dev)
            tcp, w_tcp = run_sim(sim, "tcp", "sort", dev)
            before = ops.LAUNCHES
            aa, w_aa = run_sim(sim, "appaware", "waterfill", dev)
            launched = ops.LAUNCHES - before
            g_tcp, g_aa = GOLDEN_TPS[(app, c)]
            print(f"grid {app} @{c}: tcp {tcp.throughput_tps:.3f} "
                  f"(golden {g_tcp}, {w_tcp:.2f} s) -> appaware "
                  f"{aa.throughput_tps:.3f} (golden {g_aa}, {w_aa:.2f} s), "
                  f"waterfill launches {launched}")
            check(aa.throughput_tps > tcp.throughput_tps,
                  f"grid {app}@{c}: appaware beats tcp")
            check(abs(tcp.throughput_tps / g_tcp - 1) <= GOLDEN_RTOL,
                  f"grid {app}@{c}: tcp within 1% of the reference")
            check(abs(aa.throughput_tps / g_aa - 1) <= GOLDEN_RTOL,
                  f"grid {app}@{c}: appaware within 1% of the reference")
            check(launched == 120, f"grid {app}@{c}: 120 launches, got "
                                   f"{launched}")

    # ---- 5. datacenter scenario (the main-path run) ---------------------
    F, L = sim_dc.R.shape
    n_ticks = int(round(600.0 / 0.5))
    torch.cuda.reset_peak_memory_stats()
    dc = {}
    for policy, solver in (("tcp", "sort"), ("appaware", "waterfill"),
                           ("appaware", "sort")):
        ops.LAUNCHES = 0
        r, wall = run_sim(sim_dc, policy, solver, dev)
        dc[(policy, solver)] = (r, wall, ops.LAUNCHES)
        print(f"datacenter [{F} flows x {L} links] {policy}/{solver}: "
              f"{r.throughput_tps:.3f} tuples/s, {wall:.2f} s wall, "
              f"{n_ticks / wall:.1f} ticks/s, latency "
              f"{r.avg_latency_s:.3f} s, waterfill launches {ops.LAUNCHES}")
    print(f"datacenter peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    tcp = dc[("tcp", "sort")][0]
    aw, _, main_launches = dc[("appaware", "waterfill")]
    asrt = dc[("appaware", "sort")][0]
    check(aw.throughput_tps > tcp.throughput_tps,
          "datacenter: appaware beats tcp")
    rel = abs(aw.throughput_tps / asrt.throughput_tps - 1)
    check(rel <= 0.02, f"datacenter: waterfill vs sort within 2% ({rel})")
    check(main_launches > 0, "datacenter: the main path launched waterfill")
    check(dc[("appaware", "sort")][2] == 0 and dc[("tcp", "sort")][2] == 0,
          "datacenter: sort/tcp runs never launch waterfill")

    main = results["datacenter"]["shared"]
    kernels = [{
        "name": "waterfill",
        "route": "cuda",
        "source": "src/repro_torch/kernels/waterfill/csrc/waterfill.cu",
        "replaces": "src/repro/kernels/waterfill/kernel.py:111",
        "launches": main_launches,
        "max_abs_err": max(v["max_abs_err"] for shape in results.values()
                           for v in shape.values()),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
