#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. device: the card's name and power limit (``nvidia-smi``), its PyTorch
   name and the device count; no CUDA device means exit 1;
2. build: compiles every kernel from ``src/repro_torch/kernels`` with nvcc
   (``sm_90a``), one nvcc per source, all started together, and prints
   each source's build time and, per kernel function, ptxas's registers,
   shared memory and spills;
3. kernel vs plain version on the card, in the shared-row and the dense
   layout, at the allocator benchmark's shape (10⁴ links × 10³ flows), at
   the datacenter scenario's (640 links × 12,417 flows) and on 64 links
   whose ~3,700 flows overflow the kernel's on-chip list (so the branch
   that walks device memory runs): max |Δ| ≤ 1e-4·max(cap) and every
   masked row sums to its capacity (rtol 1e-3); prints the kernel's time
   (device time from a CUDA graph of 20 calls, and eager calls timed with
   CUDA events), the plain version's (CUDA events) and the kernel's bound
   on this card;
4. paper grid: TT and TI on ``big_switch(8, c)`` at the paper's three
   capacities, 600 s, tcp and appaware (``solver="waterfill"``): appaware
   beats tcp in every cell, throughput is within 1% of the JAX reference's
   values, and each appaware run launches the kernel 120 times;
5. datacenter scenario: TT at 64-way parallelism on a 256-machine fat-tree,
   600 s, tcp and appaware (``"waterfill"`` and ``"sort"``): finite metrics,
   appaware beats tcp, the two solvers agree within 2%. This appaware
   ``"waterfill"`` run is the main-path run whose kernel launches are
   reported;
6. what the LM path's kernels compiled to: ``cuobjdump -sass`` counts
   HGMMA (wgmma) instructions per function; every flash kernel (bf16 and
   float32, split-TF32) and the SSD chunk kernel must issue them;
7. those kernels vs their plain versions on the card, at zamba2-1.2b's
   serving shapes (flash: B 4, H = K = 32, S = T = 512, hd 64, float32 and
   bfloat16; SSD chunk: BH 4·64, 4 chunks of 128, P 64, N 64), plus GQA
   (H 8, K 2 float32; H 32, K 8 bfloat16), hd 128 (both), a ragged S
   (300, float32 and bfloat16) and mamba2-370m's N = 128: max |Δ| ≤ 2e-5
   (flash float32), 2e-2 (flash bfloat16), 1e-4 (SSD), the JAX tests' own
   tolerances; prints each kernel's time (as in phase 3), its plain
   version's, SDPA's for flash (a CUDA graph too), and the bound (float32
   work at the split-TF32 rate, three tf32 products per float32 product;
   the CUDA-core figure of earlier runs beside it);
8. serving zamba2-1.2b at full width (random weights from a fixed
   ``torch.Generator`` seed, on the card, bfloat16): ``ServeEngine`` with 4
   slots serves 8 requests of 512 prompt tokens (numpy, seeded) and 32 new
   tokens each. This is the LM path's main-path run: every logit is
   finite, every request gets 32 tokens, and flash attention launches
   exactly 12 times (6 shared-block applications per wave) and the SSD
   chunk kernel 76 times (38 Mamba2 layers per wave). Prints prefill ms per
   wave and decode ms per step (each timed apart from the served run), the
   served run's own decode ms per step, tokens/s and peak device memory.
   Then zamba2-1.2b at full width cut to 7 layers (one group and a 1-layer
   tail), float32, B 2, S 256, runs on the card (kernels) and on the CPU
   (plain versions) from the same weights: prefill logits and 4 decode
   steps agree within 1e-5·max|logits|.

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
PEAK_BF16_S = 989e12      # dense, on the tensor cores
PEAK_TF32_S = 495e12      # dense, on the tensor cores
# float32-accurate products on the tensor cores take three tf32 products
# (split-TF32: lo·hi + hi·lo + hi·hi)
SPLIT_TF32 = 3

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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in a CUDA
    graph, the graph replayed and timed with CUDA events, divided by
    ``reps``. Unlike :func:`event_ms` it leaves out the host's cost of
    issuing each call, which the card hides when other work is queued, as
    on the serving path."""
    import torch

    fn()                                   # build, allocate, warm up
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return event_ms(graph.replay, reps=5, warmup=1) / reps


def waterfill_bound_ms(mask, kind01, dense: bool) -> tuple[float, str]:
    """Least time for one waterfill call on this card: bytes (mask read and
    output written once, the flow rows' masked entries (dense) or the flow
    rows (shared), capacity and kind read once) over the memory rate
    against the operations the data needs (~5 flops per masked downlink
    pair per bisection round and for the mass pass, ~10 per masked pair
    for the reductions and the emit) over the fp32 rate."""
    L, F = mask.shape
    nnz = float(mask.sum())
    flow_elems = 3 * (nnz if dense else F)
    n_bytes = 4 * (2 * L * F + flow_elems + 2 * L)
    nnz_down = float(mask[kind01 == 1].sum())
    from repro_torch.kernels.waterfill.ref import N_BISECT
    ops = 5 * (N_BISECT + 1) * nnz_down + 10 * nnz
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_name(mangled: str) -> str:
    """``flash_bf16_kernel<64>`` from an Itanium-mangled kernel name: the
    length-prefixed identifier that ends in ``_kernel``, and the integer
    template argument after it."""
    import re

    i = 0
    while i < len(mangled):
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        if j == i:
            i += 1
            continue
        ident = mangled[j:j + int(mangled[i:j])]
        i = j + len(ident)
        if ident.endswith("_kernel"):
            arg = re.match(r"ILi(\d+)E", mangled[i:])
            return ident + (f"<{arg.group(1)}>" if arg else "")
    return mangled


def print_build(label: str, info: dict) -> None:
    """The build time and, per kernel function, ptxas's registers, shared
    memory and spills."""
    print(f"build: {label} in {info['seconds']:.2f} s")
    name = spill = "?"
    for ln in info["ptxas"].splitlines():
        if "Compiling entry function" in ln:
            name = kernel_name(ln.split("'")[1])
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            print(f"build:   {name}: {ln.split(':', 1)[1].strip()}; {spill}")


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
        call = (lambda: fn(*flow, mask, cap, kind01, dt=WATERFILL_DT))
        ms = graph_ms(call)
        eager_ms = event_ms(call, reps=50)
        plain_ms = event_ms(lambda: waterfill_plain(
            *flow, mask, cap, kind01, WATERFILL_DT), reps=5, warmup=1)
        bound_ms, bound_by = waterfill_bound_ms(mask, kind01,
                                                layout == "dense")
        print(f"kernel {name} [{L}x{F}] {layout}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e}), row-sum rel err {row_err:.3e}, "
              f"kernel {ms:.4f} ms (eager calls {eager_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms, "
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
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    sources = {"waterfill": ops.SOURCE, fa_ops.NAME: fa_ops.SOURCE,
               ssd_ops.NAME: ssd_ops.SOURCE}
    for name in sources:
        (build.BUILD_DIR / f"lib{name}.so").unlink(missing_ok=True)
    t0 = time.perf_counter()
    build.build_all(sources)
    print(f"build: {len(sources)} kernels in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, src in sources.items():
        print_build(src.name, build.BUILD_INFO[name])
    ops._lib()

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
    # rows past the kernel's on-chip list: ~3,700 of 12,417 flows on every
    # link, so every row takes the branch that walks device memory
    rng = np.random.default_rng(1)
    n_l = 64
    R_big = (rng.random((12_417, n_l)) < 0.3).astype(np.float32)
    big = kernel_inputs(R_big, rng.uniform(1.0, 50.0, n_l).astype(np.float32),
                        np.arange(n_l, dtype=np.int32) % 3, 1, dev)
    check(bool(ops.streamed_rows(big[3]).all()),
          "streamed case: every row exceeds the list budget")
    results["streamed"] = phase_kernel("streamed", big)

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

    # ---- 6. what the LM path's kernels compiled to (built in phase 2) --
    phase_sass([build.BUILD_DIR / f"lib{n}.so"
                for n in (fa_ops.NAME, ssd_ops.NAME)])

    # ---- 7. LM kernels vs plain versions --------------------------------
    flash = phase_flash(dev)
    ssd = phase_ssd(dev)

    # ---- 8. serve zamba2-1.2b at full width (the LM main-path run) ------
    launches = phase_serve(dev)
    phase_numeric_7layer(dev)

    for name, src, rep, res, lib_ms in (
            ("flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:78", flash,
             flash["library_ms"]),
            ("ssd_chunk", "src/repro_torch/kernels/ssd_scan/csrc/ssd_chunk.cu",
             "src/repro/kernels/ssd_scan/kernel.py:54", ssd, None)):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": lib_ms})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


# ---- the LM serving path (phases 7-8) ------------------------------------
SERVE_B, SERVE_S, SERVE_NEW, SERVE_REQS = 4, 512, 32, 8
# card vs CPU on the 7-layer f32 model, relative to max|logits|: float32
# sums in another order measured ~3e-7, so this leaves ~30x room and still
# catches a kernel that rounds its float32 operands to bfloat16
NUMERIC_RTOL = 1e-5


def bound(n_bytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bound_ms(B, S, T, H, K, hd, dtype, causal=True):
    """q, k, v read and o written once; 4·hd flops per (query, key) pair
    that the mask keeps (two products): bf16 at the bf16 rate, float32 as
    split-TF32 (three tf32 products each). Returns (ms, what binds, the
    float32 bound at the CUDA-core rate that earlier runs reported)."""
    import torch

    size = 2 if dtype == torch.bfloat16 else 4
    n_bytes = size * (2 * B * S * H * hd + 2 * B * T * K * hd)
    pairs = (sum(min(i + 1, T) for i in range(S)) if causal else S * T)
    ops = 4 * hd * B * H * pairs
    if dtype == torch.bfloat16:
        return (*bound(n_bytes, ops, PEAK_BF16_S), None)
    return (*bound(n_bytes, SPLIT_TF32 * ops, PEAK_TF32_S),
            bound(n_bytes, ops, PEAK_F32_S)[0])


def ssd_bound_ms(BH, nc, Q, P, N, Bsz):
    """x, dt, B, C, A read and y, states, cum written once (float32); the
    three products on the causal triangle (C·Bᵀ over Q(Q+1)/2 pairs once per
    batch row and chunk, since its heads share B and C; M·x over the same
    pairs and the state over all Q rows per head), as split-TF32. Returns
    (ms, what binds, the bound at the CUDA-core float32 rate with C·Bᵀ per
    head, as earlier runs reported it)."""
    n_bytes = 4 * (2 * BH * nc * Q * P + 2 * BH * nc * Q
                   + 2 * Bsz * nc * Q * N + BH + BH * nc * P * N)
    tri = Q * (Q + 1) // 2
    ops = Bsz * nc * 2 * tri * N + BH * nc * (2 * tri * P + 2 * Q * P * N)
    ops_per_head = BH * nc * (2 * tri * N + 2 * tri * P + 2 * Q * P * N)
    return (*bound(n_bytes, SPLIT_TF32 * ops, PEAK_TF32_S),
            bound(n_bytes, ops_per_head, PEAK_F32_S)[0])


# the LM path's kernels, each of which must issue HGMMA (phase 6)
TENSOR_CORE_KERNELS = ("flash_bf16_kernel", "flash_f32_kernel",
                       "ssd_chunk_kernel")


def phase_sass(libs) -> None:
    """``cuobjdump -sass``: every flash kernel (bf16, and float32 as
    split-TF32) and the SSD chunk kernel issue HGMMA (wgmma)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("sass: cuobjdump not found; HGMMA not checked")
        return
    counts, name = {}, None
    for lib in libs:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        for ln in sass.splitlines():
            if "Function :" in ln:
                name = kernel_name(ln.split("Function :")[1].strip())
                counts[name] = 0
            elif name and "HGMMA" in ln:
                counts[name] += 1
    print("sass: HGMMA instructions per function: " + ", ".join(
        f"{k} {v}" for k, v in sorted(counts.items())))
    for prefix in TENSOR_CORE_KERNELS:
        found = [k for k in counts if k.startswith(prefix)]
        check(bool(found), f"sass: no {prefix} in the libraries")
        for k in found:
            check(counts[k] > 0, f"sass: {k} issues no HGMMA")


def phase_flash(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_plain

    g = torch.Generator(device=dev).manual_seed(0)
    worst, timed = 0.0, {}
    for label, (B, S, H, K, hd), dtype, tol in (
            ("serving f32", (SERVE_B, SERVE_S, 32, 32, 64), torch.float32,
             2e-5),
            ("serving bf16", (SERVE_B, SERVE_S, 32, 32, 64), torch.bfloat16,
             2e-2),
            ("GQA H8/K2", (SERVE_B, SERVE_S, 8, 2, 64), torch.float32, 2e-5),
            ("ragged S300", (2, 300, 8, 2, 64), torch.float32, 2e-5),
            ("hd128 f32", (SERVE_B, SERVE_S, 16, 16, 128), torch.float32,
             2e-5),
            # the bf16 kernel (tensor cores, TMA) at serving width
            ("GQA H32/K8 bf16", (SERVE_B, SERVE_S, 32, 8, 64), torch.bfloat16,
             2e-2),
            ("hd128 bf16", (SERVE_B, SERVE_S, 16, 16, 128), torch.bfloat16,
             2e-2),
            ("ragged S300 bf16", (SERVE_B, 300, 32, 32, 64), torch.bfloat16,
             2e-2)):
        q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
        k = torch.randn(B, S, K, hd, generator=g, device=dev).to(dtype)
        v = torch.randn(B, S, K, hd, generator=g, device=dev).to(dtype)
        out = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        plain = attention_plain(qt, kt, vt, True).transpose(1, 2)
        err = float((out.float() - plain.float()).abs().max())
        check(bool(torch.isfinite(out).all()), f"flash {label}: finite")
        check(err <= tol, f"flash {label}: max|Δ| {err} > {tol}")
        worst = max(worst, err)
        call = (lambda: fa.flash_attention(q, k, v, causal=True))
        ms = graph_ms(call)
        eager_ms = event_ms(call, reps=20)
        plain_ms = event_ms(lambda: attention_plain(qt, kt, vt, True),
                            reps=5, warmup=1)
        bound_ms, bound_by, cuda_core_ms = flash_bound_ms(B, S, S, H, K, hd,
                                                          dtype)
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=H != K))
        print(f"kernel flash_attention {label} [B{B} S{S} H{H} K{K} hd{hd} "
              f"{str(dtype)[6:]}]: max_abs_err {err:.3e} (tol {tol:g}), "
              f"kernel {ms:.4f} ms (eager calls {eager_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), bound/kernel "
              f"{bound_ms / ms:.4f}, kernel/SDPA {ms / lib_ms:.3f}"
              + ("" if cuda_core_ms is None else
                 f"; bound at the CUDA-core float32 rate {cuda_core_ms:.4f}"
                 f" ms, bound/kernel {cuda_core_ms / ms:.4f}"))
        if label == "serving bf16":
            timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms)
    return dict(timed, max_abs_err=worst)


def phase_ssd(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_plain

    rng = np.random.default_rng(0)
    worst, timed = 0.0, {}
    # zamba2-1.2b: 64 SSD heads of 64, N 64; mamba2-370m: 32 heads, N 128
    for label, (Bsz, H, nc, Q, P, N) in (
            ("zamba2 N64", (SERVE_B, 64, SERVE_S // 128, 128, 64, 64)),
            ("mamba2 N128", (SERVE_B, 32, SERVE_S // 128, 128, 64, 128))):
        BH = Bsz * H

        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=dev)
        args = (t(rng.standard_normal((BH, nc, Q, P)) * 0.5),
                t(rng.uniform(0.01, 0.2, (BH, nc, Q, 1))),
                t(rng.standard_normal((Bsz, nc, Q, N)) * 0.5),
                t(rng.standard_normal((Bsz, nc, Q, N)) * 0.5),
                t(-rng.uniform(0.5, 2.0, (BH, 1))))
        got = ssd.ssd_chunk(*args)
        torch.cuda.synchronize()
        want = ssd_chunk_plain(*args)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        check(all(bool(torch.isfinite(a).all()) for a in got),
              f"ssd {label}: finite")
        check(err <= 1e-4, f"ssd {label}: max|Δ| {err} > 1e-4")
        worst = max(worst, err)
        ms = graph_ms(lambda: ssd.ssd_chunk(*args))
        eager_ms = event_ms(lambda: ssd.ssd_chunk(*args), reps=20)
        plain_ms = event_ms(lambda: ssd_chunk_plain(*args), reps=5,
                            warmup=1)
        bound_ms, bound_by, cuda_core_ms = ssd_bound_ms(BH, nc, Q, P, N,
                                                        Bsz)
        print(f"kernel ssd_chunk {label} [BH{BH} nc{nc} Q{Q} P{P} N{N}]: "
              f"max_abs_err {err:.3e} (tol 1e-4), kernel {ms:.4f} ms "
              f"(eager calls {eager_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"bound/kernel {bound_ms / ms:.4f}; bound at the CUDA-core "
              f"float32 rate {cuda_core_ms:.4f} ms, bound/kernel "
              f"{cuda_core_ms / ms:.4f}")
        if label == "zamba2 N64":
            timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
    return dict(timed, max_abs_err=worst)


def phase_serve(dev) -> dict:
    """zamba2-1.2b at full width through ServeEngine; returns the kernel
    launches of this run."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("zamba2-1.2b")
    api = get_model(cfg, device=dev)
    t0 = time.perf_counter()
    model = api.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"serve: zamba2-1.2b, {api.count_params():,} parameters, "
          f"{str(cfg.dtype)[6:]}, initialised on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (SERVE_REQS, SERVE_S)).astype(
        np.int32)
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def sampler(logits):
        finite.logical_and_(torch.isfinite(logits).all())
        return torch.argmax(logits, -1)
    eng = ServeEngine(api, max_len=SERVE_S + SERVE_NEW,
                      batch_slots=SERVE_B, sampler=sampler)
    eng.load(model)
    reqs = [Request(prompt=p, max_new_tokens=SERVE_NEW) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = ssd.LAUNCHES = 0
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.LAUNCHES, "ssd_chunk": ssd.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(r.out) for r in reqs)
    print(f"serve: {SERVE_REQS} requests x {SERVE_S} prompt tokens, "
          f"{SERVE_NEW} new each, {SERVE_B} slots: {wall:.3f} s wall, "
          f"{n_tok} tokens, {n_tok / wall:.2f} generated tokens/s, "
          f"{SERVE_REQS * (SERVE_S + SERVE_NEW) / wall:.1f} tokens/s "
          f"prompt+generated; launches flash {launches['flash_attention']}, "
          f"ssd_chunk {launches['ssd_chunk']}; peak device memory "
          f"{peak / 2**30:.3f} GiB")
    check(all(len(r.out) == SERVE_NEW for r in reqs),
          f"serve: every request got {SERVE_NEW} tokens")
    check(bool(finite), "serve: every logit finite")
    n_waves = SERVE_REQS // SERVE_B
    groups = cfg.n_layers // cfg.hybrid_attn_every
    check(launches["flash_attention"] == n_waves * groups,
          f"serve: flash launches {launches['flash_attention']} != "
          f"{n_waves * groups}")
    check(launches["ssd_chunk"] == n_waves * cfg.n_layers,
          f"serve: ssd_chunk launches {launches['ssd_chunk']} != "
          f"{n_waves * cfg.n_layers}")

    # per-phase device times for one wave (outside the counted run)
    toks = torch.as_tensor(prompts[:SERVE_B], dtype=torch.long, device=dev)
    prefill_ms = event_ms(lambda: api.prefill(model, {"tokens": toks},
                                              SERVE_S + SERVE_NEW),
                          reps=3, warmup=1)
    _, cache = api.prefill(model, {"tokens": toks}, SERVE_S + SERVE_NEW)
    nxt = toks[:, -1:]
    pos = [SERVE_S]

    def step():
        api.decode(model, cache, nxt, pos[0])
        pos[0] += 1
    decode_ms = event_ms(step, reps=SERVE_NEW - 8, warmup=4)
    steps = n_waves * (SERVE_NEW - 1)
    served_decode_ms = (wall * 1e3 - n_waves * prefill_ms) / steps
    print(f"serve: prefill {prefill_ms:.3f} ms per wave of "
          f"{SERVE_B}x{SERVE_S}; decode {decode_ms:.3f} ms per step of "
          f"{SERVE_B} tokens ({SERVE_B * 1e3 / decode_ms:.1f} tokens/s), "
          f"both timed apart from the served run")
    print(f"serve: the served run's decode, (wall - {n_waves} x prefill) / "
          f"{steps} steps: {served_decode_ms:.3f} ms per step")
    del model, cache, eng
    torch.cuda.empty_cache()
    return launches


def phase_numeric_7layer(dev) -> None:
    """zamba2-1.2b at full width cut to 7 layers, float32: the card
    (kernels) against the CPU (plain versions), same weights."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import lm
    from repro_torch.models.registry import get_config, get_model

    cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=7,
                              dtype=torch.float32)
    api = get_model(cfg, device=dev)
    model = api.init(torch.Generator(device=dev).manual_seed(1))
    cpu_model = copy.deepcopy(model).cpu()
    rng = np.random.default_rng(1)
    B, S, steps = 2, 256, 4
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S + steps)),
                           dtype=torch.long)
    t0 = time.perf_counter()
    lg, cache = lm.prefill(cfg, model, toks[:, :S].to(dev), S + steps)
    lc, ccache = lm.prefill(cfg, cpu_model, toks[:, :S], S + steps)
    pairs = [(lg.cpu(), lc)]
    for i in range(S, S + steps):
        lg, cache = lm.decode_step(cfg, model, cache, toks[:, i:i + 1].to(dev),
                                   i)
        lc, ccache = lm.decode_step(cfg, cpu_model, ccache, toks[:, i:i + 1],
                                    i)
        pairs.append((lg.cpu(), lc))
    for n, (a, b) in enumerate(pairs):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        what = "prefill" if n == 0 else f"decode step {n}"
        check(bool(torch.isfinite(a).all()), f"7-layer {what}: finite")
        check(err <= NUMERIC_RTOL * scale, f"7-layer {what}: max|Δ| {err} > "
                                           f"{NUMERIC_RTOL} x {scale}")
        print(f"numeric: zamba2-1.2b full width, 7 layers, f32, B{B} S{S}, "
              f"{what}: card vs CPU max|Δ| {err:.3e} (max|logit| "
              f"{scale:.3e}, tol {NUMERIC_RTOL}x)")
    print(f"numeric: done in {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    sys.exit(main())
