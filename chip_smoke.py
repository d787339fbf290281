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
   (300, float32 and bfloat16), yi-6b's prefill launch (H 32, K 4, hd 128,
   bfloat16), the prefill launches of phases 14-17 (qwen3-moe H 64 over
   K 4 at hd 128, dbrx H 48 over K 8, internvl2 S 768 with H 14 over K 2,
   whisper's non-causal encoder at S = T = 1,500 and cross-attention at
   S 4, T 1,500, all bfloat16), mamba2-370m's N = 128, and both kernels at
   phase 18's train-step launches (flash B 2, S = T = 4,096, H 32, hd 64,
   bfloat16; SSD chunk BH 2·64, 32 chunks of 128, P 64, N 64), where the
   forward plus the autograd backward (the plain version's vjp) is timed
   too: max |Δ| ≤ 2e-5
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
9. fleet: ``bench_fleet()`` (44 scenarios) through ``FleetRunner.run`` on
   the card, 600 s at dt 0.5, for tcp and appaware (``"waterfill"``), and
   appaware (``"sort"``) and appfair at ``FLEET_SHORT_S``: finite metrics,
   appaware beats tcp on the six paper-grid rows, and the waterfill run
   makes exactly one kernel launch per bucket update (this is the fleet's
   main-path run, counts set to 0 just before it). One scenario per bucket
   is held against the per-scenario ``simulate`` on the card at 60 s, at
   the fleet tests' tolerances (sink atol 1e-4, latency rtol 1e-4 atol
   1e-3, link load atol 1e-4). Prints, per policy, wall s per fleet run
   (scenario staging and the pack copies included), scenarios/s, buckets,
   waterfill launches and peak device memory;
10. campaign: ``run_campaign`` over ``campaign_fleet(CAMPAIGN_N)`` (4,096
    scenarios) at ``CAMPAIGN_S`` (60 s: the auto sizing's small chunks make
    600 s too long for this run), appaware through the kernel,
    ``chunk_rows="auto"``: every row finite, one launch per chunk update;
    prints scenarios/s, chunks, the pipeline's timing split and overlap
    fractions, peak staged bytes and peak device memory. The same campaign
    in chunks of ``CAMPAIGN_ROWS`` agrees within 1e-4 relative (batch
    sizes change the card's reduction order). Then ``waterfill_fleet``
    against its plain version at the campaign's chunk shapes (rows × 16
    links × 17 flows; the auto and the large chunks), timed as in phase 3;
    and a 256-scenario campaign equals
    ``FleetRunner.run`` bit for bit at the same padded rows;
11. resilience on the card, on that 256-scenario campaign in chunks of 32:
    a transient transfer fault and a poisoned scenario (a ``FaultPlan``)
    leave every clean row bit for bit equal to the fault-free run and
    quarantine exactly the poisoned scenario; a ``FaultAbort`` kills a
    checkpointed run, and the resumed run (checkpoint in a temporary
    directory) runs only the chunks that were not done and equals the
    fault-free run bit for bit;
12. serving yi-6b at full width, all 32 layers (6,061,035,520 parameters,
    the JAX count), bfloat16, random weights from a fixed seed: the same
    requests, slots and timings as phase 8; every logit finite, every
    request gets 32 tokens, and flash attention launches exactly 64 times
    (32 layers per wave) and the SSD chunk kernel never. This is the dense
    main-path run. Then yi-6b at full width cut to 2 layers, float32, B 2,
    S 128: card (kernels; the float32 flash kernel at hd 128) against CPU
    (plain versions) within 1e-5·max|logits|, as in phase 8;
13. the port's examples on the card: ``port_multiapp_fairness`` (App-Fair's
    Jain ≥ 0.98 for every α, TCP's within 1e-3 of 0.818), the paper's
    oracles (``maxmin_rates``, ``demand_limited_maxmin``,
    ``tcp_app_throughput``, ``AppFairScheduler``) on CUDA tensors against
    ``demand_limited_maxmin_np``, ``port_dynamic_failure`` within 1% of the
    JAX example's throughputs, ``port_serve_decode`` at ``reduced()``,
    ``port_quickstart`` (8 decoded tokens after 50 train steps) and
    ``port_train_lm`` (40 steps, a failure injected at step 25 restarts
    from the step-20 checkpoint, the loss falls);
14. serving qwen3-moe-235b-a22b at full width (d_model 4096, 64 heads over
    4 KV heads of 128, 128 experts of d_ff 1536, top-8, qk-norm, vocab
    151,936) cut to 8 of its 94 layers (21.15B parameters, 42.3 GB of
    bfloat16 weights; the full-width ``count_params`` 235,093,634,560 and
    ``active_params`` 22,190,763,520 are the JAX counts), random weights
    from a fixed seed cast as they are drawn: the same requests, slots and
    timings as phase 8, every logit finite, every request gets 32 tokens,
    exactly 16 flash launches (8 layers per wave) and no SSD launch, and
    the (token, k) slots dropped per wave's prefill. This is the moe
    main-path run. Then one full-width layer in float32, B 1, S 128, built
    on the card and copied to the CPU: every MoE call's top-8 experts
    identical card vs CPU (the smallest gap between the 8th and the 9th
    router probability printed), then the logits within
    1e-5·max|logits|;
15. serving dbrx-132b at full width cut to 2 of its 40 layers (7.75B
    parameters, bfloat16, layernorm, 16 experts top-4): the same requests,
    finite logits, 4 flash launches (G 6 at hd 128);
16. serving internvl2-1b at full width and depth (494,583,808
    parameters, bfloat16): 8 × (256 seeded patch embeddings through
    ``extra_batch`` + 512 prompt tokens), 32 new tokens, 48 flash launches
    at S 768; then 2 layers in float32 card vs CPU within
    1e-5·max|logits|;
17. serving whisper-tiny at full width and depth (36,624,768 parameters,
    bfloat16): 8 × (1,500 seeded frames + a 4-token prompt), 32 new
    tokens, 24 flash launches (per wave 4 non-causal encoder layers, 4
    causal decoder self-attentions, 4 non-causal cross-attentions); then
    the whole model in float32 card vs CPU within 1e-5·max|logits|;
18. training zamba2-1.2b at full width and depth (1,104,937,856 float32
    parameters with AdamW's moments, bfloat16 compute, ``remat`` on)
    through ``TrainDriver`` on ``SyntheticLM(structured=True)``, B 2 x S
    4,096 (the JAX package's train_4k length; its batch of 256 cut to 2 to
    fit one card), ``AdamW(lr=warmup_cosine(3e-4, warmup=2, total=8))``, 8
    steps with async checkpoints every 4 under ``build/``. This is the
    training main-path run: every loss and gradient norm finite, the loss
    on step 0's batch lower after the 8 steps than before (each step's own
    loss is on another batch of two sequences, ~0.1 nats apart), the
    parameters moved, and per step exactly 12
    flash launches (6 shared-block applications, forward and recompute)
    and 76 SSD chunk launches (38 Mamba2 layers, forward and recompute);
    prints the loss, grad norm and wall ms per step, ms per step and
    tokens/s over steps 1-7, peak device memory, and each checkpoint's
    bytes and save seconds. Then a restart from the step-4 checkpoint
    replays steps 4-7 with the first run's losses (within 1e-5 relative;
    whether bit for bit is printed);
19. one float32 train step card (kernels) against CPU (plain versions),
    from the same weights and batch: zamba2-1.2b at full width cut to 7
    layers (one group of 6 and a 1-layer tail), B 2, S 256, through
    ``make_train_step``; one full-width qwen3-moe layer, B 1, S 128, its
    loss and gradients only (AdamW's states of its 15 GB would not fit
    twice), routing identical; whisper-tiny at full width and depth, B 2,
    64 tokens and 1,500 seeded frames (the non-causal kernel under
    autograd). The loss within 1e-5 relative, every gradient leaf within
    1e-4·max|g_leaf|;
20. phase 18's configuration (weights, schedule and batches from the same
    seeds) trained for 2 steps through the sharding policy: a 1x1
    ``DeviceMesh("cuda")`` over a one-rank NCCL world on a free localhost
    port, parameters placed by ``param_shardings`` under ``TRAIN_RULES``,
    batches by ``batch_shardings``, the kernels reached through
    ``local_map``. This is the mesh main-path run: losses equal to phase
    18's steps 0-1 within 1e-6 relative (bit for bit expected: a one-rank
    mesh moves no data), 12 flash and 76 SSD launches a step; prints ms per
    step and peak device memory. Then the meshed checkpoint: the state
    after step 0 was saved (each DTensor gathered whole), is restored onto
    ``param_shardings`` and ``opt_shardings``, and step 1 replayed from it
    gives the first run's loss and new state bit for bit;
    ``TrainDriver.reshard_to`` onto the same shardings returns every leaf
    bit for bit; prints the save and restore seconds and the peak;
21. the comm-schedule path at full width: zamba2-1.2b at d_model 2,048 cut
    to 6 of its 38 layers (one application of the shared block), one train
    step of 8 x 4,096 tokens traced on meta tensors on a dry (4, 2)
    ("data", "model") mesh (8 ranks on the "fake" backend); prints its
    collectives per kind and axis, operand MB and FLOPs per rank (the
    kernels' meta calls counting their plain versions' FLOPs, beside the
    10.323 TFLOP of the record that did not), the flows and MB per axis,
    and ``plan_schedule`` on the card; then the same link problem through
    ``OnlineAllocator(solver="waterfill")`` on the card, held to the sort
    solver's rates at 2e-3 (tests/test_torch_allocator.py's tolerance for
    that pair); collectives on both axes, exactly 432 of them, FLOPs above
    10.323 TFLOP, no LM kernel launched by the meta trace, at least one
    waterfill launch, and a shard-to-shard redistribution on that mesh
    recorded as one all-to-all;
22. the dry run (``repro_torch.launch.dryrun.run_cell``) on "cuda"
    production meshes at full width and depth, into a temporary directory:
    qwen1.5-0.5b ``train_4k`` and yi-6b ``decode_32k`` on the 16x16 mesh
    (256 ranks), mamba2-370m ``long_500k`` on the 2x16x16 mesh (512 ranks),
    dbrx-132b ``train_4k`` on both meshes and internvl2-1b ``train_4k`` on
    the 16x16 one; prints each cell's trace seconds, FLOPs, collectives,
    argument and peak bytes per rank and top three call sites of traffic,
    then the ``dryrun_report`` and ``roofline`` tables; every cell ok with
    FLOPs and collectives, each train cell's kernel FLOPs above 0 and its
    peak within 80 GB, dbrx's FLOPs per rank on 512 ranks at most 0.55 of
    those on 256, no kernel launch;
23. the sharded campaign (the main-path run of ``FleetRunner(shard=...)``):
    phase 11's 256-scenario appaware campaign (the waterfill kernel, 60 s,
    32-row chunks) on one stream and on four streams of the one card
    (``shard=["cuda:0"] * 4``); prints the streams, the waterfill launches
    per stream and scenarios/s of each; the four-stream metrics bit for bit
    the one-stream ones, four streams each launching the kernel, as many
    launches in all as one stream's;
24. a real world of one rank per card (``spawn_world``, NCCL, ``cuda:{rank}``
    for each rank; one rank on a one-card machine), the main-path run of
    the launcher: in each rank zamba2-1.2b at full width cut to 6 of its
    38 layers (one group, one application of the shared attention block,
    as phase 21 cuts it), float32 weights and AdamW states, bfloat16
    compute, phase 18's seed, schedule and batches, placed by
    ``param_shardings`` on ``make_local_mesh()`` ((n, 1)), through
    ``TrainDriver`` for 4 steps with async checkpoints every 2 and a
    failure injected at step 3, which restores step 2's checkpoint and
    replays step 2. Checks the replayed loss bit for bit the first pass's,
    every loss finite, 2 flash and 12 SSD launches a step through
    ``local_map`` (counts set to 0 in the rank just before the run), one
    writer of the checkpoints; prints the world size, ms per step, peak
    device memory and checkpoint seconds. On a machine with two or more
    cards it then holds a (1, n) prefill and two decode steps and an
    (n, 1) train step (float32, the same model) to the unmeshed results of
    that machine's first card; on one card it prints that it did not try
    them.

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

    marks = [time.perf_counter()]

    def lap(phase: str) -> None:
        """Print the seconds since the previous phase ended."""
        marks.append(time.perf_counter())
        print(f"phase {phase} in {marks[-1] - marks[-2]:.2f} s")

    # ---- 1. device ------------------------------------------------------
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {smi} | torch: {kind} | count {count} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda:0")
    lap("1 (device)")

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
    lap("2 (build)")

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
    lap("3 (waterfill vs plain)")

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
    lap("4 (paper grid)")

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
    lap("5 (datacenter)")

    # ---- 6. what the LM path's kernels compiled to (built in phase 2) --
    phase_sass([build.BUILD_DIR / f"lib{n}.so"
                for n in (fa_ops.NAME, ssd_ops.NAME)])
    lap("6 (SASS)")

    # ---- 7. LM kernels vs plain versions --------------------------------
    flash = phase_flash(dev)
    ssd = phase_ssd(dev)
    lap("7 (LM kernels vs plain)")

    # ---- 8. serve zamba2-1.2b at full width (the LM main-path run) ------
    launches = phase_serve(dev)
    phase_numeric(dev, "zamba2-1.2b", n_layers=7, B=2, S=256, seed=1)
    lap("8 (serving)")

    # ---- 9-11. fleet, campaign, resilience ------------------------------
    fleet = phase_fleet(dev)
    lap("9 (fleet)")
    camp = phase_campaign(dev)
    lap("10 (campaign)")
    phase_resilience(dev)
    lap("11 (resilience)")

    # ---- 12. serve yi-6b at full width (the dense main-path run) --------
    yi_launches = phase_serve(dev, "yi-6b", n_params=YI6B_PARAMS)
    lap("12 (serving yi-6b)")
    phase_numeric(dev, "yi-6b", n_layers=2, B=2, S=128, seed=2)
    lap("12b (yi-6b numeric)")

    # ---- 13. the port's examples and the paper's oracles on the card ----
    phase_examples(dev)
    lap("13 (examples)")

    # ---- 14. serve qwen3-moe-235b-a22b at full width (the moe main-path
    # run), 8 of its 94 layers; one full-width layer in float32 ----------
    served = {}
    served["qwen3-moe-235b-a22b"] = phase_serve(
        dev, "qwen3-moe-235b-a22b", n_params=QWEN3_MOE_PARAMS,
        n_layers=QWEN3_MOE_LAYERS, active=QWEN3_MOE_ACTIVE)
    lap("14 (serving qwen3-moe)")
    phase_numeric(dev, "qwen3-moe-235b-a22b", n_layers=1, B=1, S=128, seed=3,
                  routes=True)
    lap("14b (qwen3-moe numeric)")

    # ---- 15. serve dbrx-132b at full width, 2 of its 40 layers ----------
    served["dbrx-132b"] = phase_serve(dev, "dbrx-132b",
                                      n_params=DBRX_PARAMS, n_layers=2)
    lap("15 (serving dbrx)")

    # ---- 16. serve internvl2-1b (vlm) at full width and depth -----------
    served["internvl2-1b"] = phase_serve(dev, "internvl2-1b",
                                         n_params=INTERNVL2_PARAMS)
    phase_numeric(dev, "internvl2-1b", n_layers=2, B=2, S=128, seed=4)
    lap("16 (serving internvl2)")

    # ---- 17. serve whisper-tiny (encdec) at full width and depth --------
    served["whisper-tiny"] = phase_serve(dev, "whisper-tiny",
                                         n_params=WHISPER_PARAMS,
                                         prompt_len=WHISPER_PROMPT)
    phase_numeric(dev, "whisper-tiny", n_layers=None, B=2,
                  S=WHISPER_PROMPT, seed=5)
    lap("17 (serving whisper)")

    # ---- 18. train zamba2-1.2b at full width and depth (the training
    # main-path run) ------------------------------------------------------
    trained = phase_train(dev)
    lap("18 (training zamba2)")

    # ---- 19. one float32 train step, card against CPU -------------------
    phase_train_numeric(dev, "zamba2-1.2b", n_layers=7, B=2, S=256, seed=6)
    phase_train_numeric(dev, "qwen3-moe-235b-a22b", n_layers=1, B=1, S=128,
                        seed=7, routes=True, optimizer=False)
    phase_train_numeric(dev, "whisper-tiny", n_layers=None, B=2, S=64,
                        seed=8)
    lap("19 (train step card vs CPU)")

    # ---- 20. phase 18's training through the sharding policy on a 1x1
    # mesh (the mesh main-path run) ---------------------------------------
    meshed = phase_train_mesh(dev, trained["losses"])
    lap("20 (training zamba2 on a mesh)")

    # ---- 21. the comm-schedule path at full width ------------------------
    comm = phase_comm_schedule(dev)
    lap("21 (comm schedule)")

    # ---- 22. the dry run on production meshes ---------------------------
    dry = phase_dryrun(dev)
    lap("22 (dry run)")

    # ---- 23. the campaign on four streams of the card (the sharded
    # main-path run) ------------------------------------------------------
    sharded = phase_shard(dev)
    lap("23 (sharded campaign)")

    # ---- 24. a real world of one rank per card (the launcher's main-path
    # run) ----------------------------------------------------------------
    world = phase_world()
    lap("24 (spawned world)")

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
        # the fleet's main path (phase 9) and the kernel at a campaign
        # chunk's shape (phase 10)
        "fleet_launches": fleet["launches"],
        "fleet_shape": camp["shape"],
        "fleet_max_abs_err": camp["max_abs_err"],
        "fleet_ms": camp["ms"],
        "fleet_plain_ms": camp["plain_ms"],
        "fleet_bound_ms": camp["bound_ms"],
        "fleet_bound_by": camp["bound_by"],
    }]
    yi6b = flash["yi6b"]
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
    # yi-6b's main path (phase 12) and the kernel at its launch shape
    # (phase 7)
    kernels[1].update({
        "yi6b_launches": yi_launches["flash_attention"],
        "yi6b_shape": yi6b["shape"],
        "yi6b_ms": yi6b["ms"],
        "yi6b_plain_ms": yi6b["plain_ms"],
        "yi6b_bound_ms": yi6b["bound_ms"],
        "yi6b_library_ms": yi6b["library_ms"],
        # phases 14-17's main paths (counts set to 0 just before each) and
        # the kernel at their launch shapes (phase 7)
        "serving_launches": {arch: n["flash_attention"]
                             for arch, n in served.items()},
        "serving_rows": flash["serving"],
    })
    # phase 18's main path (counts set to 0 just before it) and each kernel
    # at its launch shape there (phase 7), with its forward + backward
    for entry, res, name in ((kernels[1], flash, "flash_attention"),
                             (kernels[2], ssd, "ssd_chunk")):
        entry.update({
            "train_launches": trained["launches"][name],
            "train_launches_per_step": trained["per_step"][name],
            **{f"train_{k}": v for k, v in res["train"].items()}})
    # phase 20's main path (counts set to 0 just before it) and phase 21's
    # link problem through the waterfill kernel
    for entry, name in ((kernels[1], "flash_attention"),
                        (kernels[2], "ssd_chunk")):
        entry["mesh_train_launches"] = meshed["launches"][name]
    kernels[0].update({"comm_schedule_launches": comm["launches"],
                       "comm_schedule_max_abs_err": comm["max_abs_err"]})
    # phase 22's main path: meta traces, no launch
    for entry in kernels:
        entry["dryrun_launches"] = dry["launches"][entry["name"]]
    # phase 23's main path (counts set to 0 just before it)
    kernels[0].update({"shard_launches": sharded["launches"],
                       "shard_launches_per_stream": sharded["per_stream"]})
    # phase 24's main path (counts set to 0 in each rank just before it)
    for entry, name in ((kernels[1], "flash_attention"),
                        (kernels[2], "ssd_chunk")):
        entry["world_train_launches"] = world[name]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


# ---- fleet, campaign, resilience (phases 9-11) ---------------------------
FLEET_S = 600.0          # the paper's run length
FLEET_SHORT_S = 120.0    # appaware/sort and appfair
HOLD_S = 60.0            # fleet rows held against simulate
CAMPAIGN_N = 4096
# cut from the paper's 600 s: chunk_rows="auto" lands at its 16-row floor on
# the card (the calibration credits the host-bound solve probe as per-row
# compute), so the campaign runs ~260 chunks of one host tick loop each
CAMPAIGN_S = 60.0
CAMPAIGN_ROWS = 256      # the same campaign in chunks of this many rows
SMALL_N = 256            # the bitwise and resilience campaigns
SMALL_S = 60.0


def timed(fn):
    """``fn()`` and its wall seconds, the card synchronised on both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_fleet(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.waterfill import ops
    from repro_torch.streams import (FleetRunner, bench_fleet, compile_fleet,
                                     simulate)

    # scenario state on the host; the runner copies each bucket's pack to
    # the card once
    sims, build_s = timed(lambda: compile_fleet(bench_fleet(), device="cpu"))
    runner = FleetRunner(device=dev)
    print(f"fleet: bench_fleet {len(sims)} scenarios built in {build_s:.2f} s;"
          f" calibration {runner.tick_overhead:.0f} proxy FLOPs per bucket "
          f"tick")
    runs, launches = {}, {}
    for policy, solver, seconds in (
            ("tcp", "sort", FLEET_S), ("appaware", "waterfill", FLEET_S),
            ("appaware", "sort", FLEET_SHORT_S),
            ("appfair", "sort", FLEET_SHORT_S)):
        torch.cuda.reset_peak_memory_stats()
        ops.LAUNCHES = 0
        res, wall = timed(lambda: runner.run(sims, policy, seconds=seconds,
                                             solver=solver))
        launched = ops.LAUNCHES
        st = runner.last_stats
        n_upd = -(-int(round(seconds / 0.5)) // 10)   # appaware: every 5 s
        print(f"fleet {policy}/{solver} {seconds:.0f} s: {wall:.2f} s wall, "
              f"{len(sims) / wall:.2f} scenarios/s, {st['n_buckets']} buckets "
              f"(rows {st['rows']}), waterfill launches {launched}, peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
              f"MiB")
        for r in res:
            check(bool(np.isfinite(r.metrics[:5]).all()),
                  f"fleet {policy}/{solver}: finite metrics")
        if solver == "waterfill":
            check(launched == st["n_buckets"] * n_upd,
                  f"fleet waterfill: {launched} launches != "
                  f"{st['n_buckets']} buckets x {n_upd} updates")
        else:
            check(launched == 0, f"fleet {policy}/{solver} launched "
                                 f"waterfill")
        runs[(policy, solver)] = res
        launches[(policy, solver)] = launched
    for k in range(6):     # the paper grid: TT and TI at three capacities
        tcp = runs[("tcp", "sort")][k].throughput_tps
        aa = runs[("appaware", "waterfill")][k].throughput_tps
        print(f"fleet grid row {k}: tcp {tcp:.3f} -> appaware {aa:.3f} "
              f"tuples/s")
        check(aa > tcp, f"fleet grid row {k}: appaware beats tcp")
    # one scenario per bucket against the per-scenario simulate on the card
    for policy, solver in (("tcp", "sort"), ("appaware", "waterfill")):
        res = runner.run(sims, policy, seconds=HOLD_S, solver=solver)
        for idxs, _ in runner.plan(sims, policy):
            i = idxs[0]
            ref = simulate(sims[i], policy, seconds=HOLD_S, solver=solver,
                           device=dev)
            r = res[i]
            err = (float(np.abs(r.sink_mb - ref.sink_mb).max()),
                   float(np.abs(r.link_load - ref.link_load).max()))
            print(f"fleet hold {policy}/{solver} scenario {i}: sink max|Δ| "
                  f"{err[0]:.3e}, link load max|Δ| {err[1]:.3e}")
            check(err[0] <= 1e-4 and err[1] <= 1e-4,
                  f"fleet hold {policy} scenario {i}: {err}")
            check(np.allclose(r.latency, ref.latency, rtol=1e-4, atol=1e-3),
                  f"fleet hold {policy} scenario {i}: latency")
    return {"launches": launches[("appaware", "waterfill")]}


def fleet_kernel(dev, sims, rows: int) -> dict:
    """``waterfill_fleet`` against its plain version at a campaign chunk's
    shape: the masks of ``rows`` campaign scenarios of one shape, flow
    state uniform 0..10 from a seed; device time from a CUDA graph of 20
    calls, and the bound (mask read and output written once, [rows, F]
    flow state and [rows, L] capacity and kind read once; operations as in
    phase 3)."""
    import numpy as np
    import torch

    from repro_torch.kernels.waterfill import ops
    from repro_torch.kernels.waterfill.ref import (N_BISECT,
                                                   waterfill_fleet_plain)
    from repro_torch.net.topology import LinkKind

    F0 = sims[0].R.shape[0]
    members = [s for s in sims if s.R.shape[0] == F0][:rows]
    Bn = len(members)
    F, L = members[0].R.shape
    rng = np.random.default_rng(2)
    mask = torch.stack([(s.R.T > 0).to(torch.float32) for s in members]).to(
        dev).contiguous()
    cap = torch.stack([s.caps for s in members]).to(dev).contiguous()
    kind = torch.stack([(s.kinds == int(LinkKind.DOWNLINK)).to(torch.int32)
                        for s in members]).to(dev).contiguous()
    w, bl, rho = (torch.tensor(rng.uniform(lo, 10, (Bn, F)).astype(
        np.float32), device=dev) for lo in (0.0, 0.0, 0.1))
    out = ops.waterfill_fleet(w, bl, rho, mask, cap, kind, dt=WATERFILL_DT)
    torch.cuda.synchronize()
    plain = waterfill_fleet_plain(w, bl, rho, mask, cap, kind, WATERFILL_DT)
    err = float((out - plain).abs().max())
    tol = 1e-4 * float(cap.max())
    check(bool(torch.isfinite(out).all()), "waterfill_fleet: finite")
    check(err <= tol, f"waterfill_fleet: max|Δ| {err} > {tol}")
    call = (lambda: ops.waterfill_fleet(w, bl, rho, mask, cap, kind,
                                        dt=WATERFILL_DT))
    ms = graph_ms(call)
    eager_ms = event_ms(call, reps=50)
    plain_ms = event_ms(lambda: waterfill_fleet_plain(
        w, bl, rho, mask, cap, kind, WATERFILL_DT), reps=5, warmup=1)
    nnz = float(mask.sum())
    nnz_down = float((mask * (kind == 1)[..., None]).sum())
    n_bytes = 4 * (2 * Bn * L * F + 3 * Bn * F + 2 * Bn * L)
    ops_n = 5 * (N_BISECT + 1) * nnz_down + 10 * nnz
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops_n / PEAK_F32_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    shape = f"{Bn}x{L}x{F}"
    print(f"kernel waterfill_fleet [{shape}, {Bn * L} blocks]: max_abs_err "
          f"{err:.3e} (tol {tol:.3e}), kernel {ms:.4f} ms (eager calls "
          f"{eager_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.3e}"
          f" ms ({bound_by}), bound/kernel {bound_ms / ms:.4f}; the bound "
          f"lies below a launch's own latency (a few microseconds)")
    return dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_campaign(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.waterfill import ops
    from repro_torch.streams import FleetRunner, campaign_fleet, compile_fleet

    sims, build_s = timed(lambda: compile_fleet(campaign_fleet(CAMPAIGN_N),
                                                device="cpu"))
    runner = FleetRunner(device=dev)
    torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES = 0
    cr, wall = timed(lambda: runner.run_campaign(
        sims, "appaware", seconds=CAMPAIGN_S, solver="waterfill",
        chunk_rows="auto"))
    st = runner.last_stats
    n_upd = -(-int(round(CAMPAIGN_S / 0.5)) // 10)
    print(f"campaign: campaign_fleet({CAMPAIGN_N}) built in {build_s:.2f} s;"
          f" appaware/waterfill {CAMPAIGN_S:.0f} s: {wall:.2f} s wall, "
          f"{CAMPAIGN_N / wall:.2f} scenarios/s, {st['n_chunks']} chunks in "
          f"{st['n_buckets']} buckets (rows {st['rows']}, auto targets "
          f"{st['target_chunk_rows']}), waterfill launches {ops.LAUNCHES}")
    print("campaign: stage_s {stage_s:.3f}, transfer_s {transfer_s:.3f}, "
          "transfer_wait_s {transfer_wait_s:.3f}, dispatch_s {dispatch_s:.3f},"
          " block_s {block_s:.3f}, wall_s {wall_s:.3f}; overlap_fraction "
          "{overlap_fraction:.3f}, transfer_overlap {transfer_overlap:.3f}; "
          "peak staged {peak_staged_rows} rows, {peak_staged_bytes} bytes"
          .format(**st))
    cal = st["calibration"]
    print(f"campaign: calibration dispatch {cal['dispatch_us']:.1f} us, "
          f"fetch {cal['sync_us']:.1f} us, tick {cal['tick_overhead_us']:.2f}"
          f" us, proxy {cal['proxy_mflops']:.0f} MFLOP/s -> "
          f"{cal['tick_overhead_flops']:.0f} (clamped {cal['clamped']}); "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    check(st["status"] == "ok" and not cr.failures, "campaign: clean run")
    check(bool(np.isfinite(cr.metrics[:, :5]).all()),
          "campaign: finite metrics")
    check(ops.LAUNCHES == st["n_chunks"] * n_upd,
          f"campaign: {ops.LAUNCHES} launches != {st['n_chunks']} chunks x "
          f"{n_upd} updates")
    # the same campaign in large chunks: what the auto sizing costs here
    big, wall_big = timed(lambda: runner.run_campaign(
        sims, "appaware", seconds=CAMPAIGN_S, solver="waterfill",
        chunk_rows=CAMPAIGN_ROWS))
    st_big = runner.last_stats
    same = big.metrics == cr.metrics          # +inf recovery times too
    with np.errstate(invalid="ignore"):
        rel = np.abs(big.metrics - cr.metrics) / np.maximum(
            np.abs(cr.metrics), 1e-6)
    diff = float(np.where(same, 0.0, rel).max())
    print(f"campaign: chunk_rows={CAMPAIGN_ROWS}: {wall_big:.2f} s wall, "
          f"{CAMPAIGN_N / wall_big:.2f} scenarios/s, {st_big['n_chunks']} "
          f"chunks (rows {st_big['rows']}), dispatch_s "
          f"{st_big['dispatch_s']:.3f}, overlap_fraction "
          f"{st_big['overlap_fraction']:.3f}, peak staged "
          f"{st_big['peak_staged_bytes']} bytes; max relative |Δ| against "
          f"the auto-chunked rows {diff:.3e}")
    check(diff <= 1e-4, f"campaign: chunk sizes disagree by {diff}")
    kern = fleet_kernel(dev, sims, max(st["rows"]))
    fleet_kernel(dev, sims, max(st_big["rows"]))
    # the campaign equals FleetRunner.run at the same padded rows: chunks
    # as large as the buckets
    small = sims[:SMALL_N]
    a = runner.run_campaign(small, "appaware", seconds=SMALL_S,
                            solver="waterfill", chunk_rows=SMALL_N)
    rows_c = runner.last_stats["rows"]
    b = runner.run(small, "appaware", seconds=SMALL_S, solver="waterfill")
    check(rows_c == runner.last_stats["rows"],
          f"campaign vs run: rows {rows_c} vs {runner.last_stats['rows']}")
    check(np.array_equal(a.metrics, np.stack([r.metrics for r in b])),
          "campaign vs run: bitwise at the same padded rows")
    print(f"campaign: {SMALL_N}-scenario campaign equals FleetRunner.run bit "
          f"for bit (rows {rows_c})")
    return kern


def phase_shard(dev) -> dict:
    """Phase 11's 256-scenario campaign on one stream, then on four streams
    of the one card: the same bits, each stream launching the waterfill
    kernel on its own compute stream."""
    import numpy as np

    from repro_torch.kernels.waterfill import ops
    from repro_torch.streams import FleetRunner, campaign_fleet, compile_fleet

    sims = compile_fleet(campaign_fleet(SMALL_N), device="cpu")
    runner = FleetRunner(device=dev)
    kw = dict(seconds=SMALL_S, solver="waterfill", chunk_rows=32)
    one, wall_one = timed(lambda: runner.run_campaign(
        sims, "appaware", shard=False, **kw))
    st_one = runner.last_stats
    four_devs = [f"cuda:{dev.index or 0}"] * 4
    ops.LAUNCHES = 0
    ops.STREAM_LAUNCHES.clear()
    four, wall_four = timed(lambda: runner.run_campaign(
        sims, "appaware", shard=four_devs, **kw))
    launches, per_stream = ops.LAUNCHES, sorted(ops.STREAM_LAUNCHES.values())
    st = runner.last_stats
    n_upd = -(-int(round(SMALL_S / 0.5)) // 10)
    print(f"sharded campaign: {SMALL_N} scenarios, {st['n_chunks']} chunks "
          f"of {st['chunk_rows']} rows; one stream {wall_one:.2f} s "
          f"({SMALL_N / wall_one:.2f} scenarios/s); {st['n_streams']} "
          f"streams on {st['devices']} {wall_four:.2f} s "
          f"({SMALL_N / wall_four:.2f} scenarios/s), waterfill launches "
          f"{launches} ({per_stream} per stream), peak staged "
          f"{st['peak_staged_rows']} rows")
    check(st["status"] == "ok" and st_one["n_streams"] == 1
          and st["n_streams"] == 4, "sharded campaign: four streams ran")
    check(np.array_equal(four.metrics, one.metrics),
          "sharded campaign: four streams bit for bit one stream")
    check(len(per_stream) == 4 and min(per_stream) > 0,
          f"sharded campaign: every stream launches waterfill: {per_stream}")
    check(launches == st["n_chunks"] * n_upd,
          f"sharded campaign: {launches} launches != {st['n_chunks']} "
          f"chunks x {n_upd} updates")
    check(st["peak_staged_rows"] <= 3 * st["chunk_rows"] * 4,
          "sharded campaign: staging within three slots a stream")
    return dict(launches=launches, per_stream=per_stream,
                scenarios_s=SMALL_N / wall_four,
                one_stream_scenarios_s=SMALL_N / wall_one)


def phase_resilience(dev) -> None:
    import tempfile

    import numpy as np

    from repro_torch.streams import (FaultAbort, FaultPlan, FaultSpec,
                                     FleetRunner, campaign_fleet,
                                     compile_fleet)

    sims = compile_fleet(campaign_fleet(SMALL_N), device="cpu")
    runner = FleetRunner(device=dev)
    kw = dict(seconds=SMALL_S, solver="waterfill", chunk_rows=32,
              retry_backoff_s=0.001, retry_backoff_cap_s=0.01)
    clean = runner.run_campaign(sims, "appaware", **kw).metrics.copy()
    n_chunks = runner.last_stats["n_chunks"]
    poisoned = SMALL_N // 3
    fp = FaultPlan([FaultSpec("transfer", chunk=1, times=1)],
                   poison={poisoned})
    cr = runner.run_campaign(sims, "appaware", faults=fp, **kw)
    st = runner.last_stats
    ok = np.arange(SMALL_N) != poisoned
    print(f"resilience: {n_chunks} chunks; transfer faults fired "
          f"{fp.n_fired('transfer')}, recovered chunks "
          f"{st['n_recovered_chunks']}, retries {st['n_retries']}, "
          f"quarantined {cr.quarantined.tolist()}")
    check(st["status"] == "ok" and fp.n_fired("transfer") == 1,
          "resilience: the transient fault fired and was retried")
    check(cr.quarantined.tolist() == [poisoned],
          "resilience: exactly the poisoned scenario quarantined")
    check(bool(np.isnan(cr.metrics[poisoned]).all()),
          "resilience: the quarantined row is NaN")
    check(np.array_equal(cr.metrics[ok], clean[ok]),
          "resilience: clean rows bitwise equal to the fault-free run")
    with tempfile.TemporaryDirectory() as ck:
        abort = FaultPlan([FaultSpec("abort", chunk=n_chunks - 1)])
        try:
            runner.run_campaign(sims, "appaware", faults=abort,
                                checkpoint=ck, **kw)
            check(False, "resilience: the abort did not propagate")
        except FaultAbort:
            pass
        killed = runner.last_stats
        check(killed["status"] == "failed", "resilience: failed status")
        done = killed["n_chunks_done"]
        res = runner.run_campaign(sims, "appaware", checkpoint=ck, **kw)
        st = runner.last_stats
    print(f"resilience: killed after {done} of {n_chunks} chunks; resume "
          f"restored {st['n_chunks_resumed']} and ran {st['n_dispatches']}")
    check(0 < done < n_chunks and st["n_chunks_resumed"] == done
          and st["n_dispatches"] == n_chunks - done,
          "resilience: the resume ran only what was not done")
    check(np.array_equal(res.metrics, clean),
          "resilience: resumed rows bitwise equal to the fault-free run")


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


# phase 7's row at yi-6b's prefill launch shape
YI6B_FLASH = "yi-6b GQA H32/K4 hd128 bf16"
# phase 18: zamba2-1.2b trains at full width and depth on B 2 x S 4096 (the
# JAX package's train_4k length; its global batch of 256 cut to 2 to fit
# one card), 8 steps, one checkpoint every 4; phase 7 holds both kernels to
# their plain versions at the train step's launch shapes
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT_EVERY = 2, 4096, 8, 4
TRAIN_FLASH = "zamba2 train B2 S4096 H32 hd64 bf16"
ZAMBA2_PARAMS = 1_104_937_856
# JAX ``get_model(get_config("yi-6b")).count_params()``
YI6B_PARAMS = 6_061_035_520
# JAX ``count_params()`` (and qwen3-moe's ``active_params()``) at full
# width; qwen3-moe is served cut to 8 of its 94 layers (21.15B parameters,
# 42.3 GB of bf16 weights: 235B do not fit one card), dbrx to 2 of its 40
QWEN3_MOE_PARAMS = 235_093_634_560
QWEN3_MOE_ACTIVE = 22_190_763_520
QWEN3_MOE_LAYERS = 8
DBRX_PARAMS = 131_597_021_184
INTERNVL2_PARAMS = 494_583_808
WHISPER_PARAMS = 36_624_768
WHISPER_PROMPT = 4            # decoder prompt tokens beside 1,500 frames
# phase 7's rows at the launch shapes of phases 14-17's prefills: label ->
# the arch whose prefill launches the kernel so
SERVING_FLASH = {
    "qwen3-moe G16 H64/K4 hd128 bf16": "qwen3-moe-235b-a22b",
    "dbrx G6 H48/K8 hd128 bf16": "dbrx-132b",
    "internvl2 G7 S768 H14/K2 hd64 bf16": "internvl2-1b",
    "whisper encoder S=T=1500 bf16": "whisper-tiny",
    "whisper cross S4 T1500 bf16": "whisper-tiny",
}
# phase 7's flash rows: label, (B, S, T, H, K, hd), dtype (by name),
# tolerance (the JAX tests': 2e-5 float32, 2e-2 bfloat16), causal
FLASH_ROWS = (
    ("serving f32", (SERVE_B, SERVE_S, SERVE_S, 32, 32, 64), "float32",
     2e-5, True),
    ("serving bf16", (SERVE_B, SERVE_S, SERVE_S, 32, 32, 64), "bfloat16",
     2e-2, True),
    ("GQA H8/K2", (SERVE_B, SERVE_S, SERVE_S, 8, 2, 64), "float32", 2e-5,
     True),
    ("ragged S300", (2, 300, 300, 8, 2, 64), "float32", 2e-5, True),
    ("hd128 f32", (SERVE_B, SERVE_S, SERVE_S, 16, 16, 128), "float32", 2e-5,
     True),
    # the bf16 kernel (tensor cores, TMA) at serving width
    ("GQA H32/K8 bf16", (SERVE_B, SERVE_S, SERVE_S, 32, 8, 64), "bfloat16",
     2e-2, True),
    ("hd128 bf16", (SERVE_B, SERVE_S, SERVE_S, 16, 16, 128), "bfloat16",
     2e-2, True),
    ("ragged S300 bf16", (SERVE_B, 300, 300, 32, 32, 64), "bfloat16", 2e-2,
     True),
    # yi-6b's prefill launch shape (phase 12): G 8 at hd 128
    (YI6B_FLASH, (SERVE_B, SERVE_S, SERVE_S, 32, 4, 128), "bfloat16", 2e-2,
     True),
    # phases 14-17: qwen3-moe G 16 and dbrx G 6 at hd 128, internvl2's
    # 256 + 512 positions at G 7, whisper's non-causal encoder (1,500 rows,
    # a ragged last tile) and cross-attention (4 decoder tokens)
    ("qwen3-moe G16 H64/K4 hd128 bf16",
     (SERVE_B, SERVE_S, SERVE_S, 64, 4, 128), "bfloat16", 2e-2, True),
    ("dbrx G6 H48/K8 hd128 bf16", (SERVE_B, SERVE_S, SERVE_S, 48, 8, 128),
     "bfloat16", 2e-2, True),
    ("internvl2 G7 S768 H14/K2 hd64 bf16", (SERVE_B, 768, 768, 14, 2, 64),
     "bfloat16", 2e-2, True),
    ("whisper encoder S=T=1500 bf16", (SERVE_B, 1500, 1500, 6, 6, 64),
     "bfloat16", 2e-2, False),
    ("whisper cross S4 T1500 bf16", (SERVE_B, 4, 1500, 6, 6, 64),
     "bfloat16", 2e-2, False),
    # phase 18: zamba2-1.2b's train step (B 2 x S 4096)
    (TRAIN_FLASH, (TRAIN_B, TRAIN_S, TRAIN_S, 32, 32, 64), "bfloat16", 2e-2,
     True),
)


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
    worst, timed, yi6b, serving, train = 0.0, {}, {}, [], {}
    for label, (B, S, T, H, K, hd), dtype, tol, causal in FLASH_ROWS:
        dtype = getattr(torch, dtype)
        q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
        k = torch.randn(B, T, K, hd, generator=g, device=dev).to(dtype)
        v = torch.randn(B, T, K, hd, generator=g, device=dev).to(dtype)
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        plain = attention_plain(qt, kt, vt, causal).transpose(1, 2)
        err = float((out.float() - plain.float()).abs().max())
        check(bool(torch.isfinite(out).all()), f"flash {label}: finite")
        check(err <= tol, f"flash {label}: max|Δ| {err} > {tol}")
        worst = max(worst, err)
        call = (lambda: fa.flash_attention(q, k, v, causal=causal))
        ms = graph_ms(call)
        eager_ms = event_ms(call, reps=20)
        plain_ms = event_ms(lambda: attention_plain(qt, kt, vt, causal),
                            reps=5, warmup=1)
        bound_ms, bound_by, cuda_core_ms = flash_bound_ms(B, S, T, H, K, hd,
                                                          dtype, causal)
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=H != K))
        shape = (f"B{B} S{S} T{T} H{H} K{K} hd{hd} {str(dtype)[6:]}"
                 + ("" if causal else " non-causal"))
        print(f"kernel flash_attention {label} [{shape}]: "
              f"max_abs_err {err:.3e} (tol {tol:g}), "
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
        if label == YI6B_FLASH:
            yi6b = dict(shape=f"B{B} S{S} H{H} K{K} hd{hd} bf16", ms=ms,
                        eager_ms=eager_ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, library_ms=lib_ms)
        if label in SERVING_FLASH:
            serving.append(dict(arch=SERVING_FLASH[label], shape=shape,
                                max_abs_err=err, ms=ms, eager_ms=eager_ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=lib_ms))
        if label == TRAIN_FLASH:
            train = dict(shape=shape, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms,
                         fwd_bwd_ms=fwd_bwd_ms(
                             lambda q, k, v: fa.flash_attention(
                                 q, k, v, causal=causal), (q, k, v)))
            print(f"kernel flash_attention {label}: forward + backward (the "
                  f"plain version's vjp, float32) {train['fwd_bwd_ms']:.4f} "
                  f"ms")
    return dict(timed, max_abs_err=worst, yi6b=yi6b, serving=serving,
                train=train)


def fwd_bwd_ms(fn, inputs) -> float:
    """Device time of ``fn(*inputs)`` and its backward (CUDA events), the
    inputs' gradients taken against a ones cotangent."""
    import torch

    leaves = [t.detach().requires_grad_() for t in inputs]

    def step():
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs])
    return event_ms(step, reps=3, warmup=1)


def phase_ssd(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_plain

    rng = np.random.default_rng(0)
    worst, timed, train = 0.0, {}, {}
    # zamba2-1.2b: 64 SSD heads of 64, N 64; mamba2-370m: 32 heads, N 128;
    # zamba2-1.2b's train step (phase 18): B 2 x S 4096
    for label, (Bsz, H, nc, Q, P, N) in (
            ("zamba2 N64", (SERVE_B, 64, SERVE_S // 128, 128, 64, 64)),
            ("mamba2 N128", (SERVE_B, 32, SERVE_S // 128, 128, 64, 128)),
            ("zamba2 train", (TRAIN_B, 64, TRAIN_S // 128, 128, 64, 64))):
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
        if label == "zamba2 train":
            train = dict(shape=f"BH{BH} nc{nc} Q{Q} P{P} N{N}",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         fwd_bwd_ms=fwd_bwd_ms(ssd.ssd_chunk, args))
            print(f"kernel ssd_chunk {label}: forward + backward (the plain "
                  f"version's vjp) {train['fwd_bwd_ms']:.4f} ms")
    return dict(timed, max_abs_err=worst, train=train)


def serve_extra(cfg, rng, B: int) -> dict:
    """The stub frontends' seeded inputs for ``B`` requests (numpy, float32):
    a vlm's patch embeddings [B, n_vis, D], an encdec model's frame
    embeddings [B, 1500, D]; nothing for the other families."""
    import numpy as np

    from repro_torch.models.registry import WHISPER_FRAMES

    if cfg.family == "vlm":
        n = cfg.n_vis_tokens
    elif cfg.family == "encdec":
        n = WHISPER_FRAMES
    else:
        return {}
    key = "vis_embeds" if cfg.family == "vlm" else "frames"
    return {key: rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)}


def flash_per_prefill(cfg) -> int:
    """Flash launches of one prefill: one per attention application (a
    hybrid's shared block per group; whisper's encoder layers, and its
    decoder layers twice: self- and cross-attention)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return 0 if cfg.family == "ssm" else cfg.n_layers


def phase_serve(dev, arch: str = "zamba2-1.2b", n_params: int | None = None,
                n_layers: int | None = None, prompt_len: int = SERVE_S,
                active: int | None = None) -> dict:
    """``arch`` at full width through ServeEngine (cut to ``n_layers``
    layers when given; ``n_params`` and ``active`` are then checked on the
    uncut config); returns the kernel launches of the served run. A vlm's
    patch embeddings and an encdec model's frames are seeded and passed
    through ``extra_batch``; an MoE run records its routing and prints the
    (token, k) slots dropped per wave."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.models import blocks
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.serve import Request, ServeEngine

    full = get_model(get_config(arch), device=dev)
    if n_params is not None:
        n = full.count_params()
        check(n == n_params, f"serve {arch}: {n} parameters != {n_params}")
    if active is not None:
        n = full.active_params()
        check(n == active, f"serve {arch}: {n} active parameters != "
                           f"{active}")
    cfg = full.cfg if n_layers is None else dataclasses.replace(
        full.cfg, n_layers=n_layers)
    api = get_model(cfg, device=dev)
    t0 = time.perf_counter()
    model = api.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    cut = ("" if n_layers is None else
           f" (depth cut to {n_layers} of its {full.cfg.n_layers} layers; "
           f"{full.count_params():,} parameters and "
           f"{full.active_params():,} active at full depth)")
    print(f"serve: {arch}, {api.count_params():,} parameters{cut}, "
          f"{str(cfg.dtype)[6:]}, initialised on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (SERVE_REQS, prompt_len)).astype(
        np.int32)
    extra = serve_extra(cfg, rng, SERVE_B)
    n_vis = cfg.n_vis_tokens if cfg.family == "vlm" else 0
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def sampler(logits):
        finite.logical_and_(torch.isfinite(logits).all())
        return torch.argmax(logits, -1)
    max_len = n_vis + prompt_len + SERVE_NEW
    eng = ServeEngine(api, max_len=max_len, batch_slots=SERVE_B,
                      sampler=sampler)
    eng.load(model)
    reqs = [Request(prompt=p, max_new_tokens=SERVE_NEW) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with blocks.record_routes() as routes:
        fa.LAUNCHES = ssd.LAUNCHES = 0
        t0 = time.perf_counter()
        eng.run(reqs, extra_batch=extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.LAUNCHES,
                    "ssd_chunk": ssd.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(r.out) for r in reqs)
    extra_txt = "".join(f", {k} {tuple(v.shape)}" for k, v in extra.items())
    print(f"serve: {SERVE_REQS} requests x {prompt_len} prompt tokens"
          f"{extra_txt}, {SERVE_NEW} new each, {SERVE_B} slots: {wall:.3f} s "
          f"wall, {n_tok} tokens, {n_tok / wall:.2f} generated tokens/s, "
          f"{SERVE_REQS * (prompt_len + SERVE_NEW) / wall:.1f} tokens/s "
          f"prompt+generated; launches flash {launches['flash_attention']}, "
          f"ssd_chunk {launches['ssd_chunk']}; peak device memory "
          f"{peak / 2**30:.3f} GiB")
    check(all(len(r.out) == SERVE_NEW for r in reqs),
          f"serve {arch}: every request got {SERVE_NEW} tokens")
    check(bool(finite), f"serve {arch}: every logit finite")
    n_waves = SERVE_REQS // SERVE_B
    want = {"flash_attention": n_waves * flash_per_prefill(cfg),
            "ssd_chunk": n_waves * (cfg.n_layers if cfg.family in
                                    ("ssm", "hybrid") else 0)}
    for name, n in want.items():
        check(launches[name] == n,
              f"serve {arch}: {name} launches {launches[name]} != {n}")
    if cfg.family == "moe":
        wave_tokens = SERVE_B * prompt_len
        pre = [int(r["dropped"]) for r in routes
               if r["tokens"] == wave_tokens]
        dec = sum(int(r["dropped"]) for r in routes
                  if r["tokens"] != wave_tokens)
        check(len(pre) == n_waves * cfg.n_layers,
              f"serve {arch}: {len(pre)} prefill MoE calls")
        per_wave = [sum(pre[w * cfg.n_layers:(w + 1) * cfg.n_layers])
                    for w in range(n_waves)]
        slots = wave_tokens * cfg.top_k * cfg.n_layers
        print(f"serve: dropped (token, k) slots per wave's prefill "
              f"{per_wave} of {slots:,} ({cfg.n_layers} layers x "
              f"{wave_tokens} tokens x top-{cfg.top_k}); in the decode steps "
              f"{dec}")

    # per-phase device times for one wave (outside the counted run)
    toks = torch.as_tensor(prompts[:SERVE_B], dtype=torch.long, device=dev)
    batch = {"tokens": toks,
             **{k: torch.as_tensor(v, device=dev) for k, v in extra.items()}}
    prefill_ms = event_ms(lambda: api.prefill(model, batch, max_len),
                          reps=3, warmup=1)
    _, cache = api.prefill(model, batch, max_len)
    nxt = toks[:, -1:]
    pos = [n_vis + prompt_len]

    def step():
        api.decode(model, cache, nxt, pos[0])
        pos[0] += 1
    decode_ms = event_ms(step, reps=SERVE_NEW - 8, warmup=4)
    steps = n_waves * (SERVE_NEW - 1)
    served_decode_ms = (wall * 1e3 - n_waves * prefill_ms) / steps
    print(f"serve: prefill {prefill_ms:.3f} ms per wave of "
          f"{SERVE_B}x{n_vis + prompt_len}; decode {decode_ms:.3f} ms per "
          f"step of {SERVE_B} tokens ({SERVE_B * 1e3 / decode_ms:.1f} "
          f"tokens/s), both timed apart from the served run")
    print(f"serve: the served run's decode, (wall - {n_waves} x prefill) / "
          f"{steps} steps: {served_decode_ms:.3f} ms per step")
    del model, cache, eng
    torch.cuda.empty_cache()
    return launches


def phase_numeric(dev, arch: str, n_layers: int | None, B: int, S: int,
                  seed: int, routes: bool = False) -> None:
    """``arch`` at full width (cut to ``n_layers`` layers when given),
    float32: the card (kernels) against the CPU (plain versions), same
    weights and the same seeded patch or frame prefix: prefill logits and 4
    decode steps within ``NUMERIC_RTOL``·max|logits|. With ``routes`` (an
    MoE model) every MoE call's top-k experts must first agree exactly
    between card and CPU; prints the smallest gap between the k-th and the
    (k+1)-th router probability."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import blocks
    from repro_torch.models.registry import get_config, get_model

    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    label = (f"{arch} full width, "
             + ("full depth" if n_layers is None else f"{n_layers} layers"))
    api = get_model(cfg, device=dev)
    cpu_api = get_model(cfg, device="cpu")
    t0 = time.perf_counter()
    model = api.init(torch.Generator(device=dev).manual_seed(seed))
    cpu_model = copy.deepcopy(model).cpu()
    print(f"numeric: {label}: {api.count_params():,} float32 parameters, "
          f"built on the card and copied to the CPU in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    steps = 4
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S + steps)),
                           dtype=torch.long)
    extra = {k: torch.as_tensor(v)
             for k, v in serve_extra(cfg, rng, B).items()}
    n_vis = cfg.n_vis_tokens if cfg.family == "vlm" else 0
    max_len = n_vis + S + steps
    t0 = time.perf_counter()
    sides = {}
    for side, a, m, d in (("card", api, model, dev),
                          ("cpu", cpu_api, cpu_model, "cpu")):
        with blocks.record_routes() as moe_calls:
            before = fa.LAUNCHES
            batch = {"tokens": toks[:, :S].to(d),
                     **{k: v.to(d) for k, v in extra.items()}}
            lg, cache = a.prefill(m, batch, max_len)
            flash = fa.LAUNCHES - before
            logits = [lg.cpu()]
            for i in range(S, S + steps):
                lg, cache = a.decode(m, cache, toks[:, i:i + 1].to(d),
                                     n_vis + i)
                logits.append(lg.cpu())
        sides[side] = (logits, moe_calls, flash)
        del cache
    (card, card_routes, flash), (cpu, cpu_routes, _) = sides["card"], \
        sides["cpu"]
    if routes:
        check(len(card_routes) == len(cpu_routes) > 0,
              f"{label}: {len(card_routes)} card and {len(cpu_routes)} CPU "
              f"MoE calls")
        k = cfg.top_k
        gap = min(float((r["probs"][:, k - 1] - r["probs"][:, k]).min())
                  for r in cpu_routes)
        same = [torch.equal(a["top_idx"].cpu(), b["top_idx"])
                for a, b in zip(card_routes, cpu_routes)]
        print(f"numeric: {label}: top-{k} experts of {len(same)} MoE calls "
              f"(prefill and decode, every layer) card vs CPU: "
              f"{sum(same)} identical; smallest gap between a token's "
              f"router probabilities ranked {k} and {k + 1}: {gap:.3e}")
        check(all(same), f"{label}: the card's routing differs from the "
                         f"CPU's in {len(same) - sum(same)} MoE calls")
    for n, (a, b) in enumerate(zip(card, cpu)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        what = "prefill" if n == 0 else f"decode step {n}"
        check(bool(torch.isfinite(a).all()), f"{label} {what}: finite")
        check(err <= NUMERIC_RTOL * scale, f"{label} {what}: max|Δ| {err} > "
                                           f"{NUMERIC_RTOL} x {scale}")
        print(f"numeric: {label}, f32, B{B} S{S}"
              + (f" + {n_vis} patch positions" if n_vis else "")
              + f", {what}: card vs CPU max|Δ| {err:.3e} (max|logit| "
              f"{scale:.3e}, tol {NUMERIC_RTOL}x)")
    print(f"numeric: {label}: float32 flash launches in the card's prefill "
          f"{flash}; done in {time.perf_counter() - t0:.2f} s")
    check(flash == flash_per_prefill(cfg),
          f"{label}: the card's prefill launched {flash} flash kernels, not "
          f"{flash_per_prefill(cfg)}")
    del model, cpu_model
    torch.cuda.empty_cache()


# ---- the training path (phases 18-19) ------------------------------------
# card vs CPU for one float32 train step: the loss within TRAIN_LOSS_RTOL
# relative, every gradient leaf within TRAIN_GRAD_RTOL·max|g_leaf| (no leaf
# closer than float32's epsilon times the model's largest gradient: a leaf
# whose exact gradient is 0, an attention key bias, holds only noise)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
# the replayed losses against the first run's (same card, same kernels)
REPLAY_RTOL = 1e-5


def phase_train(dev) -> dict:
    """zamba2-1.2b at full width and depth, trained through ``TrainDriver``
    on the card: float32 master weights and AdamW states, bfloat16
    compute, ``remat`` on, ``SyntheticLM(structured=True)``, B 2 x S 4096,
    ``AdamW(lr=warmup_cosine(3e-4, warmup=2, total=8))``, 8 steps with
    async checkpoints every 4 (under ``build/``). Checks every loss and
    gradient norm finite, the loss on step 0's batch lower after the 8
    steps than before, the parameters moved, the kernel launches per step (each attention application and
    each Mamba2 layer once in the forward and once in its recompute), and
    a restart from the step-4 checkpoint that replays steps 4-7 with the
    first run's losses. Returns the launches and the timings."""
    import math
    import os
    import shutil

    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train.driver import DriverConfig, TrainDriver
    from repro_torch.train.optim import AdamW, warmup_cosine
    from repro_torch.train.step import make_loss_fn

    cfg = get_config("zamba2-1.2b")
    api = get_model(cfg, device=dev)
    n = api.count_params()
    check(n == ZAMBA2_PARAMS, f"train: {n} parameters != {ZAMBA2_PARAMS}")
    check(cfg.remat and cfg.dtype == torch.bfloat16,
          "train: zamba2-1.2b computes in bfloat16 with remat")
    t0 = time.perf_counter()
    model = api.init(torch.Generator(device=dev).manual_seed(0),
                     trainable=True)
    torch.cuda.synchronize()
    print(f"train: zamba2-1.2b, {n:,} float32 parameters "
          f"({4 * n / 1e9:.2f} GB; with AdamW's two moments "
          f"{12 * n / 1e9:.2f} GB), bfloat16 compute, remat on, "
          f"initialised on the card in {time.perf_counter() - t0:.2f} s")
    opt = AdamW(lr=warmup_cosine(3e-4, warmup=2, total=TRAIN_STEPS))
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_S,
                       global_batch=TRAIN_B, structured=True)
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    drv = TrainDriver(api, opt, pipe, DriverConfig(
        steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
        ckpt_dir=str(root / "run")))
    n_apps = cfg.n_layers // cfg.hybrid_attn_every
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = ssd.LAUNCHES = 0
    t0 = time.perf_counter()
    params, opt_state, step = drv.run(model, opt.init(model))
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.LAUNCHES, "ssd_chunk": ssd.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    check(step == TRAIN_STEPS, f"train: ran to step {step}")
    m = drv.metrics
    losses = [r["loss"] for r in m]
    steady = [r["wall_s"] for r in m[1:]]
    step_ms = 1e3 * sum(steady) / len(steady)
    tokens = TRAIN_B * TRAIN_S
    for r in m:
        print(f"train: step {r['step']}: loss {r['loss']:.6f}, grad_norm "
              f"{r['grad_norm']:.4f}, {1e3 * r['wall_s']:.1f} ms")
    print(f"train: {TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S} tokens in "
          f"{wall:.2f} s wall (the last checkpoint included); steps 1-"
          f"{TRAIN_STEPS - 1}: {step_ms:.1f} ms per step, "
          f"{tokens * 1e3 / step_ms:.1f} tokens/s; peak device memory "
          f"{peak / 2**30:.3f} GiB")
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    want = {"flash_attention": 2 * n_apps, "ssd_chunk": 2 * cfg.n_layers}
    print(f"train: launches per step flash {per_step['flash_attention']:g}, "
          f"ssd_chunk {per_step['ssd_chunk']:g} (expected "
          f"{want['flash_attention']} and {want['ssd_chunk']}: {n_apps} "
          f"attention applications and {cfg.n_layers} Mamba2 layers, each "
          f"in the forward and in its recompute; the backward is the plain "
          f"versions' vjp)")
    for name, k in want.items():
        check(launches[name] == k * TRAIN_STEPS,
              f"train: {name} launches {launches[name]} != "
              f"{k} x {TRAIN_STEPS}")
    for s_ in drv.ckpt.saves:
        print(f"train: checkpoint at step {s_['step']}: "
              f"{s_['bytes'] / 1e9:.3f} GB, host snapshot "
              f"{s_['snapshot_s']:.2f} s, written (npz, sha256, rename) "
              f"in {s_['write_s']:.2f} s on a background thread")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
              for r in m), "train: every loss and grad_norm finite")
    # each step's loss is on its own batch of two affine sequences, and
    # batches differ by ~0.1 nats at this loss, so the fall is read on one
    # batch: step 0's, before and after the 8 steps
    batch0 = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
              for k, v in pipe.batch(0).items()}
    loss_fn = make_loss_fn(api)
    with torch.no_grad():
        before = float(loss_fn(model, batch0)[0])
        after = float(loss_fn(params, batch0)[0])
    print(f"train: loss on step 0's batch {before:.6f} before and "
          f"{after:.6f} after the {TRAIN_STEPS} steps (step 0 reported "
          f"{losses[0]:.6f}); the last step's loss {losses[-1]:.6f} on its "
          f"own batch")
    check(after < before, f"train: loss on step 0's batch {after} after "
                          f"training, not below {before}")
    with torch.no_grad():
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(model.parameters(), params.parameters()))
    check(moved > 0, "train: the parameters changed")
    del model

    # restart from the step-4 checkpoint (hard links, so nothing is copied)
    # and replay steps 4-7
    first = root / "run" / f"ckpt_{TRAIN_CKPT_EVERY:08d}"
    shutil.copytree(first, root / "replay" / first.name,
                    copy_function=os.link)
    again = TrainDriver(api, opt, pipe, DriverConfig(
        steps=TRAIN_STEPS, ckpt_every=10 * TRAIN_STEPS,
        ckpt_dir=str(root / "replay")))
    t0 = time.perf_counter()
    again.run(params, opt_state)
    replay_s = time.perf_counter() - t0
    del params, opt_state
    restore_s = replay_s - sum(r["wall_s"] for r in again.metrics)
    got = [r["loss"] for r in again.metrics]
    ref = losses[TRAIN_CKPT_EVERY:]
    check(again.events[0] == (TRAIN_CKPT_EVERY, "restored")
          and [r["step"] for r in again.metrics]
          == list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS)),
          f"train: the restart replayed {[r['step'] for r in again.metrics]}")
    worst = max(abs(a / b - 1) for a, b in zip(got, ref))
    print(f"train: restored step {TRAIN_CKPT_EVERY} and replayed steps "
          f"{TRAIN_CKPT_EVERY}-{TRAIN_STEPS - 1}: losses {got}; "
          f"{'bit for bit equal to' if got == ref else 'differ from'} the "
          f"first run's (max relative difference {worst:.3e}); restore and "
          f"batches {restore_s:.2f} s")
    check(worst <= REPLAY_RTOL, f"train: replayed losses {got} vs {ref}")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(launches=launches, per_step=per_step, step_ms=step_ms,
                tokens_s=tokens * 1e3 / step_ms, peak_gib=peak / 2**30,
                losses=losses, replay_bitwise=got == ref)


def phase_train_numeric(dev, arch: str, n_layers: int | None, B: int, S: int,
                        seed: int, routes: bool = False,
                        optimizer: bool = True) -> None:
    """One float32 train step of ``arch`` at full width (cut to
    ``n_layers`` layers when given) on the card (kernels) and on the CPU
    (plain versions), from the same weights and batch: the loss within
    TRAIN_LOSS_RTOL and every gradient leaf within TRAIN_GRAD_RTOL of its
    largest magnitude. The gradients are taken inside ``make_train_step``
    (a ``grad_transform`` that keeps them), or, with ``optimizer`` off
    (a model whose AdamW states would not fit twice), from
    ``make_loss_fn`` and autograd alone. With ``routes`` (an MoE model)
    every MoE call's top-k experts must agree exactly first."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.models import blocks
    from repro_torch.models.lm import rebuild
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import make_loss_fn, make_train_step

    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    label = (f"{arch} full width, "
             + ("full depth" if n_layers is None else f"{n_layers} layers"))
    t0 = time.perf_counter()
    api, cpu_api = get_model(cfg, device=dev), get_model(cfg, device="cpu")
    model = api.init(torch.Generator(device=dev).manual_seed(seed),
                     trainable=True)
    cpu_model = rebuild(model, {k: p.detach().cpu()
                                for k, p in model.named_parameters()})
    print(f"train numeric: {label}: {api.count_params():,} float32 "
          f"parameters, built on the card and copied to the CPU in "
          f"{time.perf_counter() - t0:.2f} s")
    b = SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B,
                    seed=seed).batch(0)
    b.update(serve_extra(cfg, np.random.default_rng(seed), B))
    t0 = time.perf_counter()
    sides = {}
    for side, a, m, d in (("card", api, model, dev),
                          ("cpu", cpu_api, cpu_model, "cpu")):
        batch = {k: torch.as_tensor(v, device=d,
                                    dtype=torch.long if v.dtype == np.int32
                                    else torch.float32)
                 for k, v in b.items()}
        kept = {}
        with blocks.record_routes() as moe_calls:
            before = (fa.LAUNCHES, ssd.LAUNCHES)
            if optimizer:
                opt = AdamW(lr=1e-4)

                def keep(grads):
                    kept.update(grads)
                    return grads
                step = make_train_step(a, opt, grad_transform=keep)
                _, _, met = step(m, opt.init(m), batch)
                loss = float(met["loss"])
            else:
                loss, met = make_loss_fn(a)(m, batch)
                names, leaves = zip(*m.named_parameters())
                kept.update(zip(names, torch.autograd.grad(loss, leaves)))
                loss = float(loss.detach())
            launched = (fa.LAUNCHES - before[0], ssd.LAUNCHES - before[1])
        sides[side] = (loss, kept, moe_calls, launched)
        del m
    del model, cpu_model
    (loss, grads, card_routes, launched), (cpu_loss, cpu_grads, cpu_routes,
                                          _) = sides["card"], sides["cpu"]
    if routes:
        k = cfg.top_k
        same = [torch.equal(x["top_idx"].cpu(), y["top_idx"])
                for x, y in zip(card_routes, cpu_routes)]
        check(len(card_routes) == len(cpu_routes) > 0 and all(same),
              f"{label}: routing differs card vs CPU in "
              f"{len(same) - sum(same)} of {len(same)} MoE calls")
        print(f"train numeric: {label}: top-{k} experts of {len(same)} MoE "
              f"calls identical card vs CPU")
    rel = abs(loss / cpu_loss - 1)
    check(rel <= TRAIN_LOSS_RTOL, f"{label}: loss {loss} vs CPU {cpu_loss}")
    floor = (float(np.finfo(np.float32).eps)
             * max(float(g.abs().max()) for g in cpu_grads.values()))
    worst, worst_name = 0.0, ""
    for name, g in cpu_grads.items():
        scale = max(float(g.abs().max()), floor / TRAIN_GRAD_RTOL)
        err = float((grads.pop(name).cpu() - g).abs().max()) / scale
        if err >= worst:
            worst, worst_name = err, name
    check(worst <= TRAIN_GRAD_RTOL,
          f"{label}: gradient {worst_name} off by {worst:.3e} of its scale")
    print(f"train numeric: {label}, f32, B{B} S{S}: loss card {loss:.7f} vs "
          f"CPU {cpu_loss:.7f} (rel {rel:.2e}); worst gradient leaf "
          f"{worst_name}: max|Δ| {worst:.3e} of max|g| (tol "
          f"{TRAIN_GRAD_RTOL}); {len(cpu_grads)} leaves; "
          f"{'train step' if optimizer else 'loss and gradients'}; card "
          f"launches flash {launched[0]}, ssd_chunk {launched[1]}; done in "
          f"{time.perf_counter() - t0:.2f} s")
    check(launched[0] + launched[1] > 0,
          f"{label}: the card's step launched no LM kernel")
    torch.cuda.empty_cache()


# ---- the mesh path (phases 20-21) ----------------------------------------
# phase 20: phase 18's first steps again, on a 1x1 mesh; the losses against
# phase 18's (a one-rank mesh moves no data: bit for bit expected)
MESH_STEPS = 2
MESH_LOSS_RTOL = 1e-6
# phase 21: zamba2-1.2b at full width cut to one group of 6 Mamba2 layers
# (one application of the shared attention block), traced on meta on a dry
# (4, 2) mesh of 8 ranks at this shape cell
COMM_LAYERS = 6
COMM_MESH = ((4, 2), ("data", "model"))
COMM_SPEC = ("demo", 4096, 8, "train")
# the waterfill kernel against the sort solver on the scheduler's link
# problem: tests/test_torch_allocator.py's tolerance for that pair
WATERFILL_SORT_RTOL = 2e-3
# phase 21's record before the kernels' meta calls counted their FLOPs (on
# the H100's machine, torch 2.11, a "cuda" mesh): FLOPs per rank; and its
# collectives since the embedding gathers its rows per rank and AdamW
# reduces each partial gradient once (587, then 508, before these)
COMM_FLOPS_UNCOUNTED = 10.323e12
COMM_COLLECTIVES = 432
# the call sites of phase 21's traffic printed, most bytes first
COMM_SITES = 8


def phase_train_mesh(dev, ref_losses) -> dict:
    """Phase 18's configuration (zamba2-1.2b at full width and depth, float32
    weights and AdamW states, bfloat16 compute, remat on, the same seed,
    schedule and ``SyntheticLM`` batches) trained for ``MESH_STEPS`` steps
    through the sharding policy: a 1x1 ``DeviceMesh("cuda")`` over a
    one-rank NCCL world, parameters placed by ``param_shardings`` under
    ``TRAIN_RULES``, batches by ``batch_shardings``, the kernels reached
    through ``local_map``. Checks the losses against phase 18's steps
    (``MESH_LOSS_RTOL``), 12 flash and 76 SSD launches a step and finite
    metrics; prints ms per step and peak memory. Then the meshed checkpoint:
    the state after step 0, saved (every DTensor gathered whole), is
    restored onto ``param_shardings`` and ``opt_shardings`` and step 1 is
    replayed from it, its loss and new state bit for bit the first run's;
    ``TrainDriver.reshard_to`` onto the same shardings returns every leaf
    bit for bit. Prints the save and restore seconds and the peak."""
    import math
    import shutil

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch import shardings as S
    from repro_torch.launch.mesh import local_world, make_mesh
    from repro_torch.models import lm
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.sharding.policy import sharding_policy
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.driver import DriverConfig, TrainDriver
    from repro_torch.train.optim import AdamW, warmup_cosine
    from repro_torch.train.step import make_train_step

    cfg = get_config("zamba2-1.2b")
    api = get_model(cfg, device=dev)
    opt = AdamW(lr=warmup_cosine(3e-4, warmup=2, total=TRAIN_STEPS))
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_S,
                       global_batch=TRAIN_B, structured=True)
    model = api.init(torch.Generator(device=dev).manual_seed(0),
                     trainable=True)
    tree = lm.nest({n: p.detach() for n, p in model.named_parameters()})
    del model
    n_apps = cfg.n_layers // cfg.hybrid_attn_every
    want = {"flash_attention": 2 * n_apps, "ssd_chunk": 2 * cfg.n_layers}
    root = ROOT / "build" / "chip_smoke_mesh_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def leaves(params, state) -> dict:
        out = {n: p for n, p in params.named_parameters()}
        out.update({f"m/{n}": t for n, t in state.m.items()})
        out.update({f"v/{n}": t for n, t in state.v.items()})
        out["step"] = state.step
        return out

    def same(a: dict, b: dict) -> bool:
        return list(a) == list(b) and all(
            torch.equal(a[k].full_tensor(), b[k].full_tensor()) for k in a)

    losses, walls = [], []
    with local_world("cuda"):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        with sharding_policy(mesh, S.TRAIN_RULES):
            psh = S.param_shardings(mesh, api, S.TRAIN_RULES)
            osh = S.opt_shardings(mesh, psh)
            params = api.build(S.place_tree(tree, psh), trainable=True)
            del tree
            check(all(isinstance(p, DTensor) for p in params.parameters()),
                  "mesh train: every parameter a DTensor")
            state = opt.init(params)
            step = make_train_step(api, opt)

            def batch(i):
                b = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                     for k, v in pipe.batch(i).items()}
                bsh = S.batch_shardings(mesh, b)
                return {k: S.place(v, bsh[k]) for k, v in b.items()}
            ck = Checkpointer(root / "ck")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.LAUNCHES = ssd.LAUNCHES = 0
            for i in range(MESH_STEPS):
                if i == 1:
                    t0 = time.perf_counter()
                    ck.save(i, {"params": params, "opt": state})
                    save_s = time.perf_counter() - t0
                b = batch(i)
                t0 = time.perf_counter()
                params, state, m = step(params, state, b)
                loss = float(m["loss"].full_tensor())
                walls.append(time.perf_counter() - t0)
                losses.append(loss)
                print(f"mesh train: step {i}: loss {loss:.6f} (phase 18: "
                      f"{ref_losses[i]:.6f}), grad_norm "
                      f"{float(m['grad_norm'].full_tensor()):.4f}, "
                      f"{1e3 * walls[-1]:.1f} ms")
            peak = torch.cuda.max_memory_allocated()
            # the meshed checkpoint: restore the state entering step 1 onto
            # the shardings (the state now has its layout) and replay step 1
            t0 = time.perf_counter()
            restored, at = ck.restore({"params": params, "opt": state},
                                      shardings={"params": psh, "opt": osh})
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(at == 1 and all(isinstance(p, DTensor)
                                  and p.device_mesh == mesh for p in
                                  restored["params"].parameters()),
                  "mesh checkpoint: restored onto the mesh")
            p1, s1, m1 = step(restored["params"], restored["opt"], batch(1))
            replay_loss = float(m1["loss"].full_tensor())
            del restored
            first = leaves(params, state)
            replay_bitwise = same(leaves(p1, s1), first)
            del p1, s1
            drv = TrainDriver(api, opt, pipe, DriverConfig(
                steps=0, ckpt_dir=str(root / "reshard")))
            t0 = time.perf_counter()
            p2, s2 = drv.reshard_to(params, state, psh, osh)
            torch.cuda.synchronize()
            reshard_s = time.perf_counter() - t0
            reshard_bitwise = same(leaves(p2, s2), first)
            del p2, s2, first
            launches = {"flash_attention": fa.LAUNCHES,
                        "ssd_chunk": ssd.LAUNCHES}
            ckpt_peak = torch.cuda.max_memory_allocated()
        del params, state
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    saved = ck.saves[-1]
    worst = max(abs(a / b - 1) for a, b in zip(losses, ref_losses))
    print(f"mesh train: zamba2-1.2b on a 1x1 DeviceMesh (NCCL, one rank), "
          f"{MESH_STEPS} steps of {TRAIN_B} x {TRAIN_S}: "
          f"{1e3 * walls[0]:.1f} ms for step 0 (DTensor's sharding "
          f"propagation warms its cache), {1e3 * walls[-1]:.1f} ms for step "
          f"{MESH_STEPS - 1}; peak device memory {peak / 2**30:.3f} GiB; "
          f"losses {'bit for bit equal to' if losses == ref_losses[:MESH_STEPS] else 'differ from'} "
          f"phase 18's (max relative difference {worst:.3e}); launches "
          f"flash {launches['flash_attention']}, ssd_chunk "
          f"{launches['ssd_chunk']} (expected {want['flash_attention']} and "
          f"{want['ssd_chunk']} a step, {MESH_STEPS + 1} steps with the "
          f"replay)")
    print(f"mesh checkpoint: the state after step 0 ({saved['bytes'] / 1e9:.2f} "
          f"GB) saved in {save_s:.2f} s (gather and host copy "
          f"{saved['snapshot_s']:.2f} s, write {saved['write_s']:.2f} s), "
          f"restored onto param_shardings and opt_shardings in "
          f"{restore_s:.2f} s; step 1 replayed: loss {replay_loss:.6f} "
          f"({'bit for bit equal to' if replay_loss == losses[1] else 'differs from'} "
          f"{losses[1]:.6f}), new state "
          f"{'bit for bit' if replay_bitwise else 'NOT bit for bit'}; "
          f"reshard_to onto the same shardings in {reshard_s:.2f} s, every "
          f"leaf {'bit for bit' if reshard_bitwise else 'NOT bit for bit'}; "
          f"peak device memory {ckpt_peak / 2**30:.3f} GiB")
    check(all(math.isfinite(x) for x in losses), "mesh train: finite losses")
    check(worst <= MESH_LOSS_RTOL,
          f"mesh train: losses {losses} vs phase 18's {ref_losses[:2]}")
    for name, k in want.items():
        check(launches[name] == k * (MESH_STEPS + 1),
              f"mesh train: {name} launches {launches[name]} != "
              f"{k} x {MESH_STEPS + 1}")
    check(replay_loss == losses[1] and replay_bitwise,
          "mesh checkpoint: the replayed step 1 is not bit for bit")
    check(reshard_bitwise, "mesh checkpoint: reshard_to changed a leaf")
    return dict(launches=launches, losses=losses, step_ms=1e3 * walls[-1],
                first_step_ms=1e3 * walls[0], peak_gib=peak / 2**30,
                bitwise=losses == ref_losses[:MESH_STEPS], save_s=save_s,
                restore_s=restore_s, reshard_s=reshard_s,
                ckpt_peak_gib=ckpt_peak / 2**30)


# phase 24: zamba2-1.2b at full width cut to one group of 6 layers, trained
# through TrainDriver in a spawned world; 4 steps, checkpoints every 2, a
# failure injected at step 3
WORLD_LAYERS = 6
WORLD_STEPS, WORLD_CKPT_EVERY, WORLD_FAIL_AT = 4, 2, 3
WORLD_TIMEOUT_S = 600.0
# the multi-card comparison: float32, B 2 per rank, S 512; a 128-token
# prompt (one SSD chunk) and two decode steps
WORLD_CMP_S, WORLD_PROMPT = 512, 128
WORLD_LOGITS_RTOL = 1e-5


def _world_model(dev, dtype=None):
    """Phase 24's model: zamba2-1.2b at full width, ``WORLD_LAYERS``
    layers, its weights drawn on ``dev`` from phase 18's seed."""
    import dataclasses

    import torch

    from repro_torch.models.registry import get_config, get_model

    cfg = dataclasses.replace(get_config("zamba2-1.2b"),
                              n_layers=WORLD_LAYERS)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    api = get_model(cfg, device=dev)
    model = api.init(torch.Generator(device=dev).manual_seed(0),
                     trainable=True)
    return api, model


def _placed(api, model, mesh, rules, trainable=True):
    from repro_torch.launch import shardings as S
    from repro_torch.models import lm

    tree = lm.nest({n: p.detach() for n, p in model.named_parameters()})
    return api.build(S.place_tree(tree, S.param_shardings(mesh, api, rules)),
                     trainable=trainable)


def world_train_rank(rank: int, root: str) -> dict:
    """One rank of phase 24's run: the driver over the meshed state."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch import shardings as S
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.policy import sharding_policy
    from repro_torch.train.driver import DriverConfig, TrainDriver
    from repro_torch.train.optim import AdamW, warmup_cosine

    dev = torch.device("cuda", rank)
    api, model = _world_model(dev)
    mesh = make_local_mesh(1, "cuda")
    opt = AdamW(lr=warmup_cosine(3e-4, warmup=2, total=TRAIN_STEPS))
    pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=TRAIN_S,
                       global_batch=TRAIN_B * dist.get_world_size(),
                       structured=True)
    with sharding_policy(mesh, S.TRAIN_RULES):
        params = _placed(api, model, mesh, S.TRAIN_RULES)
        del model
        drv = TrainDriver(api, opt, pipe, DriverConfig(
            steps=WORLD_STEPS, ckpt_every=WORLD_CKPT_EVERY, ckpt_dir=root),
            failure_at={WORLD_FAIL_AT})
        state = opt.init(params)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fa.LAUNCHES = ssd.LAUNCHES = 0
        t0 = time.perf_counter()
        drv.run(params, state)
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.LAUNCHES, "ssd_chunk": ssd.LAUNCHES}
        peak = torch.cuda.max_memory_allocated(dev)
    return dict(world=dist.get_world_size(), mesh=tuple(mesh.shape),
                steps=[m["step"] for m in drv.metrics],
                losses=[m["loss"] for m in drv.metrics],
                walls=[m["wall_s"] for m in drv.metrics], events=drv.events,
                launches=launches, peak=peak, wall=wall, saves=drv.ckpt.saves,
                n_apps=api.cfg.n_layers // api.cfg.hybrid_attn_every,
                n_layers=api.cfg.n_layers)


def world_compare_rank(rank: int) -> dict | None:
    """One rank of phase 24's multi-card check, in float32: an (n, 1) train
    step and a (1, n) prefill and two decode steps, each held to the
    unmeshed run of the same model on this rank's card. Rank 0 returns
    the worst relative differences."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch import shardings as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.policy import sharding_policy
    from repro_torch.train.step import make_loss_fn

    n = dist.get_world_size()
    dev = torch.device("cuda", rank)
    api, model = _world_model(dev, torch.float32)
    rng = np.random.default_rng(24)
    toks = torch.as_tensor(rng.integers(0, api.cfg.vocab,
                                        (2 * n, WORLD_CMP_S + 1)),
                           dtype=torch.long, device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_fn = make_loss_fn(api)

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    def step(m, b):
        loss, _ = loss_fn(m, b)
        if isinstance(loss, DTensor):
            loss = loss.redistribute(placements=[Replicate()] * 2)
        return loss, torch.autograd.grad(loss, list(m.parameters()))

    def serve(m, place):
        b = {"tokens": place(toks[:, :WORLD_PROMPT])}
        logits, cache = api.prefill(m, b, WORLD_PROMPT + 4)
        out = [whole(logits)]
        for pos in (WORLD_PROMPT, WORLD_PROMPT + 1):
            t = place(torch.full((2 * n, 1), pos, dtype=torch.long,
                                 device=dev))
            logits, cache = api.decode(m, cache, t, pos)
            out.append(whole(logits))
        return out

    loss0, grads0 = step(model, batch)
    want = serve(model, lambda t: t)
    worst = {}
    mesh = make_mesh((n, 1), ("data", "model"), "cuda")
    with sharding_policy(mesh, S.TRAIN_RULES):
        meshed = _placed(api, model, mesh, S.TRAIN_RULES)
        bsh = S.batch_shardings(mesh, batch)
        loss1, grads1 = step(meshed, {k: S.place(v, bsh[k])
                                      for k, v in batch.items()})
        worst["train_loss"] = abs(float(whole(loss1))
                                  / float(loss0.detach()) - 1)
        # each leaf against its largest gradient, floored at float32's
        # epsilon times the model's largest (a leaf whose exact gradient is
        # 0 holds rounding noise), as the CPU parity tests hold them
        floor = float(np.finfo(np.float32).eps) * max(
            float(g.abs().max()) for g in grads0) / TRAIN_GRAD_RTOL
        worst["train_grads"] = max(
            float((whole(g1) - g0).abs().max())
            / max(float(g0.abs().max()), floor)
            for g0, g1 in zip(grads0, grads1))
    del meshed, grads1
    mesh = make_mesh((1, n), ("data", "model"), "cuda")
    with sharding_policy(mesh, S.SERVE_RULES):
        meshed = _placed(api, model, mesh, S.SERVE_RULES, trainable=False)

        def place(t):
            return S.place(t, S.batch_shardings(mesh, {"x": t})["x"])
        got = serve(meshed, place)
        worst["decode_logits"] = max(
            float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want))
    return worst if rank == 0 else None


def phase_world() -> dict:
    """Phase 24 (see the module docstring): ``spawn_world`` with one rank
    per card. Returns rank 0's kernel launches in its driver run."""
    import math
    import shutil

    import torch

    from repro_torch.launch.mesh import spawn_world

    n = torch.cuda.device_count()
    root = ROOT / "build" / "chip_smoke_world"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = spawn_world(n, world_train_rank, str(root), device_type="cuda",
                        timeout_s=WORLD_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    r = ranks[0]
    per_step = {k: v / len(r["steps"]) for k, v in r["launches"].items()}
    want = {"flash_attention": 2 * r["n_apps"], "ssd_chunk": 2 * r["n_layers"]}
    steady = r["walls"][1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    first = r["losses"][r["steps"].index(WORLD_FAIL_AT - 1)]
    replay = r["losses"][len(r["steps"]) - 1 - r["steps"][::-1].index(
        WORLD_FAIL_AT - 1)]
    saves = "; ".join(f"step {s['step']}: {s['bytes'] / 1e9:.2f} GB, "
                      f"snapshot {s['snapshot_s']:.2f} s, write "
                      f"{s['write_s']:.2f} s" for s in r["saves"])
    print(f"world: {r['world']} rank(s) (NCCL, spawn), mesh {r['mesh']}; "
          f"zamba2-1.2b at full width, {r['n_layers']} layers, "
          f"{TRAIN_B * r['world']} x {TRAIN_S} tokens a step; steps "
          f"{r['steps']}, events {r['events']}; losses {r['losses']}; "
          f"{step_ms:.1f} ms per step (steps after the first, as the "
          f"driver times them); peak device memory "
          f"{r['peak'] / 2**30:.3f} GiB on rank 0; driver run "
          f"{r['wall']:.2f} s, the whole spawned world {spawn_s:.2f} s; "
          f"launches per step flash {per_step['flash_attention']:g}, "
          f"ssd_chunk {per_step['ssd_chunk']:g} (expected "
          f"{want['flash_attention']} and {want['ssd_chunk']}); "
          f"checkpoints written by rank 0: {saves}")
    check(all(math.isfinite(x) for q in ranks for x in q["losses"]),
          "world: finite losses")
    check(all(q["losses"] == r["losses"] for q in ranks),
          "world: every rank reports the same losses")
    check(r["steps"] == [0, 1, 2, 2, 3]
          and (WORLD_FAIL_AT - 1, "restart-from-ckpt") in r["events"],
          f"world: the failure at step {WORLD_FAIL_AT} restored step "
          f"{WORLD_FAIL_AT - 1}: {r['steps']}, {r['events']}")
    check(replay == first, f"world: the replayed loss {replay} is not bit "
                           f"for bit the first pass's {first}")
    for name, k in want.items():
        check(r["launches"][name] == k * len(r["steps"]),
              f"world: {name} launches {r['launches'][name]} != {k} x "
              f"{len(r['steps'])}")
    check([s["step"] for s in r["saves"]] == [2, 4]
          and all(not q["saves"] for q in ranks[1:]),
          "world: rank 0 alone wrote the checkpoints of steps 2 and 4")
    if n < 2:
        print("world: one card: the (1, n) decode and (n, 1) step on "
              "several cards were not tried")
        return r["launches"]
    worst = spawn_world(n, world_compare_rank, device_type="cuda",
                        timeout_s=WORLD_TIMEOUT_S)[0]
    print(f"world: {n} cards, float32, against the unmeshed runs on each "
          f"card: ({n}, 1) train step loss {worst['train_loss']:.3e} "
          f"relative, gradients {worst['train_grads']:.3e} of max|g|; "
          f"(1, {n}) prefill and decode logits {worst['decode_logits']:.3e}"
          f" of max|logits|")
    check(worst["train_loss"] <= TRAIN_LOSS_RTOL
          and worst["train_grads"] <= TRAIN_GRAD_RTOL
          and worst["decode_logits"] <= WORLD_LOGITS_RTOL,
          f"world: {n} cards against one: {worst}")
    return r["launches"]


def phase_comm_schedule(dev) -> dict:
    """The comm-schedule path at full width: zamba2-1.2b (d_model 2048)
    cut to ``COMM_LAYERS`` layers, one train step traced on meta tensors
    on a dry ``COMM_MESH`` of the card's device type (the "fake" backend;
    a "cuda" mesh, so DTensor issues the collectives it would issue on the
    card, all-to-alls where a "cpu" mesh gathers), its collectives recorded
    and turned into flows, ``plan_schedule`` on the card (sort solver);
    then the same link problem through ``OnlineAllocator(solver=
    "waterfill")`` on the card, held to the sort solver's rates at
    ``WATERFILL_SORT_RTOL``. Checks collectives on both mesh axes, the
    record's all-to-all (DTensor's shard-to-shard redistribution, which
    the step itself no longer issues), and no LM kernel launch (on meta
    the wrappers are shape functions)."""
    import dataclasses

    import numpy as np
    import torch

    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.core.allocator import OnlineAllocator
    from repro_torch.core.scheduler import (extract_flows, flow_state,
                                            link_problem, plan_schedule)
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.waterfill import ops as wf
    from repro_torch.launch import comm_stats
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16, dry_world, make_mesh
    from repro_torch.models.registry import ShapeSpec, get_config, get_model
    from repro_torch.sharding.policy import mesh_axes

    cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=COMM_LAYERS)
    api = get_model(cfg, device=dev)
    spec = ShapeSpec(*COMM_SPEC)
    before = (fa.LAUNCHES, ssd.LAUNCHES)
    t0 = time.perf_counter()
    with dry_world(int(np.prod(COMM_MESH[0]))):
        mesh = make_mesh(*COMM_MESH, dev.type)
        records, flops = comm_stats.trace_train_step(api, mesh, spec)
        axes = mesh_axes(mesh)
        # the record names DTensor's shard-to-shard redistribution on a
        # "cuda" mesh an all-to-all (the step itself issues none)
        x = DTensor.from_local(
            torch.empty((8, 2048, 2048), dtype=torch.bfloat16, device="meta"),
            mesh, [Replicate(), Shard(1)], run_check=False)
        with comm_stats.record(mesh) as moved:
            x.redistribute(mesh, [Replicate(), Shard(0)])
        a2a = [c.kind for c in moved]
    trace_s = time.perf_counter() - t0
    check((fa.LAUNCHES, ssd.LAUNCHES) == before,
          "comm schedule: the meta trace launched an LM kernel")
    st = comm_stats.collective_stats(records)
    kinds = {k: v for k, v in st.items() if k not in ("total", "count")}
    counts = {k: n for k, (n, _) in
              comm_stats.by_axis(records, per_kind=True).items()}
    print(f"comm schedule: zamba2-1.2b at d_model {cfg.d_model}, "
          f"{cfg.n_layers} of 38 layers, {spec.global_batch} x "
          f"{spec.seq_len} tokens on a dry {COMM_MESH[0]} "
          f"{COMM_MESH[1]} mesh: {st['count']} collectives, "
          f"{st['total'] / 1e6:.1f} MB of operands per rank, "
          f"{flops / 1e12:.3f} TFLOP per rank ({COMM_FLOPS_UNCOUNTED / 1e12:.3f}"
          f" before the kernels' meta calls counted theirs; they add "
          f"{records.kernel_flops / 1e12:.3f}); traced in {trace_s:.2f} s")
    print(f"comm schedule: operand MB per kind "
          f"{ {k: round(v / 1e6, 3) for k, v in kinds.items()} }; ops per "
          f"(kind, axis) {counts}")
    check({c.axis for c in records} >= {"data", "model"},
          f"comm schedule: collectives on {sorted({str(c.axis) for c in records})}")
    check(a2a == ["all-to-all"], f"comm schedule: a shard-to-shard "
          f"redistribution on the cuda mesh recorded as {a2a}, not one "
          f"all-to-all")
    check(flops > COMM_FLOPS_UNCOUNTED and records.kernel_flops > 0,
          f"comm schedule: {flops / 1e12:.3f} TFLOP per rank, not above "
          f"{COMM_FLOPS_UNCOUNTED / 1e12:.3f} with the kernels counted")
    check(st["count"] == COMM_COLLECTIVES,
          f"comm schedule: {st['count']} collectives, not {COMM_COLLECTIVES}")
    for site, n, b, kinds_ in comm_stats.by_site(records, COMM_SITES):
        print(f"comm schedule:   {site}: {n} collectives, {b / 1e6:.1f} MB "
              f"({', '.join(kinds_)})")
    flows = extract_flows(records, axes)
    per_axis = comm_stats.by_axis(flows)
    for axis, (n, b) in per_axis.items():
        print(f"comm schedule: axis {axis}: {n} flows, {b / 1e6:.1f} MB per "
              f"step")
    compute_s = flops / PEAK_FLOPS_BF16
    t0 = time.perf_counter()
    sched = plan_schedule(flows, axes, step_compute_s=max(compute_s, 1e-3),
                          device=dev)
    plan_s = time.perf_counter() - t0
    print(f"comm schedule: compute {1e3 * compute_s:.3f} ms at the bf16 "
          f"peak; total comm {1e3 * sched.est_total_comm_s:.3f} ms, exposed "
          f"{1e3 * sched.est_exposed_s:.3f} ms; planned in {plan_s:.3f} s")
    check(np.isfinite(sched.rates).all() and (sched.rates >= 0).all(),
          "comm schedule: finite rates")
    # the same link problem through the waterfill kernel
    R, caps, kinds_, mb, backlog = link_problem(flows, axes)
    dt = max(compute_s, 1e-3)
    sort = OnlineAllocator(R, caps, kinds_, dt=dt, device=dev)
    kern = OnlineAllocator(R, caps, kinds_, dt=dt, solver="waterfill",
                           device=dev)
    state = flow_state(mb, backlog, dev)
    wf.LAUNCHES = 0
    got = kern(state)
    torch.cuda.synchronize()
    launches = wf.LAUNCHES
    want = sort(state)
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    print(f"comm schedule: {len(flows)} flows on {len(axes)} links through "
          f"the waterfill kernel ({launches} launches): max |rate - sort| "
          f"{err:.4e} B/s, {rel:.3e} relative")
    check(launches > 0, "comm schedule: the waterfill kernel never ran")
    check(torch.allclose(got, want, rtol=WATERFILL_SORT_RTOL,
                         atol=WATERFILL_SORT_RTOL),
          f"comm schedule: waterfill rates off the sort solver's by {rel}")
    return dict(launches=launches, max_abs_err=err, count=st["count"],
                per_axis=per_axis)


# phase 22: three cells of the dry run at full width and depth on "cuda"
# production meshes (arch, shape, mesh)
DRYRUN_CELLS = (("qwen1.5-0.5b", "train_4k", "pod_16x16"),
                ("yi-6b", "decode_32k", "pod_16x16"),
                ("mamba2-370m", "long_500k", "multipod_2x16x16"),
                # the MoE's dispatch on a mesh and the vlm's vision prefix
                ("dbrx-132b", "train_4k", "pod_16x16"),
                ("dbrx-132b", "train_4k", "multipod_2x16x16"),
                ("internvl2-1b", "train_4k", "pod_16x16"))
# a train cell's peak per rank must fit the card; dbrx's FLOPs per rank on
# 512 ranks at most this share of its FLOPs on 256 (half the work a rank,
# with 10% of room)
HBM_BYTES = 80e9
MULTIPOD_FLOPS_SHARE = 0.55


def phase_dryrun(dev) -> dict:
    """The dry run on the card's box: ``DRYRUN_CELLS`` through
    ``dryrun.run_cell`` at full depth on dry worlds of 256 and 512 ranks
    with "cuda" meshes, into a temporary directory (so that no cached
    record stands in for a trace); prints each cell's trace seconds, its
    top three call sites of traffic, and the ``dryrun_report`` and
    ``roofline`` rows. Checks every cell ok with FLOPs and collectives,
    the train cell's kernel FLOPs (the meta calls' count) above 0, and no
    kernel launch (meta tensors)."""
    import tempfile

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.waterfill import ops as wf
    from repro_torch.launch import dryrun, dryrun_report, roofline
    from repro_torch.models.registry import get_config, shapes_for

    fa.LAUNCHES = ssd.LAUNCHES = wf.LAUNCHES = 0
    recs = []
    with tempfile.TemporaryDirectory() as out:
        for arch, shape, mesh in DRYRUN_CELLS:
            spec = next(s for s in shapes_for(get_config(arch))
                        if s.name == shape)
            rec = dryrun.run_cell(arch, spec, mesh, device_type=dev.type,
                                  results=out)
            recs.append(rec)
            check(rec["ok"], f"dry run: {arch} {shape} {mesh}: "
                  f"{rec.get('error')}\n{rec.get('traceback', '')}")
            mem = rec["memory"]
            print(f"dry run: {arch} {shape} {mesh}: traced in "
                  f"{rec['trace_s']:.2f} s at {rec['depth_traced']} layers "
                  f"(torch {rec['torch']}, \"{rec['device_type']}\" mesh); "
                  f"{rec['flops'] / 1e12:.3f} TFLOP per rank (kernels' meta "
                  f"calls {rec['kernel_flops'] / 1e12:.3f}), "
                  f"{rec['collectives']['count']} collectives, "
                  f"{rec['collectives']['total'] / 1e9:.3f} GB per rank; "
                  f"arguments {mem['argument_size_in_bytes'] / 1e9:.3f} GB, "
                  f"peak {mem['peak_memory_in_bytes'] / 1e9:.3f} GB per rank")
            for site, n, b, kinds in rec["call_sites"][:3]:
                print(f"dry run:   {site}: {n} collectives, {b / 1e9:.3f} GB "
                      f"({', '.join(kinds)})")
            check(rec["flops"] > 0 and rec["collectives"]["count"] > 0,
                  f"dry run: {arch} {shape}: no FLOPs or no collectives")
            if rec["kind"] == "train":
                check(rec["kernel_flops"] > 0,
                      f"dry run: {arch} {shape}: the kernels' meta calls "
                      "counted no FLOPs")
                check(mem["peak_memory_in_bytes"] <= HBM_BYTES,
                      f"dry run: {arch} {shape} {mesh}: peak "
                      f"{mem['peak_memory_in_bytes'] / 1e9:.1f} GB > 80 GB")
        flops = {(r["arch"], r["mesh"]): r["flops"] for r in recs}
        share = (flops[("dbrx-132b", "multipod_2x16x16")]
                 / flops[("dbrx-132b", "pod_16x16")])
        print(f"dry run: dbrx-132b train_4k FLOPs per rank on 2x16x16 are "
              f"{share:.4f} of those on 16x16")
        check(share <= MULTIPOD_FLOPS_SHARE,
              f"dry run: dbrx-132b on 2x16x16 does {share:.3f} of a 16x16 "
              "rank's FLOPs")
        dryrun_report.main(["--results", out])
        roofline.main(["--results", out, "--mesh", "all"])
    launches = {"flash_attention": fa.LAUNCHES, "ssd_chunk": ssd.LAUNCHES,
                "waterfill": wf.LAUNCHES}
    check(not any(launches.values()),
          f"dry run: a meta trace launched a kernel: {launches}")
    return dict(launches=launches, records=recs)


# ---- the port's examples and the paper's oracles (phase 13) --------------
# JAX reference (examples/dynamic_failure.py, 120 s): throughput, post-event
# throughput (tuples/s), dip depth, recovery s
GOLDEN_DYNAMIC = {"tcp": (38.51171875, 35.76088333129883, 0.8985969798325554,
                          23.0),
                  "appaware": (50.0, 46.42857360839844, 0.9876895345792953,
                               26.5)}
ORACLE_TOL = dict(rtol=1e-5, atol=1e-4)   # the JAX tests' oracle tolerances


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts, not a
    package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def oracle_instance(rng, F: int, L: int):
    """A random routing (0-3 links per flow, so some flows are off-net), a
    zero-capacity link, a zero demand and tied demands."""
    import numpy as np

    R = np.zeros((F, L), np.float32)
    for f in range(F):
        k = int(rng.integers(0, min(L, 3) + 1))
        if k:
            R[f, rng.choice(L, k, replace=False)] = 1.0
    cap = rng.uniform(0.5, 20.0, L).astype(np.float32)
    cap[rng.integers(0, L)] = 0.0
    d = rng.uniform(0.0, 10.0, F).astype(np.float32)
    d[rng.integers(0, F)] = 0.0
    d[rng.integers(0, F, 3)] = d[1]
    return R, cap, d


def phase_oracles(dev) -> None:
    """``maxmin_rates``, ``demand_limited_maxmin``, ``tcp_app_throughput``
    and ``AppFairScheduler`` (one group, on single-link routes: its
    fixed-trip fill is exact where the bottleneck chain is shallow) on the
    card against the port's sequential numpy reference
    ``demand_limited_maxmin_np``, at the JAX tests' oracle tolerances; the
    per-app sums and an App-Fair step give the same bits
    on every call; 60 App-Fair steps on the card against the same steps on
    the CPU (the CPU's per-app throughputs fed to both) give the same
    priorities and rates within 1e-5."""
    import numpy as np
    import torch

    from repro_torch.core import (AppFairScheduler, demand_limited_maxmin,
                                  demand_limited_maxmin_np, maxmin_rates)
    from repro_torch.core.multiapp import tcp_app_throughput

    rng = np.random.default_rng(3)
    worst = 0.0
    n_inst, A = 8, 4

    def close(got, want, what, atol=ORACLE_TOL["atol"]):
        nonlocal worst
        err = np.abs(got - want)
        worst = max(worst, float(err.max(initial=0.0)))
        check(bool(np.all(err <= atol + ORACLE_TOL["rtol"] * np.abs(want))),
              f"oracles {what}: max|Δ| {err.max(initial=0.0)}")

    for i in range(n_inst):
        R, cap, d = oracle_instance(rng, 28, 12)
        app = np.arange(R.shape[0]) % A
        Rc, cc, dc = (torch.tensor(a, device=dev) for a in (R, cap, d))
        appc = torch.tensor(app, device=dev)
        on_net = R.sum(1) > 0
        close(demand_limited_maxmin(Rc, cc, dc).cpu().numpy(),
              demand_limited_maxmin_np(R, cap, d), f"{i} demand-limited")
        # without demand caps: the reference with a slack demand on every
        # on-net flow; maxmin_rates gives off-net flows +inf
        slack = np.where(on_net, cap.sum() + 1.0, 0.0).astype(np.float32)
        ref = demand_limited_maxmin_np(R, cap, slack)
        x = maxmin_rates(Rc, cc).cpu().numpy()
        check(bool(np.all(np.isposinf(x[~on_net]))
                   and np.isfinite(x[on_net]).all()),
              f"oracles {i} maxmin_rates: +inf exactly off the network")
        close(x[on_net], ref[on_net], f"{i} maxmin_rates")
        per_app = tcp_app_throughput(Rc, cc, appc, A)
        check(torch.equal(per_app, tcp_app_throughput(Rc, cc, appc, A)),
              f"oracles {i} tcp_app_throughput: the same bits twice")
        want = np.array([ref[(app == a) & on_net].sum() for a in range(A)])
        close(per_app.cpu().numpy(), want, f"{i} tcp_app_throughput",
              atol=ORACLE_TOL["atol"] * R.shape[0])
        # one priority group: strict priority is max-min with slack demands,
        # through the fixed-trip fill (FILL_ROUNDS), which is exact where
        # the bottleneck-level chain is shallow: here every flow keeps only
        # its first link, so each link is a level of its own
        R1 = R * (np.cumsum(R, 1) == 1)
        sched = AppFairScheduler(A, n_groups=1, device=dev)
        state = sched.init()
        R1c = torch.tensor(R1, device=dev)
        _, xa = sched.step(state, torch.zeros(A, device=dev), R1c, cc, appc)
        _, xb = sched.step(state, torch.zeros(A, device=dev), R1c, cc, appc)
        check(torch.equal(xa, xb), f"oracles {i} App-Fair: the same bits")
        close(xa.cpu().numpy(), demand_limited_maxmin_np(R1, cap, slack),
              f"{i} App-Fair one group")

    # 60 App-Fair steps on a multi-link instance, card against CPU
    R, cap, _ = oracle_instance(np.random.default_rng(4), 30, 8)
    app = np.random.default_rng(5).integers(0, 6, R.shape[0])
    cards = AppFairScheduler(6, alpha=0.5, n_groups=3, device=dev)
    cpus = AppFairScheduler(6, alpha=0.5, n_groups=3, device="cpu")
    sc, sp = cards.init(), cpus.init()
    args_c = [torch.tensor(a, device=dev) for a in (R, cap, app)]
    args_p = [torch.tensor(a) for a in (R, cap, app)]
    prev = np.zeros(6, np.float32)
    for step in range(60):
        sc, xc = cards.step(sc, torch.tensor(prev, device=dev), *args_c)
        sp, xp = cpus.step(sp, torch.tensor(prev), *args_p)
        check(torch.equal(sc.priority.cpu(), sp.priority),
              f"App-Fair step {step}: card and CPU priorities differ")
        err = float((xc.cpu() - xp).abs().max())
        check(err <= 1e-5 + 1e-5 * float(xp.abs().max()),
              f"App-Fair step {step}: card vs CPU max|Δ| {err}")
        xn = xp.numpy()
        prev = np.array([xn[app == a].sum() for a in range(6)], np.float32)
    print(f"oracles: {n_inst} instances (28 flows x 12 links) on the card "
          f"against demand_limited_maxmin_np: max|Δ| {worst:.3e} "
          f"(atol {ORACLE_TOL['atol']}, rtol {ORACLE_TOL['rtol']}); 60 "
          f"App-Fair steps card vs CPU, last step's max|Δ| {err:.3e}")


def phase_examples(dev) -> None:
    """``examples/port_*.py`` with ``--device cuda``: the §VII fairness demo
    (App-Fair's Jain ≥ 0.98 for every α, TCP's within 1e-3 of 0.818), the
    oracles (:func:`phase_oracles`), the in-run failure demo against the
    JAX reference's numbers, the serving demo at ``reduced()``, the
    quickstart (the stream demo, 50 train steps and a served request) and
    the training demo (40 steps, a failure injected at step 25 and the
    restart from the step-20 checkpoint, the loss falling)."""
    import shutil

    import numpy as np

    t0 = time.perf_counter()
    fair = load_example("port_multiapp_fairness").main(["--device", "cuda"])
    check(abs(fair["tcp_jain"] - 0.818) <= 1e-3,
          f"multiapp: TCP Jain {fair['tcp_jain']} not 0.818")
    for alpha, (avg, jain) in fair["appfair"].items():
        check(jain >= 0.98, f"multiapp: App-Fair(α={alpha}) Jain {jain}")
    print(f"examples: multiapp_fairness in {time.perf_counter() - t0:.2f} s")
    phase_oracles(dev)
    t0 = time.perf_counter()
    dyn = load_example("port_dynamic_failure").main(["--device", "cuda"])
    for policy, row in dyn.items():
        gold = GOLDEN_DYNAMIC[policy]
        check(bool(np.isfinite(row[:3]).all()),
              f"dynamic_failure {policy}: finite")
        check(abs(row[0] / gold[0] - 1) <= GOLDEN_RTOL
              and abs(row[1] / gold[1] - 1) <= GOLDEN_RTOL,
              f"dynamic_failure {policy}: {row} vs the reference's {gold}")
    check(dyn["appaware"][0] > dyn["tcp"][0],
          "dynamic_failure: appaware beats tcp")
    print(f"examples: dynamic_failure in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    reqs = load_example("port_serve_decode").main(["--device", "cuda"])
    check(len(reqs) == 6 and all(r.done and len(r.out) == 12 for r in reqs),
          "serve_decode: 6 requests of 12 tokens")
    print(f"examples: serve_decode in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    req = load_example("port_quickstart").main(["--device", "cuda"])
    check(req.done and len(req.out) == 8, "quickstart: 8 decoded tokens")
    print(f"examples: quickstart in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    ckpt = ROOT / "build" / "chip_smoke_train_lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    drv = load_example("port_train_lm").main(
        ["--device", "cuda", "--steps", "40", "--ckpt-every", "10",
         "--inject-failure", "25", "--ckpt-dir", str(ckpt)])
    shutil.rmtree(ckpt, ignore_errors=True)
    losses = [m["loss"] for m in drv.metrics]
    check((20, "restart-from-ckpt") in drv.events
          and drv.metrics[-1]["step"] == 39 and losses[-1] < losses[0],
          f"train_lm: restart from step 20 and a falling loss "
          f"({drv.events}, {losses[0]} -> {losses[-1]})")
    print(f"examples: train_lm in {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    sys.exit(main())
