"""Where the time goes in the PyTorch port, on one CUDA card.

    python3 tools/port_profile.py [sim] [fleet] [serve [ARCH[:LAYERS] ...]]
    python3 tools/port_profile.py train [ARCH[:LAYERS]]

(no argument: sim, fleet and serve; ``serve`` alone profiles zamba2-1.2b
and yi-6b, and ``serve qwen3-moe-235b-a22b:8 whisper-tiny`` the named
archs, cut to LAYERS layers where given; ``train`` alone profiles one
zamba2-1.2b train step).

Simulation: for the paper-grid cell (TT on big_switch(8, 1.25)) and the
datacenter cell (TT at 64-way parallelism on a 256-machine fat-tree, as in
chip_smoke.py), and for tcp and appaware (solver="waterfill"): a warm-up
30 s simulation (60 ticks), a timed one, and one under torch.profiler.

Fleet: ``bench_fleet()`` (44 scenarios) through one ``FleetRunner`` for
tcp and appaware (solver="waterfill"), 30 s, per fleet tick (one tick of
every bucket); and a campaign of ``campaign_fleet(1024)`` in chunks of 256
rows, appaware through the kernel, per chunk tick (one tick of one chunk).

Serving: each arch at full width (bf16, random weights from a seed), one
wave of chip_smoke.py's serving runs: the prefill of 4 × 512 tokens (a
vlm's 256 seeded patch embeddings before them; whisper: 4 tokens and 1,500
seeded frames), and 8 decode steps of 4 tokens, each warmed up, timed and
profiled the same way.

Training: one train step of the arch at full width (float32 weights and
AdamW states, bfloat16 compute, remat on; random weights from a seed) on
B 2 x S 4096 tokens of ``SyntheticLM``, as ``chip_smoke.py`` phase 18 runs
it. The step is split into its forward (the loss), its backward (autograd:
the recompute of every checkpointed layer, then the gradients) and the
AdamW update, each timed with CUDA events; the recompute is one more
forward, so backward minus forward is the gradients' own time.

Prints per unit (tick, prefill, decode step, train step) the wall time of the timed
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


def _serve(arch: str, n_layers: int | None = None,
           n_decode: int = 8) -> None:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models.registry import (WHISPER_FRAMES, get_config,
                                             get_model)

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    B, S = 4, (4 if cfg.family == "encdec" else 512)
    api = get_model(cfg)
    model = api.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                                       dtype=torch.long, device="cuda")}
    n_vis = cfg.n_vis_tokens if cfg.family == "vlm" else 0
    n_pre = {"vlm": n_vis, "encdec": WHISPER_FRAMES}.get(cfg.family)
    if n_pre:
        key = "vis_embeds" if cfg.family == "vlm" else "frames"
        batch[key] = torch.as_tensor(rng.standard_normal(
            (B, n_pre, cfg.d_model)), dtype=torch.float32, device="cuda")
    max_len = n_vis + S + 32
    label = (f"{arch}{'' if n_layers is None else f' ({n_layers} layers)'} "
             f"serving [{B} x {S} tokens"
             + (f", {n_pre} {'patches' if n_vis else 'frames'}]"
                if n_pre else "]"))
    _report(f"{label} prefill", lambda: api.prefill(model, batch, max_len),
            1, "wave")
    _, cache = api.prefill(model, batch, max_len)
    nxt = batch["tokens"][:, -1:]

    def decode():
        for i in range(n_decode):
            api.decode(model, cache, nxt, n_vis + S + i)
    _report(f"{label} decode", decode, n_decode, "step")
    del model, cache
    torch.cuda.empty_cache()


def _train(arch: str, n_layers: int | None = None, B: int = 2,
           S: int = 4096) -> None:
    import dataclasses

    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train.optim import AdamW, apply_updates, warmup_cosine
    from repro_torch.train.step import make_loss_fn, make_train_step

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    api = get_model(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(0),
                      trainable=True)
    opt = AdamW(lr=warmup_cosine(3e-4, warmup=2, total=8))
    state = [params, opt.init(params)]
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B)
    batch = {k: torch.as_tensor(v, dtype=torch.long, device="cuda")
             for k, v in pipe.batch(0).items()}
    step = make_train_step(api, opt)

    def run():
        state[:] = step(*state, batch)[:2]
    label = (f"{arch}{'' if n_layers is None else f' ({n_layers} layers)'} "
             f"train [{B} x {S} tokens]")
    _report(f"{label} step", run, 1, "step")

    # the step's parts, each timed with CUDA events over 3 steps
    loss_fn = make_loss_fn(api)
    parts = {"forward": 0.0, "backward": 0.0, "update": 0.0}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for _ in range(3):
        p, o = state
        ev[0].record()
        loss, _ = loss_fn(p, batch)
        ev[1].record()
        names, leaves = zip(*p.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        ev[2].record()
        with torch.no_grad():
            upd, o, _ = opt.update(grads, o, p)
            state[:] = [apply_updates(p, upd), o]
        ev[3].record()
        torch.cuda.synchronize()
        for i, k in enumerate(parts):
            parts[k] += ev[i].elapsed_time(ev[i + 1]) / 3
        del loss, grads, upd
    print(f"{label} by part (CUDA events, ms): forward {parts['forward']:.3f}"
          f", backward {parts['backward']:.3f} (of which the recompute is "
          f"~one forward; gradients alone ~"
          f"{parts['backward'] - parts['forward']:.3f}), update "
          f"{parts['update']:.3f}")
    del state[:]
    torch.cuda.empty_cache()


def _fleet() -> None:
    from repro_torch.streams import (FleetRunner, bench_fleet,
                                     campaign_fleet, compile_fleet)

    n_ticks = int(SECONDS / DT)
    runner = FleetRunner()
    sims = compile_fleet(bench_fleet(), device="cpu")
    for policy, solver in (("tcp", "sort"), ("appaware", "waterfill")):
        def run():
            runner.run(sims, policy, seconds=SECONDS, dt=DT, solver=solver)
        run()
        st = runner.last_stats
        _report(f"fleet bench_fleet [{len(sims)} scenarios, "
                f"{st['n_buckets']} buckets, rows {st['rows']}] "
                f"{policy}/{solver}", run, n_ticks, "fleet tick")
    camp = compile_fleet(campaign_fleet(1024), device="cpu")

    def campaign():
        runner.run_campaign(camp, "appaware", seconds=SECONDS, dt=DT,
                            solver="waterfill", chunk_rows=256)
    campaign()
    st = runner.last_stats
    _report(f"campaign [{len(camp)} scenarios, {st['n_chunks']} chunks, "
            f"rows {st['rows']}] appaware/waterfill", campaign,
            st["n_chunks"] * n_ticks, "chunk tick")


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
    from repro_torch.models.registry import list_archs

    args = sys.argv[1:] or ["sim", "fleet", "serve"]
    parts = [a for a in args if a in ("sim", "fleet", "serve", "train")]
    archs = [a for a in args if a not in parts]
    unknown = {a for a in archs if a.split(":")[0] not in list_archs()}
    if archs and "serve" not in parts and "train" not in parts:
        unknown |= set(archs)
    if unknown:
        print(f"port_profile: unknown parts {sorted(unknown)}",
              file=sys.stderr)
        return 2
    n_ticks = int(SECONDS / DT)
    if "sim" in parts:
        for cell, sim in _cells():
            F, L = sim.R.shape
            for policy, solver in (("tcp", "sort"),
                                   ("appaware", "waterfill")):
                _report(f"{cell} [{F} flows x {L} links] {policy}/{solver}",
                        lambda: simulate(sim, policy, seconds=SECONDS, dt=DT,
                                         solver=solver), n_ticks, "tick")
    if "fleet" in parts:
        _fleet()
    if "serve" in parts:
        for arch in archs or ["zamba2-1.2b", "yi-6b"]:
            name, _, layers = arch.partition(":")
            _serve(name, int(layers) if layers else None)
    if "train" in parts:
        for arch in archs or ["zamba2-1.2b"]:
            name, _, layers = arch.partition(":")
            _train(name, int(layers) if layers else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
