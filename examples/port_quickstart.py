"""Quickstart on the PyTorch port: the two halves of the framework in one
minute.

  1. the paper's allocator beating TCP on the TrendingTopics stream app;
  2. a tiny LM training for 50 steps and decoding a few tokens.

Run:  PYTHONPATH=src python examples/port_quickstart.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_config, get_model
from repro_torch.net import big_switch
from repro_torch.serve import Request, ServeEngine
from repro_torch.streams import (compile_sim, parallelize, round_robin,
                                 simulate, trending_topics)
from repro_torch.train.optim import AdamW
from repro_torch.train.step import make_train_step


def stream_demo(dev) -> None:
    print("=== 1. SDN-style bandwidth allocation (paper Alg. 1) ===")
    g = parallelize(trending_topics(), seed=0)
    sim = compile_sim(g, big_switch(8, 1.25), round_robin(g, 8), device=dev)
    tcp = simulate(sim, "tcp", seconds=300.0, device=dev)
    aa = simulate(sim, "appaware", seconds=300.0, device=dev)
    print(f"  TCP      : {tcp.throughput_tps:7.1f} tuples/s, "
          f"latency {tcp.avg_latency_s:6.1f}s")
    print(f"  App-aware: {aa.throughput_tps:7.1f} tuples/s, "
          f"latency {aa.avg_latency_s:6.1f}s "
          f"(+{(aa.throughput_tps / tcp.throughput_tps - 1) * 100:.0f}% "
          f"throughput)")


def lm_demo(dev) -> Request:
    print("=== 2. LM training + serving (same substrate as the dry-run) ===")
    cfg = get_config("qwen1.5-0.5b").reduced(vocab=128, n_layers=2)
    api = get_model(cfg, device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0),
                      trainable=True)
    opt = AdamW(lr=3e-3)
    opt_state = opt.init(params)
    step = make_train_step(api, opt)
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=8)
    for i, b in enumerate(pipe.batches(50)):
        batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                 for k, v in b.items()}
        params, opt_state, m = step(params, opt_state, batch)
        if i % 10 == 0:
            print(f"  step {i:3d}  loss {float(m['loss']):.3f}")
    eng = ServeEngine(api, max_len=96)
    eng.load(params)
    req = Request(prompt=np.arange(8, dtype=np.int32), max_new_tokens=8)
    eng.run([req])
    print(f"  decoded: {req.out}")
    return req


def main(argv: list[str] | None = None) -> Request:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    stream_demo(dev)
    return lm_demo(dev)


if __name__ == "__main__":
    main()
