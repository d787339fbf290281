"""Batched serving example on the PyTorch port: prefill + slot-based
continuous batching over a registered architecture (greedy decode).

    PYTHONPATH=src python examples/port_serve_decode.py --arch yi-6b \
        --requests 6 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.registry import get_config, get_model
from repro_torch.serve import Request, ServeEngine


def main(argv: list[str] | None = None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    api = get_model(cfg, device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(api, max_len=args.prompt_len + args.new_tokens + 8,
                      batch_slots=args.slots)
    eng.load(params)

    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                    dtype=np.int32),
                max_new_tokens=args.new_tokens)
        for _ in range(args.requests)
    ]
    t0 = time.time()
    eng.run(reqs)
    dt = time.time() - t0
    total = sum(len(r.out) for r in reqs)
    print(f"arch={args.arch} (reduced) — {len(reqs)} requests, "
          f"{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s on "
          f"{dev.type})")
    for i, r in enumerate(reqs):
        print(f"  req{i}: {r.out}")
    return reqs


if __name__ == "__main__":
    main()
