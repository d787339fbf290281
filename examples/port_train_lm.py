"""End-to-end training on the PyTorch port: train an LM for a few hundred
steps with the fault-tolerant driver, async checkpointing, restart from a
checkpoint after an injected failure, on any registered architecture at a
reduced size.

    PYTHONPATH=src python examples/port_train_lm.py --arch qwen1.5-0.5b \
        --steps 300 --preset small [--device cpu]
    PYTHONPATH=src python examples/port_train_lm.py --preset 100m --steps 50

Presets: small (~3M params), 100m (~100M params). The weights are the
driver's default init, drawn from a ``torch.Generator`` seeded 0; the
``reduced()`` configs compute in float32.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_config, get_model
from repro_torch.train.driver import DriverConfig, TrainDriver
from repro_torch.train.optim import AdamW, warmup_cosine

PRESETS = {
    "small": dict(d_model=128, n_layers=4, n_heads=4, n_kv_heads=4,
                  d_ff=512, vocab=512, head_dim=None),
    "100m": dict(d_model=640, n_layers=12, n_heads=10, n_kv_heads=10,
                 d_ff=2560, vocab=32768, head_dim=None),
}


def main(argv: list[str] | None = None) -> TrainDriver:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="build/port_train_lm")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="step at which to inject a failure (tests restart)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced(**PRESETS[args.preset])
    api = get_model(cfg, device=dev)
    n = api.count_params()
    print(f"arch={args.arch} preset={args.preset} params={n / 1e6:.1f}M")

    opt = AdamW(lr=warmup_cosine(3e-3, warmup=20, total=args.steps))
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch)

    extra = None
    if cfg.family == "vlm":
        vis = np.zeros((args.batch, cfg.n_vis_tokens, cfg.d_model),
                       np.float32)
        extra = lambda step: {"vis_embeds": vis}  # noqa: E731
    if cfg.family == "encdec":
        fr = np.zeros((args.batch, 64, cfg.d_model), np.float32)
        extra = lambda step: {"frames": fr}  # noqa: E731

    dcfg = DriverConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir)
    drv = TrainDriver(
        api, opt, pipe, dcfg,
        failure_at={args.inject_failure} if args.inject_failure >= 0 else None,
        extra_batch=extra)
    t0 = time.time()
    _, _, step = drv.run()
    dt = time.time() - t0
    losses = [m["loss"] for m in drv.metrics]
    print(f"finished {step} steps in {dt:.1f}s "
          f"({dt / max(len(losses), 1):.2f}s/step)")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(uniform baseline {np.log(cfg.vocab):.3f})")
    for s, e in drv.events:
        print(f"  event@{s}: {e}")
    return drv


if __name__ == "__main__":
    main()
