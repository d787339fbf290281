"""Synthetic data pipeline: deterministic, host-shardable token streams (a
copy of the JAX package's ``repro.data.pipeline``, numpy only, giving the
same bits from the same seeds).

Two generators:
  * ``random``     — i.i.d. uniform tokens (throughput/dry-run work);
  * ``structured`` — a noisy affine-progression language (next ≈ a·cur+b
    mod V with replacement noise): has learnable structure, so example
    training runs show a visibly decreasing loss.

Sharding: each host materializes only its slice of the global batch
(``host_slice``), keyed by (seed, step, host_id) — restart-safe (the
pipeline is stateless; step index determines content, so checkpoint
restores resume the exact stream).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structured: bool = True
    noise: float = 0.1
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.host_id)
        B, S, V = self.host_batch, self.seq_len, self.vocab
        if not self.structured:
            tokens = rng.integers(0, V, (B, S + 1), dtype=np.int64)
        else:
            a = 31
            b = rng.integers(1, 17, (B, 1))
            t0 = rng.integers(0, V, (B, 1))
            # affine progression t_{i+1} = a·t_i + b (mod V), via closed form
            # t_i = a^i t_0 + b·(a^i − 1)/(a − 1) (mod V); powers iteratively
            ai = np.empty(S + 1, dtype=np.int64)
            ai[0] = 1
            for i in range(1, S + 1):
                ai[i] = (ai[i - 1] * a) % V
            ai = ai[None, :]
            inv = pow(a - 1, -1, V) if np.gcd(a - 1, V) == 1 else 1
            geo = ((ai - 1) * inv) % V
            tokens = (ai * t0 + geo * b) % V
            flip = rng.random((B, S + 1)) < self.noise
            tokens = np.where(flip, rng.integers(0, V, (B, S + 1)), tokens)
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    def batches(self, n: int, start: int = 0):
        for i in range(start, start + n):
            yield self.batch(i)
