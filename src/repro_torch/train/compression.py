"""Gradient compression for cross-pod (DCN) traffic, after the JAX package's
``repro.train.compression``.

Two composable schemes:
  * top-k sparsification with error feedback (EF-SGD): only the largest
    |g| fraction crosses the slow axis; the residual accumulates locally
    and is re-injected next step;
  * int8 quantization: per-tensor max-abs scaling (8× over f32 on the wire,
    4× over bf16).

These are grad_transform hooks for ``make_train_step``; gradient trees are
dicts of tensors by parameter name (any mapping of tensors works).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.train.optim import named


# ------------------------------------------------------------------ int8
def quantize_int8(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def int8_roundtrip(tree) -> dict:
    """Simulates an int8-compressed collective payload: quantize/dequantize
    every leaf. On real DCN hardware the int8 buffer is what crosses pods."""
    def f(x):
        q, s = quantize_int8(x)
        return dequantize_int8(q, s).to(x.dtype)
    return {k: f(x) for k, x in named(tree).items()}


# ---------------------------------------------------------------- top-k EF
class EFState(NamedTuple):
    error: dict  # residual by name


def ef_init(params) -> EFState:
    return EFState(error={k: torch.zeros_like(x)
                          for k, x in named(params).items()})


def topk_ef_transform(grads, state: EFState, fraction: float = 0.01):
    """Keep the top-``fraction`` of |g + err| per leaf (every entry at or
    above the k-th largest magnitude, ``torch.topk``'s values); the rest
    becomes the next step's error. Returns (sparse_grads, new_state)."""
    kept, err = {}, {}
    for k, g in named(grads).items():
        ge = g + state.error[k]
        flat = torch.abs(ge.reshape(-1))
        n = max(int(flat.shape[0] * fraction), 1)
        thresh = torch.topk(flat, n).values[-1]
        kept[k] = ge * (torch.abs(ge) >= thresh).to(ge.dtype)
        err[k] = ge - kept[k]
    return kept, EFState(error=err)


def compressed_bytes_ratio(fraction: float, index_bits: int = 32,
                           value_bits: int = 16) -> float:
    """Wire-bytes ratio of top-k EF vs dense bf16 (for the roofline model):
    each kept value ships (index, value)."""
    dense_bits = 16.0
    sparse_bits = fraction * (index_bits + value_bits)
    return sparse_bits / dense_bits


def make_dcn_compressor(fraction: float = 0.01, int8: bool = True):
    """grad_transform factory: top-k EF (+ int8 payload simulation).
    Returns (init_state, transform(grads, state) -> (grads, state))."""
    def transform(grads, state: EFState):
        kept, state = topk_ef_transform(grads, state, fraction)
        if int8:
            kept = int8_roundtrip(kept)
        return kept, state
    return ef_init, transform
