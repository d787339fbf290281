"""Plain PyTorch version of flash attention (GQA, optional causal mask).

:func:`attention_plain` is the counterpart of the JAX package's oracle
``attention_ref``: the whole [S, T] score matrix in float32, the softmax
over it, and the output cast back to q's dtype. The wrapper
(``ops.py``) runs it for CPU tensors; on the card it is the yardstick the
CUDA kernel is held to.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_plain(q, k, v, causal: bool = True) -> torch.Tensor:
    """q: [B,H,S,hd]; k, v: [B,K,T,hd] with H = K·G. Returns [B,H,S,hd]
    in q's dtype (float32 softmax). The KV heads are never repeated: query
    head h reads KV head h // G."""
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, S, hd).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(B, H, S, hd).to(q.dtype)
