"""Model building blocks — plain functions over tensors, with the names and
signatures of the JAX package's ``repro.models.blocks``, so that the tests
compare them one to one.

Conventions, as in the JAX package:
  * a parameter set is a mapping of name -> tensor (a dict, or the
    ``nn.ParameterDict`` of a layer module); compute runs in the input's
    dtype, and each weight is cast to it where it is used (``.to(dt)`` is
    free when the weight was cast once at load);
  * attention and SSD internals run in float32 where the JAX package does.

The SSD core of :func:`mamba2_forward` goes through
:func:`repro_torch.kernels.ssd_scan.ops.ssd_scan` (the chunk kernel plus the
inter-chunk recurrence) instead of repeating the JAX package's in-line chunk
scan.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan

NEG_INF = -1e30


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"   # normal | zeros | ones | small
    scale: float = 0.02


def _leaves(tree) -> list[ParamSpec]:
    if isinstance(tree, ParamSpec):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for sub in items for leaf in _leaves(sub)]


def build_params(generator: torch.Generator, specs, device) -> Any:
    """A tree of float32 tensors on ``device`` in the layout of ``specs``
    (nested dicts and lists of :class:`ParamSpec`), drawn from
    ``generator`` leaf by leaf in tree order: normal·scale, "small" =
    normal·scale/√(last dim), zeros or ones."""
    def build(s):
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, list):
            return [build(v) for v in s]
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=torch.float32, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=torch.float32, device=device)
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        if s.init == "small":
            return w * (s.scale / math.sqrt(max(s.shape[-1], 1)))
        return w * s.scale
    return build(specs)


def count_specs(specs) -> int:
    """Number of scalar parameters in a spec tree."""
    return sum(math.prod(s.shape) for s in _leaves(specs))


# --------------------------------------------------------------------------
# norms & activations
# --------------------------------------------------------------------------
def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * weight + bias).to(dt)


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    """log(1 + exp(x)) with no cut-over threshold, as ``jax.nn.softplus``
    (``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., S, n_heads, head_dim]; positions: [..., S]. Rotates the two
    halves of the head dim (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    angles = positions[..., None].float() * freqs            # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                    # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.tensor_split(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA, grouped einsums — repeated KV is never materialized)
# --------------------------------------------------------------------------
def attn_specs(d_model: int, n_heads: int, n_kv: int, head_dim: int,
               qkv_bias: bool = False) -> dict:
    s = {
        "wq": ParamSpec((d_model, n_heads, head_dim), ("embed", "heads", None)),
        "wk": ParamSpec((d_model, n_kv, head_dim), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d_model, n_kv, head_dim), ("embed", "kv_heads", None)),
        "wo": ParamSpec((n_heads, head_dim, d_model), ("heads", None, "embed")),
    }
    if qkv_bias:
        s["bq"] = ParamSpec((n_heads, head_dim), ("heads", None), "zeros")
        s["bk"] = ParamSpec((n_kv, head_dim), ("kv_heads", None), "zeros")
        s["bv"] = ParamSpec((n_kv, head_dim), ("kv_heads", None), "zeros")
    return s


def _heads_proj(x, w):
    """"bsd,dhk->bshk" as one matmul; the result is contiguous."""
    D, nh, hd = w.shape
    return (x @ w.to(x.dtype).reshape(D, nh * hd)).view(*x.shape[:-1], nh, hd)


def qkv_proj(p, x, n_heads: int, n_kv: int, rope_theta: float | None,
             positions):
    """x: [B,S,D] -> q [B,S,H,hd], k/v [B,S,K,hd] (+bias, +RoPE)."""
    dt = x.dtype
    q = _heads_proj(x, p["wq"])
    k = _heads_proj(x, p["wk"])
    v = _heads_proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def out_proj(o, wo):
    """"bshk,hkd->bsd" as one matmul."""
    nh, hd, D = wo.shape
    return o.reshape(*o.shape[:-2], nh * hd) @ wo.to(o.dtype).reshape(
        nh * hd, D)


def gqa_attend(q, k, v, mask):
    """Grouped-query attention core (softmax in float32).

    q: [B,S,H,hd], k/v: [B,T,K,hd] with H = K·G. mask: broadcastable to
    [B,1,1,S,T] (True = attend). Returns [B,S,H,hd].
    """
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    q = q.reshape(B, S, K, G, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) * scale  # [B,K,G,S,T]
    scores = torch.where(mask, scores.float(), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, hd)


def causal_mask(S: int, T: int, offset: int = 0, device=None):
    """True where query i (at absolute pos offset+i) may attend key j."""
    i = torch.arange(S, device=device)[:, None] + offset
    j = torch.arange(T, device=device)[None, :]
    return (j <= i)[None, None, None]


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def mlp_specs(d_model: int, d_ff: int, act: str = "swiglu") -> dict:
    if act == "swiglu":
        return {
            "w_gate": ParamSpec((d_model, d_ff), ("embed", "mlp"), "small"),
            "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp"), "small"),
            "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed"), "small"),
        }
    return {  # gelu (whisper/stablelm-style 2-layer)
        "w_in": ParamSpec((d_model, d_ff), ("embed", "mlp"), "small"),
        "b_in": ParamSpec((d_ff,), ("mlp",), "zeros"),
        "w_out": ParamSpec((d_ff, d_model), ("mlp", "embed"), "small"),
        "b_out": ParamSpec((d_model,), ("embed",), "zeros"),
    }


def mlp(p, x, act: str = "swiglu"):
    dt = x.dtype
    if act == "swiglu":
        h = silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return h @ p["w_down"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_in"].to(dt) + p["b_in"].to(dt), approximate="tanh")
    return h @ p["w_out"].to(dt) + p["b_out"].to(dt)


# --------------------------------------------------------------------------
# Mamba2 / SSD (state-space duality, arXiv:2405.21060)
# --------------------------------------------------------------------------
def mamba2_specs(d_model: int, d_state: int, head_dim: int = 64,
                 expand: int = 2, d_conv: int = 4) -> dict:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state
    return {
        "in_proj": ParamSpec(
            (d_model, 2 * d_inner + 2 * d_state + n_heads),
            ("embed", "inner"), "small"),
        "conv_w": ParamSpec((d_conv, conv_dim), (None, "inner")),
        "conv_b": ParamSpec((conv_dim,), ("inner",), "zeros"),
        "A_log": ParamSpec((n_heads,), ("inner",), "zeros"),
        "D": ParamSpec((n_heads,), ("inner",), "ones"),
        "dt_bias": ParamSpec((n_heads,), ("inner",), "zeros"),
        "norm_w": ParamSpec((d_inner,), ("inner",), "ones"),
        "out_proj": ParamSpec((d_inner, d_model), ("inner", "embed"), "small"),
    }


def _ssd_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads


def causal_conv1d(x, w, b):
    """Depthwise causal conv. x: [B,S,C], w: [k,C]."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    return out + b[None, None, :]


def mamba2_forward(p, x, cfg, chunk: int = 128, return_state: bool = False):
    """SSD block, full sequence. x: [B,S,D] -> [B,S,D].

    The SSD core (float32) runs through ``ssd_scan``: the chunk kernel,
    then the inter-chunk recurrence. With ``return_state`` also returns
    ``(conv_state, ssm_state)`` for decode continuation.
    """
    dt_ = x.dtype
    B, S, D = x.shape
    d_inner, H = _ssd_dims(cfg)
    N = cfg.ssm_state
    P_ = cfg.ssm_head_dim

    zxbcdt = x @ p["in_proj"].to(dt_)
    z, xbc, dt_raw = torch.tensor_split(
        zxbcdt, [d_inner, 2 * d_inner + 2 * N], dim=-1)
    xbc_pre = xbc
    xbc = silu(causal_conv1d(xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_)))
    xs, B_, C_ = torch.tensor_split(xbc, [d_inner, d_inner + N], dim=-1)

    xs = xs.reshape(B, S, H, P_).float()
    dt = softplus(dt_raw.float() + p["dt_bias"].float())          # [B,S,H]
    A = -torch.exp(p["A_log"].float())                            # [H]
    y, h_last = ssd_scan(xs, dt, A, B_.float(), C_.float(), chunk=chunk)
    y = y + p["D"].float()[None, None, :, None] * xs
    y = y.reshape(B, S, d_inner).to(dt_)

    y = rms_norm(y * silu(z), p["norm_w"])
    out = y @ p["out_proj"].to(dt_)
    if not return_state:
        return out, None
    k = p["conv_w"].shape[0]
    conv_state = xbc_pre[:, S - (k - 1):, :]
    return out, (conv_state, h_last)


def mamba2_decode(p, x, cfg, conv_state, ssm_state):
    """Single-token SSD recurrence. x: [B,1,D].

    conv_state: [B, d_conv-1, conv_dim]; ssm_state: [B,H,P,N].
    """
    dt_ = x.dtype
    B = x.shape[0]
    d_inner, H = _ssd_dims(cfg)
    N, P_ = cfg.ssm_state, cfg.ssm_head_dim

    zxbcdt = x[:, 0] @ p["in_proj"].to(dt_)
    z, xbc, dt_raw = torch.tensor_split(
        zxbcdt, [d_inner, 2 * d_inner + 2 * N], dim=-1)
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)
    new_conv_state = window[:, 1:]
    w = p["conv_w"].to(dt_)
    xbc = silu(torch.einsum("bkc,kc->bc", window, w) + p["conv_b"].to(dt_))
    xs, B_, C_ = torch.tensor_split(xbc, [d_inner, d_inner + N], dim=-1)

    xs = xs.reshape(B, H, P_).float()
    dt = softplus(dt_raw.float() + p["dt_bias"].float())          # [B,H]
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A[None, :])                               # [B,H]
    B_ = B_.float()
    C_ = C_.float()

    upd = torch.einsum("bh,bn,bhp->bhpn", dt, B_, xs)
    new_ssm = ssm_state * dA[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", C_, new_ssm)
    y = y + p["D"].float()[None, :, None] * xs
    y = y.reshape(B, d_inner).to(dt_)
    y = rms_norm(y * silu(z), p["norm_w"])
    return (y @ p["out_proj"].to(dt_))[:, None, :], new_conv_state, new_ssm
