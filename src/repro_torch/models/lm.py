"""Decoder LM for the dense, ssm and hybrid families, as ``nn.Module``s.

The JAX package's ``repro.models.lm`` keeps one stacked parameter tree and
scans over layers; here each layer is a module of its own and the layers
run in a Python loop. Parameter names are the JAX tree's keys (``embed``,
``final_norm.w``, ``groups.0.3.mamba.in_proj``, ``shared.attn.wq``, …),
held per layer instead of stacked on a leading axis.

Families:
  dense  — pre-norm GQA attention + (SwiGLU|GELU) MLP
  ssm    — Mamba2/SSD blocks (attention-free)
  hybrid — Zamba2-style: Mamba2 backbone with one *shared* attention+MLP
           block applied every ``hybrid_attn_every`` layers
The moe, vlm and encdec families are not ported yet (ROADMAP A.12) and
raise ``NotImplementedError``.

Kernels: every prefill (and training-style forward) application of an
attention block runs the flash-attention kernel at every sequence length
(the JAX package's switch to ``blockwise_gqa_attend`` at S >= 8192 has no
counterpart), and every Mamba2 layer runs the SSD chunk kernel. Decode
attention (one query against the cache) stays ``gqa_attend`` in PyTorch
ops, as the JAX package leaves it to XLA.

Weights that the JAX package casts to ``cfg.dtype`` where it uses them are
cast once, when the module is built; the ones it reads in float32 stay
float32: the norm weights, ``A_log``, ``D``, ``dt_bias`` and ``norm_w``.
Decode updates the cache tensors in place (the JAX package returns new
ones), so a cache is not reused after a later step.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import blocks as B
from repro_torch.models.blocks import ParamSpec

FAMILIES = ("dense", "ssm", "hybrid")
_NORMS = ("ln1", "ln2", "norm", "final_norm")          # norm weight dicts
_F32_KEYS = ("A_log", "D", "dt_bias", "norm_w")        # read in float32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | ssm | hybrid (ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    act: str = "swiglu"
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float | None = 10000.0
    causal: bool = True
    tie_embeddings: bool = True
    # ssm
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssd_chunk: int = 128
    # hybrid
    hybrid_attn_every: int = 0
    # execution
    dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def reduced(self, **over) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the JAX package's
        ``ModelConfig.reduced``)."""
        small = dict(
            n_layers=min(self.n_layers, 4) if self.family != "hybrid" else 6,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=256,
            head_dim=16 if self.head_dim else None,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            hybrid_attn_every=3 if self.hybrid_attn_every else 0,
            dtype=torch.float32,
        )
        small.update(over)
        return dataclasses.replace(self, **small)


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP A.12); the "
            f"port serves {', '.join(FAMILIES)}")


# --------------------------------------------------------------------------
# parameter specs (per layer: lists where the JAX tree stacks)
# --------------------------------------------------------------------------
def _norm_specs(cfg, d=None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"w": ParamSpec((d,), ("embed",), "ones"),
                "b": ParamSpec((d,), ("embed",), "zeros")}
    return {"w": ParamSpec((d,), ("embed",), "ones")}


def _apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return B.layer_norm(x, p["w"], p["b"])
    return B.rms_norm(x, p["w"])


def layer_specs(cfg) -> dict:
    _check_family(cfg)
    if cfg.family == "ssm":
        return {
            "norm": _norm_specs(cfg),
            "mamba": B.mamba2_specs(cfg.d_model, cfg.ssm_state,
                                    cfg.ssm_head_dim, cfg.ssm_expand,
                                    cfg.ssm_conv),
        }
    return {
        "ln1": _norm_specs(cfg),
        "attn": B.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, cfg.qkv_bias),
        "ln2": _norm_specs(cfg),
        "mlp": B.mlp_specs(cfg.d_model, cfg.d_ff, cfg.act),
    }


def _hybrid_split(cfg) -> tuple[int, int, int]:
    """(groups, layers per group, tail layers) of a hybrid config."""
    per = cfg.hybrid_attn_every
    n_groups = cfg.n_layers // per
    return n_groups, per, cfg.n_layers - n_groups * per


def model_specs(cfg) -> dict:
    _check_family(cfg)
    s: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed")),
        "final_norm": _norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, cfg.vocab),
                                 ("embed", "vocab"), "small")
    if cfg.family == "hybrid":
        n_groups, per, rem = _hybrid_split(cfg)
        ssm = layer_specs(dataclasses.replace(cfg, family="ssm"))
        s["groups"] = [[ssm] * per for _ in range(n_groups)]
        s["shared"] = layer_specs(dataclasses.replace(cfg, family="dense"))
        if rem:
            s["tail"] = [ssm] * rem
    else:
        s["layers"] = [layer_specs(cfg)] * cfg.n_layers
    return s


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
def _param_dict(tree: dict, dtype, keep_f32: bool) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: nn.Parameter(v.to(torch.float32 if keep_f32 or k in _F32_KEYS
                             else dtype), requires_grad=False)
        for k, v in tree.items()})


class _Layer(nn.ModuleDict):
    """One layer's parameter dicts, indexed like the JAX tree
    (``p["attn"]["wq"]``), so the block functions take it as ``p``."""

    def __init__(self, tree: dict, dtype):
        super().__init__({name: _param_dict(sub, dtype, name in _NORMS)
                          for name, sub in tree.items()})


class Mamba2Layer(_Layer):
    """An SSM layer: ``norm`` {w} and ``mamba`` {in_proj, conv_w, conv_b,
    A_log, D, dt_bias, norm_w, out_proj}."""


class DenseLayer(_Layer):
    """An attention + MLP layer (also the hybrid's shared block): ``ln1``,
    ``attn`` {wq, wk, wv, wo[, bq, bk, bv]}, ``ln2``, ``mlp``."""


class LM(nn.Module):
    """The model's parameters, built from a tree in the layout of
    :func:`model_specs` (float32 tensors, as :func:`init_params` and
    ``convert.params_from_jax`` make them). Calling it runs
    :func:`forward`."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        dt = cfg.dtype
        self.embed = nn.Parameter(tree["embed"].to(dt), requires_grad=False)
        self.final_norm = _param_dict(tree["final_norm"], dt, True)
        self.unembed = (nn.Parameter(tree["unembed"].to(dt),
                                     requires_grad=False)
                        if "unembed" in tree else None)
        if cfg.family == "hybrid":
            self.groups = nn.ModuleList(
                nn.ModuleList(Mamba2Layer(p, dt) for p in g)
                for g in tree["groups"])
            self.shared = DenseLayer(tree["shared"], dt)
            self.tail = nn.ModuleList(Mamba2Layer(p, dt)
                                      for p in tree.get("tail", []))
        else:
            cls = Mamba2Layer if cfg.family == "ssm" else DenseLayer
            self.layers = nn.ModuleList(cls(p, dt) for p in tree["layers"])

    def forward(self, tokens):
        return forward(self.cfg, self, tokens)


def init_params(cfg, generator: torch.Generator, device) -> LM:
    """Random weights from ``generator`` on ``device``, with the JAX
    package's init distributions."""
    return LM(cfg, B.build_params(generator, model_specs(cfg), device))


# --------------------------------------------------------------------------
# blocks (single layer)
# --------------------------------------------------------------------------
def _attn_block(cfg, p, x, positions):
    h = _apply_norm(cfg, p["ln1"], x)
    q, k, v = B.qkv_proj(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                         cfg.rope_theta, positions)
    o = flash_attention(q, k, v, causal=cfg.causal)
    return x + B.out_proj(o, p["attn"]["wo"]), (k, v)


def _attn_block_decode(cfg, p, x, cache_k, cache_v, pos: int):
    """One query against a ring-buffer KV cache ([B,T,K,hd], updated in
    place at slot ``pos % T``)."""
    h = _apply_norm(cfg, p["ln1"], x)
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    q, k_new, v_new = B.qkv_proj(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.rope_theta, positions)
    T = cache_k.shape[1]
    slot = pos % T
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    valid = (torch.arange(T, device=x.device) <= pos)[None, None, None, None]
    o = B.gqa_attend(q, cache_k.to(x.dtype), cache_v.to(x.dtype), valid)
    return x + B.out_proj(o, p["attn"]["wo"]), (cache_k, cache_v)


def _ffn_block(cfg, p, x):
    h = _apply_norm(cfg, p["ln2"], x)
    return x + B.mlp(p["mlp"], h, cfg.act)


def dense_layer(cfg, p, x, positions):
    x, kv = _attn_block(cfg, p, x, positions)
    return _ffn_block(cfg, p, x), kv


def ssm_layer(cfg, p, x):
    h = _apply_norm(cfg, p["norm"], x)
    o, _ = B.mamba2_forward(p["mamba"], h, cfg, chunk=cfg.ssd_chunk)
    return x + o


def ssm_layer_prefill(cfg, p, x):
    h = _apply_norm(cfg, p["norm"], x)
    o, state = B.mamba2_forward(p["mamba"], h, cfg, chunk=cfg.ssd_chunk,
                                return_state=True)
    return x + o, state


def ssm_layer_decode(cfg, p, x, conv_state, ssm_state):
    h = _apply_norm(cfg, p["norm"], x)
    o, conv_state, ssm_state = B.mamba2_decode(p["mamba"], h, cfg,
                                               conv_state, ssm_state)
    return x + o, conv_state, ssm_state


# --------------------------------------------------------------------------
# full model: forward, prefill, decode
# --------------------------------------------------------------------------
def _logits(cfg, params, x):
    x = _apply_norm(cfg, params.final_norm, x)
    w = params.embed.T if cfg.tie_embeddings else params.unembed
    return x @ w.to(cfg.dtype)


@torch.no_grad()
def forward(cfg, params: LM, tokens):
    """Full-sequence forward: tokens [B,S] -> logits [B,S,V]."""
    x = params.embed.to(cfg.dtype)[tokens]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if cfg.family == "ssm":
        for p in params.layers:
            x = ssm_layer(cfg, p, x)
    elif cfg.family == "hybrid":
        for group in params.groups:
            for p in group:
                x = ssm_layer(cfg, p, x)
            x, _ = dense_layer(cfg, params.shared, x, positions)
        for p in params.tail:
            x = ssm_layer(cfg, p, x)
    else:
        for p in params.layers:
            x, _ = dense_layer(cfg, p, x, positions)
    return _logits(cfg, params, x)


def init_cache(cfg, batch: int, max_len: int, *, device) -> dict:
    """Decode caches, stacked on the layer axis as in the JAX package:
    ssm {conv [L,B,k-1,C], ssm [L,B,H,P,N] f32}; dense {k, v [L,B,T,K,hd]};
    hybrid {groups: ssm with [G, per] leading axes, shared: kv with [G],
    tail: ssm}; conv and KV in ``cfg.dtype``."""
    _check_family(cfg)
    dtype = cfg.dtype
    K, hd = cfg.n_kv_heads, cfg.hd
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim if cfg.ssm_state else 0
    conv_dim = d_inner + 2 * cfg.ssm_state

    def kv(*lead):
        return {n: torch.zeros((*lead, batch, max_len, K, hd), dtype=dtype,
                               device=device) for n in ("k", "v")}

    def ssm(*lead):
        return {
            "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((*lead, batch, H, cfg.ssm_head_dim,
                                cfg.ssm_state), dtype=torch.float32,
                               device=device),
        }

    if cfg.family == "ssm":
        return ssm(cfg.n_layers)
    if cfg.family == "hybrid":
        n_groups, per, rem = _hybrid_split(cfg)
        c = {"groups": ssm(n_groups, per), "shared": kv(n_groups)}
        if rem:
            c["tail"] = ssm(rem)
        return c
    return kv(cfg.n_layers)


@torch.no_grad()
def prefill(cfg, params: LM, tokens, max_len: int):
    """Full-sequence forward that also fills the decode cache.

    Returns (logits [B,1,V] at the last position, cache); KV buffers hold
    ``max_len`` positions."""
    x = params.embed.to(cfg.dtype)[tokens]
    Bsz, S = x.shape[0], x.shape[1]
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    if cfg.family != "dense" and S < cfg.ssm_conv - 1:
        raise ValueError(f"prompt of {S} tokens is shorter than the conv "
                         f"state ({cfg.ssm_conv - 1})")
    positions = torch.arange(S, device=x.device)[None, :]
    cache = init_cache(cfg, Bsz, max_len, device=x.device)

    def run_ssm(layers, c):
        nonlocal x
        for i, p in enumerate(layers):
            x, (conv, h) = ssm_layer_prefill(cfg, p, x)
            c["conv"][i] = conv
            c["ssm"][i] = h

    def run_dense(p, c, i):
        nonlocal x
        x, (k, v) = dense_layer(cfg, p, x, positions)
        c["k"][i, :, :S] = k
        c["v"][i, :, :S] = v

    if cfg.family == "ssm":
        run_ssm(params.layers, cache)
    elif cfg.family == "hybrid":
        for g, group in enumerate(params.groups):
            run_ssm(group, {n: t[g] for n, t in cache["groups"].items()})
            run_dense(params.shared, cache["shared"], g)
        if "tail" in cache:
            run_ssm(params.tail, cache["tail"])
    else:
        for i, p in enumerate(params.layers):
            run_dense(p, cache, i)
    return _logits(cfg, params, x[:, -1:]), cache


@torch.no_grad()
def decode_step(cfg, params: LM, cache: dict, tokens, pos):
    """One decode step. tokens [B,1]; pos: the absolute position (int).
    Returns (logits [B,1,V], cache), the cache updated in place."""
    pos = int(pos)
    x = params.embed.to(cfg.dtype)[tokens]

    def run_ssm(layers, c):
        nonlocal x
        for i, p in enumerate(layers):
            x, conv, h = ssm_layer_decode(cfg, p, x, c["conv"][i],
                                          c["ssm"][i])
            c["conv"][i] = conv
            c["ssm"][i] = h

    def run_dense(p, c, i):
        nonlocal x
        x, _ = _attn_block_decode(cfg, p, x, c["k"][i], c["v"][i], pos)
        x = _ffn_block(cfg, p, x)

    if cfg.family == "ssm":
        run_ssm(params.layers, cache)
    elif cfg.family == "hybrid":
        for g, group in enumerate(params.groups):
            run_ssm(group, {n: t[g] for n, t in cache["groups"].items()})
            run_dense(params.shared, cache["shared"], g)
        if "tail" in cache:
            run_ssm(params.tail, cache["tail"])
    else:
        for i, p in enumerate(params.layers):
            run_dense(p, cache, i)
    return _logits(cfg, params, x), cache
