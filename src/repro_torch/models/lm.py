"""Decoder LM for the dense, moe, ssm, hybrid and vlm families, as
``nn.Module``s (the encdec family is ``repro_torch.models.whisper``).

The JAX package's ``repro.models.lm`` keeps one stacked parameter tree and
scans over layers; here each layer is a module of its own and the layers
run in a Python loop. Parameter names are the JAX tree's keys (``embed``,
``final_norm.w``, ``groups.0.3.mamba.in_proj``, ``shared.attn.wq``, …),
held per layer instead of stacked on a leading axis.

Families:
  dense  — pre-norm GQA attention + (SwiGLU|GELU) MLP
  moe    — attention + top-k MoE FFN (sort-based capacity dispatch)
  ssm    — Mamba2/SSD blocks (attention-free)
  hybrid — Zamba2-style: Mamba2 backbone with one *shared* attention+MLP
           block applied every ``hybrid_attn_every`` layers
  vlm    — dense backbone with a prepended (stubbed) patch-embedding prefix
  encdec — whisper (``repro_torch.models.whisper``), served through the
           same registry

Kernels: every prefill (and training-style forward) application of an
attention block runs the flash-attention kernel at every sequence length
(the JAX package's switch to ``blockwise_gqa_attend`` at S >= 8192 has no
counterpart), and every Mamba2 layer runs the SSD chunk kernel. Decode
attention (one query against the cache) stays ``gqa_attend`` in PyTorch
ops, as the JAX package leaves it to XLA.

Weights: a serving model (``LM(cfg, tree)``) holds the weights that the
JAX package casts to ``cfg.dtype`` where it uses them cast once, when the
module is built; the ones it reads in float32 stay float32: the norm
weights (qk-norm's too), ``A_log``, ``D``, ``dt_bias`` and ``norm_w``.
:func:`init_params` casts each weight as it is drawn, so the float32 tree
never exists whole on the device. A trainable model (``LM(cfg, tree,
trainable=True)``) keeps every weight in float32 with ``requires_grad``, as
the JAX package keeps its master weights; the blocks cast at use, so
compute still runs in ``cfg.dtype``.

:func:`forward` is the training forward (differentiable; with ``cfg.remat``
each layer, and each application of a hybrid's shared block, runs under
``torch.utils.checkpoint``, as the JAX package wraps each layer in
``jax.checkpoint``). ``prefill`` and ``decode_step`` run under
``torch.no_grad``. Decode updates the cache tensors in place (the JAX
package returns new ones), so a cache is not reused after a later step.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.local import as_dtensor, unsplit
from repro_torch.models import blocks as B
from repro_torch.models.blocks import ParamSpec
from repro_torch.sharding import policy
from repro_torch.sharding.policy import shard_as

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")
# norm weight dicts (whisper's too)
_NORMS = ("ln1", "ln2", "ln_x", "norm", "final_norm", "enc_norm")
# read in float32
_F32_KEYS = ("A_log", "D", "dt_bias", "norm_w", "q_norm", "k_norm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | encdec
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
    qk_norm: bool = False        # qwen3-style per-head q/k RMSNorm
    rope_theta: float | None = 10000.0
    causal: bool = True
    tie_embeddings: bool = True
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ssm
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssd_chunk: int = 128
    # hybrid
    hybrid_attn_every: int = 0
    # encdec (whisper)
    n_enc_layers: int = 0
    # vlm
    n_vis_tokens: int = 0
    # execution
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    sub_quadratic: bool = False  # supports 500k-token decode

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
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            hybrid_attn_every=3 if self.hybrid_attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_vis_tokens=min(self.n_vis_tokens, 8),
            dtype=torch.float32,
        )
        small.update(over)
        return dataclasses.replace(self, **small)


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the port serves "
                         f"{', '.join(FAMILIES)}")
    if cfg.family == "encdec":
        raise ValueError("the encdec family is served by "
                         "repro_torch.models.whisper, not the decoder LM")


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
    """The normed activations, which go on to projections. Under a policy
    that shards the residual stream's sequence ("act_seq": sequence
    parallelism) they are gathered along it here, as before a
    column-parallel matmul: DTensor (torch 2.11) cannot flatten a batch
    and a sequence dim that are both sharded, which a 3-D matmul does."""
    if cfg.norm == "layernorm":
        y = B.layer_norm(x, p["w"], p["b"])
    else:
        y = B.rms_norm(x, p["w"])
    return shard_as(y, "batch", "seq", "embed_act")


def _attn_specs(cfg):
    s = B.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                     cfg.qkv_bias)
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((cfg.hd,), (None,), "ones")
        s["k_norm"] = ParamSpec((cfg.hd,), (None,), "ones")
    return s


def layer_specs(cfg) -> dict:
    _check_family(cfg)
    if cfg.family == "ssm":
        return {
            "norm": _norm_specs(cfg),
            "mamba": B.mamba2_specs(cfg.d_model, cfg.ssm_state,
                                    cfg.ssm_head_dim, cfg.ssm_expand,
                                    cfg.ssm_conv),
        }
    s = {
        "ln1": _norm_specs(cfg),
        "attn": _attn_specs(cfg),
        "ln2": _norm_specs(cfg),
    }
    if cfg.family == "moe":
        s["moe"] = B.moe_specs(cfg.d_model, cfg.d_ff, cfg.n_experts)
    else:
        s["mlp"] = B.mlp_specs(cfg.d_model, cfg.d_ff, cfg.act)
    return s


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
    if cfg.family == "vlm":
        # stubbed modality frontend: a trained projection of precomputed
        # patch embeddings into the LM's embedding space
        s["vis_proj"] = ParamSpec((cfg.d_model, cfg.d_model),
                                  ("embed", "embed_act"), "small")
    return s


def abstract_params(cfg):
    return B.abstract_params(model_specs(cfg))


def param_axes(cfg):
    return B.spec_axes(model_specs(cfg))


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
def leaf_dtype(cfg, path) -> torch.dtype:
    """The dtype a module holds the weight at ``path`` (its keys in the
    parameter tree) in: float32 for the norms and the weights the JAX
    package reads in float32, else ``cfg.dtype``."""
    if path[-1] in _F32_KEYS or any(k in _NORMS for k in path):
        return torch.float32
    return cfg.dtype


def _param(v: torch.Tensor, dtype, trainable: bool) -> nn.Parameter:
    """A weight as a module holds it: float32 with a gradient when
    ``trainable``, else cast to ``dtype`` without one."""
    if trainable:
        return nn.Parameter(v.to(torch.float32), requires_grad=True)
    return nn.Parameter(v.to(dtype), requires_grad=False)


def _param_dict(tree: dict, dtype, keep_f32: bool,
                trainable: bool = False) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: _param(v, torch.float32 if keep_f32 or k in _F32_KEYS else dtype,
                  trainable)
        for k, v in tree.items()})


class _Layer(nn.ModuleDict):
    """One layer's parameter dicts, indexed like the JAX tree
    (``p["attn"]["wq"]``), so the block functions take it as ``p``."""

    def __init__(self, tree: dict, dtype, trainable: bool = False):
        super().__init__({name: _param_dict(sub, dtype, name in _NORMS,
                                            trainable)
                          for name, sub in tree.items()})


class Mamba2Layer(_Layer):
    """An SSM layer: ``norm`` {w} and ``mamba`` {in_proj, conv_w, conv_b,
    A_log, D, dt_bias, norm_w, out_proj}."""


class DenseLayer(_Layer):
    """An attention + MLP layer (also the hybrid's shared block and a
    whisper encoder layer): ``ln1``, ``attn`` {wq, wk, wv, wo[, bq, bk, bv]
    [, q_norm, k_norm]}, ``ln2``, ``mlp``."""


class MoELayer(_Layer):
    """An attention + MoE layer: ``ln1``, ``attn``, ``ln2``, ``moe``
    {router [D,E], w_gate, w_up [E,D,F], w_down [E,F,D]}."""


class LM(nn.Module):
    """The model's parameters, built from a tree in the layout of
    :func:`model_specs` (float32 tensors, as :func:`init_params` and
    ``convert.params_from_jax`` make them): cast for serving, or float32
    with gradients when ``trainable``. Calling it runs :func:`forward`."""

    def __init__(self, cfg: ModelConfig, tree: dict, trainable: bool = False):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.trainable = trainable
        dt = cfg.dtype
        self.embed = _param(tree["embed"], dt, trainable)
        self.final_norm = _param_dict(tree["final_norm"], dt, True, trainable)
        self.unembed = (_param(tree["unembed"], dt, trainable)
                        if "unembed" in tree else None)
        self.vis_proj = (_param(tree["vis_proj"], dt, trainable)
                         if "vis_proj" in tree else None)
        if cfg.family == "hybrid":
            self.groups = nn.ModuleList(
                nn.ModuleList(Mamba2Layer(p, dt, trainable) for p in g)
                for g in tree["groups"])
            self.shared = DenseLayer(tree["shared"], dt, trainable)
            self.tail = nn.ModuleList(Mamba2Layer(p, dt, trainable)
                                      for p in tree.get("tail", []))
        else:
            cls = {"ssm": Mamba2Layer, "moe": MoELayer}.get(cfg.family,
                                                            DenseLayer)
            self.layers = nn.ModuleList(cls(p, dt, trainable)
                                        for p in tree["layers"])

    def forward(self, tokens, vis_embeds=None):
        return forward(self.cfg, self, tokens, vis_embeds)


def init_params(cfg, generator: torch.Generator, device,
                trainable: bool = False) -> LM:
    """Random weights from ``generator`` on ``device``, with the JAX
    package's init distributions, each cast as it is drawn (kept float32
    when ``trainable``)."""
    def finish(path, w):
        return w if trainable else w.to(leaf_dtype(cfg, path))
    return LM(cfg, B.build_params(generator, model_specs(cfg), device,
                                  finish), trainable)


def nest(named: dict) -> dict:
    """The tree of a model from its ``named_parameters`` names
    (``groups.0.3.mamba.in_proj`` -> tree["groups"][0][3]["mamba"]
    ["in_proj"]): integer keys become lists."""
    tree: dict = {}
    for name, t in named.items():
        node, keys = tree, name.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def rebuild(model: nn.Module, tensors: dict) -> nn.Module:
    """A model of ``model``'s class, config and trainability holding
    ``tensors`` (by parameter name; float32 tensors are not copied)."""
    return type(model)(model.cfg, nest(tensors), trainable=model.trainable)


# --------------------------------------------------------------------------
# blocks (single layer)
# --------------------------------------------------------------------------
def _maybe_qk_norm(cfg, p, q, k):
    """Qwen3's per-head q/k RMSNorm, after RoPE as the JAX package applies
    it (``qkv_proj`` rotates first)."""
    if cfg.qk_norm:
        q = B.rms_norm(q, p["q_norm"])
        k = B.rms_norm(k, p["k_norm"])
    return q, k


def _attn_block(cfg, p, x, positions):
    h = _apply_norm(cfg, p["ln1"], x)
    q, k, v = B.qkv_proj(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                         cfg.rope_theta, positions)
    q, k = _maybe_qk_norm(cfg, p["attn"], q, k)
    q = shard_as(q, "batch", "seq", "heads", None)
    o = flash_attention(q, k, v, causal=cfg.causal)
    o = B.out_proj(o, p["attn"]["wo"])
    return x + shard_as(o, "batch", "act_seq", "embed_act"), (k, v)


def _attn_block_decode(cfg, p, x, cache_k, cache_v, pos: int):
    """One query against a ring-buffer KV cache ([B,T,K,hd], updated in
    place at slot ``pos % T``)."""
    h = _apply_norm(cfg, p["ln1"], x)
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    q, k_new, v_new = B.qkv_proj(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.rope_theta, positions)
    q, k_new = _maybe_qk_norm(cfg, p["attn"], q, k_new)
    T = cache_k.shape[1]
    slot = pos % T
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    valid = (torch.arange(T, device=x.device) <= pos)[None, None, None, None]
    o = B.gqa_attend(q, cache_k.to(x.dtype), cache_v.to(x.dtype), valid)
    return x + B.out_proj(o, p["attn"]["wo"]), (cache_k, cache_v)


def _ffn_block(cfg, p, x):
    """Returns (x, aux): the MoE load-balancing loss, or None."""
    h = _apply_norm(cfg, p["ln2"], x)
    if cfg.family == "moe":
        o, aux = B.moe_ffn(p["moe"], h, cfg.n_experts, cfg.top_k,
                           cfg.capacity_factor)
    else:
        o, aux = B.mlp(p["mlp"], h, cfg.act), None
    return x + shard_as(o, "batch", "act_seq", "embed_act"), aux


def dense_layer(cfg, p, x, positions):
    """Returns (x, (k, v), aux)."""
    x, kv = _attn_block(cfg, p, x, positions)
    x, aux = _ffn_block(cfg, p, x)
    return x, kv, aux


def ssm_layer(cfg, p, x):
    h = _apply_norm(cfg, p["norm"], x)
    o, _ = B.mamba2_forward(p["mamba"], h, cfg, chunk=cfg.ssd_chunk)
    return x + shard_as(o, "batch", "act_seq", "embed_act")


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
def _embed(cfg, params, tokens, vis_embeds=None):
    """Token embeddings [B,S,D]; for vlm the projected patch embeddings
    [B,n_vis,D] come first: [B,n_vis+S,D]."""
    x = B.embed_rows(B.tied(params.embed), tokens, cfg.dtype)
    if cfg.family == "vlm":
        if vis_embeds is None:
            raise ValueError("vlm needs patch embeddings (vis_embeds)")
        v = vis_embeds.to(cfg.dtype) @ params.vis_proj.to(cfg.dtype)
        if isinstance(x, DTensor):
            # patch and token embeddings in the token embeddings' layout
            # with the sequence whole (the prefix shifts every sequence
            # shard), so that each rank concatenates its own shards
            mesh, pl = x.device_mesh, unsplit(x.placements, 1)
            x = x.redistribute(mesh, pl)
            v = as_dtensor(v, mesh).redistribute(mesh, pl)
        x = B.seq_op(lambda x, v: torch.cat([v, x], dim=1), x, v)
    return shard_as(x, "batch", "act_seq", "embed_act")


def unembed_matrix(cfg, params):
    """[D, V] output projection (tied or untied), in ``cfg.dtype``."""
    w = B.tied(params.embed).T if cfg.tie_embeddings else params.unembed
    return w.to(cfg.dtype)


def _logits(cfg, params, x):
    x = _apply_norm(cfg, params.final_norm, x)
    return shard_as(x @ unembed_matrix(cfg, params), "batch", "seq", "vocab")


def remat(cfg, fn, x, *args):
    """``fn(x, *args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``
    is set and autograd records ``x``: only the inputs are kept, and the
    backward runs ``fn`` again (its kernels too). The model draws no random
    numbers, so no RNG state is stashed. The recompute runs under the
    sharding policy of the forward (``policy.bound``)."""
    if cfg.remat and torch.is_grad_enabled() and x.requires_grad:
        return checkpoint(policy.bound(fn), x, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(x, *args)


def _dense_remat(cfg, p, x, positions):
    """A dense or MoE layer without its (k, v): (x, aux or None)."""
    x, _, aux = dense_layer(cfg, p, x, positions)
    return x, aux


def forward(cfg, params: LM, tokens, vis_embeds=None,
            return_aux: bool = False, return_hidden: bool = False):
    """Training forward: tokens [B,S] -> logits [B,S(+vis),V]; with
    ``return_aux`` (logits, aux), aux being the MoE loss summed over layers
    (float32, 0 for the other families). ``return_hidden`` returns the
    JAX forward's (final-normed hidden [B,S(+vis),D], aux) instead: the
    chunked-loss path never materialises [B,S,V]. Differentiable; under
    ``torch.no_grad`` it builds no graph and no checkpoint."""
    x = _embed(cfg, params, tokens, vis_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        for p in params.layers:
            x = remat(cfg, functools.partial(ssm_layer, cfg, p), x)
    elif cfg.family == "hybrid":
        for group in params.groups:
            for p in group:
                x = remat(cfg, functools.partial(ssm_layer, cfg, p), x)
            x, _ = remat(cfg, functools.partial(_dense_remat, cfg,
                                                params.shared), x, positions)
        for p in params.tail:
            x = remat(cfg, functools.partial(ssm_layer, cfg, p), x)
    else:
        for p in params.layers:
            x, aux_l = remat(cfg, functools.partial(_dense_remat, cfg, p), x,
                             positions)
            if aux_l is not None:
                aux = aux + aux_l
    if return_hidden:
        return _apply_norm(cfg, params.final_norm, x), aux
    logits = _logits(cfg, params, x)
    return (logits, aux) if return_aux else logits


def _zeros(name: str, shape, dtype, device) -> torch.Tensor:
    """A decode-cache buffer: ``init_cache``'s default ``zeros``."""
    return torch.zeros(shape, dtype=dtype, device=device)


def init_cache(cfg, batch: int, max_len: int, *, device,
               zeros=None) -> dict:
    """Decode caches, stacked on the layer axis as in the JAX package:
    ssm {conv [L,B,k-1,C], ssm [L,B,H,P,N] f32}; dense {k, v [L,B,T,K,hd]};
    hybrid {groups: ssm with [G, per] leading axes, shared: kv with [G],
    tail: ssm}; conv and KV in ``cfg.dtype``. Each buffer is
    ``zeros(name, shape, dtype, device)`` (``torch.zeros`` unless given:
    ``launch.shardings.cache_zeros`` places it on a mesh)."""
    zeros = zeros or _zeros
    _check_family(cfg)
    dtype = cfg.dtype
    K, hd = cfg.n_kv_heads, cfg.hd
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim if cfg.ssm_state else 0
    conv_dim = d_inner + 2 * cfg.ssm_state

    def kv(*lead):
        return {n: zeros(n, (*lead, batch, max_len, K, hd), dtype, device)
                for n in ("k", "v")}

    def ssm(*lead):
        return {
            "conv": zeros("conv", (*lead, batch, cfg.ssm_conv - 1, conv_dim),
                          dtype, device),
            "ssm": zeros("ssm", (*lead, batch, H, cfg.ssm_head_dim,
                                 cfg.ssm_state), torch.float32, device),
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
def prefill(cfg, params: LM, tokens, max_len: int, vis_embeds=None):
    """Full-sequence forward that also fills the decode cache.

    Returns (logits [B,1,V] at the last position, cache); KV buffers hold
    ``max_len`` positions (for vlm the patch prefix takes the first
    ``n_vis``)."""
    x = _embed(cfg, params, tokens, vis_embeds)
    Bsz, S = x.shape[0], x.shape[1]
    if S > max_len:
        raise ValueError(f"prompt of {S} positions exceeds max_len "
                         f"{max_len}")
    if cfg.family in ("ssm", "hybrid") and S < cfg.ssm_conv - 1:
        raise ValueError(f"prompt of {S} tokens is shorter than the conv "
                         f"state ({cfg.ssm_conv - 1})")
    positions = torch.arange(S, device=x.device)[None, :]
    # (imported here: launch.shardings imports this module)
    from repro_torch.launch.shardings import cache_zeros
    cache = init_cache(cfg, Bsz, max_len, device=x.device,
                       zeros=cache_zeros(x))

    def run_ssm(layers, c):
        nonlocal x
        for i, p in enumerate(layers):
            x, (conv, h) = ssm_layer_prefill(cfg, p, x)
            c["conv"][i] = conv
            c["ssm"][i] = h

    def run_dense(p, c, i):
        nonlocal x
        x, (k, v), _ = dense_layer(cfg, p, x, positions)
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
    """One decode step. tokens [B,1]; pos: the absolute position (int,
    counting a vlm's patch prefix). Returns (logits [B,1,V], cache), the
    cache updated in place."""
    pos = int(pos)
    x = B.embed_rows(params.embed, tokens, cfg.dtype)

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
        x, _ = _ffn_block(cfg, p, x)

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
