"""Whisper-style encoder-decoder (whisper-tiny backbone), as ``nn.Module``s,
after the JAX package's ``repro.models.whisper``.

The conv/audio frontend is a stub, as there: the caller passes precomputed
frame embeddings [B, S_frames, D] (what the two conv layers would emit), and
a trained linear adapter maps them into the encoder. Positions are
sinusoidal (no learned table, so any length runs).

As in the port's ``lm.py``, each layer is a module of its own and the layers
run in a Python loop; parameter names are the JAX tree's keys
(``enc_layers.0.attn.wq``, ``dec_layers.3.xattn.bk``, ``enc_norm.b``, …).

Kernels: every prefill (and forward) attention runs the flash-attention
kernel — the encoder's self-attention and the decoder's cross-attention
non-causal, the decoder's self-attention causal. Decode attention (one
query against the self-attention cache and the cross-attention keys) stays
``gqa_attend`` in PyTorch ops.

Training: ``Whisper(cfg, tree, trainable=True)`` keeps float32 weights with
gradients, and :func:`forward` is differentiable, each encoder and decoder
layer under ``torch.utils.checkpoint`` when ``cfg.remat`` is set (as
``lm.py``); ``prefill`` and ``decode_step`` run under ``torch.no_grad``.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import blocks as B
from repro_torch.models.blocks import ParamSpec
from repro_torch.sharding.policy import shard_as
from repro_torch.models.lm import (DenseLayer, _apply_norm, _Layer,
                                   _norm_specs, _param, _param_dict,
                                   leaf_dtype, remat)


def sinusoid_pos(S: int, D: int, offset: int = 0, device=None):
    """[S, D] float32: sin at the even columns, cos at the odd ones."""
    pos = (torch.arange(S, device=device) + offset)[:, None].float()
    dim = torch.arange(0, D, 2, device=device)[None, :].float()
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), dim / D)
    pe = torch.zeros((S, D), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


def _enc_layer_specs(cfg) -> dict:
    return {
        "ln1": _norm_specs(cfg),
        "attn": B.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, cfg.qkv_bias),
        "ln2": _norm_specs(cfg),
        "mlp": B.mlp_specs(cfg.d_model, cfg.d_ff, cfg.act),
    }


def _dec_layer_specs(cfg) -> dict:
    s = _enc_layer_specs(cfg)
    s["ln_x"] = _norm_specs(cfg)
    s["xattn"] = B.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, cfg.qkv_bias)
    return s


def model_specs(cfg) -> dict:
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed")),
        "frame_proj": ParamSpec((cfg.d_model, cfg.d_model),
                                ("embed", "embed_act"), "small"),
        "enc_layers": [_enc_layer_specs(cfg)] * cfg.n_enc_layers,
        "enc_norm": _norm_specs(cfg),
        "dec_layers": [_dec_layer_specs(cfg)] * cfg.n_layers,
        "final_norm": _norm_specs(cfg),
    }


def abstract_params(cfg):
    return B.abstract_params(model_specs(cfg))


def param_axes(cfg):
    return B.spec_axes(model_specs(cfg))


class DecoderLayer(_Layer):
    """A decoder layer: ``ln1``, ``attn`` (causal self-attention), ``ln_x``,
    ``xattn`` (cross-attention over the encoder), ``ln2``, ``mlp``."""


class Whisper(nn.Module):
    """The model's parameters, built from a tree in the layout of
    :func:`model_specs` (float32 tensors): cast for serving, or float32
    with gradients when ``trainable``."""

    def __init__(self, cfg, tree: dict, trainable: bool = False):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"Whisper takes an encdec config, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.trainable = trainable
        dt = cfg.dtype
        self.embed = _param(tree["embed"], dt, trainable)
        self.frame_proj = _param(tree["frame_proj"], dt, trainable)
        self.enc_layers = nn.ModuleList(DenseLayer(p, dt, trainable)
                                        for p in tree["enc_layers"])
        self.enc_norm = _param_dict(tree["enc_norm"], dt, True, trainable)
        self.dec_layers = nn.ModuleList(DecoderLayer(p, dt, trainable)
                                        for p in tree["dec_layers"])
        self.final_norm = _param_dict(tree["final_norm"], dt, True,
                                      trainable)

    def forward(self, tokens, frames):
        return forward(self.cfg, self, tokens, frames)


def init_params(cfg, generator: torch.Generator, device,
                trainable: bool = False) -> Whisper:
    """Random weights from ``generator`` on ``device``, with the JAX
    package's init distributions, each cast as it is drawn (kept float32
    when ``trainable``)."""
    def finish(path, w):
        return w if trainable else w.to(leaf_dtype(cfg, path))
    return Whisper(cfg, B.build_params(generator, model_specs(cfg), device,
                                       finish), trainable)


def _self_attn(cfg, p, x, causal: bool):
    q, k, v = B.qkv_proj(p["attn"], x, cfg.n_heads, cfg.n_kv_heads, None,
                         None)
    o = flash_attention(q, k, v, causal=causal)
    return B.out_proj(o, p["attn"]["wo"]), (k, v)


def _enc_layer(cfg, p, x):
    h = _apply_norm(cfg, p["ln1"], x)
    o, _ = _self_attn(cfg, p, h, causal=False)
    x = x + o
    h = _apply_norm(cfg, p["ln2"], x)
    return x + B.mlp(p["mlp"], h, cfg.act)


def encode(cfg, params: Whisper, frames):
    """frames [B,T,D] -> encoder output [B,T,D] in ``cfg.dtype``."""
    dt = cfg.dtype
    x = frames.to(dt) @ params.frame_proj.to(dt)
    x = x + sinusoid_pos(x.shape[1], cfg.d_model, device=x.device).to(dt)[None]
    x = shard_as(x, "batch", "act_seq", "embed_act")
    for p in params.enc_layers:
        x = remat(cfg, functools.partial(_enc_layer, cfg, p), x)
    return _apply_norm(cfg, params.enc_norm, x)


def _dec_layer(cfg, p, x, enc_out):
    """Returns (x, self-attention (k, v), cross-attention (k, v))."""
    h = _apply_norm(cfg, p["ln1"], x)
    o, kv = _self_attn(cfg, p, h, causal=True)
    x = x + o
    h = _apply_norm(cfg, p["ln_x"], x)
    ckv = B.cross_kv(p["xattn"], enc_out)
    x = x + B.cross_attention(p["xattn"], h, ckv)
    h = _apply_norm(cfg, p["ln2"], x)
    return x + B.mlp(p["mlp"], h, cfg.act), kv, ckv


def _embed(cfg, params, tokens, offset: int = 0):
    dt = cfg.dtype
    y = B.embed_rows(B.tied(params.embed), tokens, dt)
    return y + sinusoid_pos(y.shape[1], cfg.d_model, offset,
                            device=y.device).to(dt)[None]


def unembed_matrix(cfg, params):
    """[D, V]: the tied embedding, in ``cfg.dtype``."""
    return B.tied(params.embed).to(cfg.dtype).T


def _logits(cfg, params, y):
    y = _apply_norm(cfg, params.final_norm, y)
    return shard_as(y @ unembed_matrix(cfg, params), "batch", "seq", "vocab")


def _dec_remat(cfg, p, y, enc_out):
    return _dec_layer(cfg, p, y, enc_out)[0]


def forward(cfg, params: Whisper, tokens, frames,
            return_hidden: bool = False):
    """Training forward: tokens [B,St], frames [B,T,D] -> logits [B,St,V];
    ``return_hidden`` returns the JAX forward's (final-normed hidden
    [B,St,D], None) instead. Differentiable; under ``torch.no_grad`` it
    builds no graph and no checkpoint."""
    enc_out = encode(cfg, params, frames)
    y = shard_as(_embed(cfg, params, tokens), "batch", "act_seq",
                 "embed_act")
    for p in params.dec_layers:
        y = remat(cfg, functools.partial(_dec_remat, cfg, p), y, enc_out)
    if return_hidden:
        return _apply_norm(cfg, params.final_norm, y), None
    return _logits(cfg, params, y)


def init_cache(cfg, batch: int, max_len: int, n_frames: int, *, device,
               dtype=None) -> dict:
    """{k, v [L,B,max_len,K,hd]: self-attention; xk, xv [L,B,n_frames,K,hd]:
    the cross-attention keys and values of the encoder output}."""
    dtype = dtype or cfg.dtype
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    shape = {"k": max_len, "v": max_len, "xk": n_frames, "xv": n_frames}
    return {n: torch.zeros((L, batch, t, K, hd), dtype=dtype, device=device)
            for n, t in shape.items()}


@torch.no_grad()
def prefill(cfg, params: Whisper, tokens, frames, max_len: int):
    """Encode the frames and run the decoder over the prompt. Returns
    (logits [B,1,V] at the last position, cache); the self-attention
    buffers hold ``max_len`` positions, the cross-attention ones the
    frames."""
    enc_out = encode(cfg, params, frames)
    y = _embed(cfg, params, tokens)
    St = y.shape[1]
    if St > max_len:
        raise ValueError(f"prompt of {St} tokens exceeds max_len {max_len}")
    cache = init_cache(cfg, y.shape[0], max_len, enc_out.shape[1],
                       device=y.device)
    for i, p in enumerate(params.dec_layers):
        y, (k, v), (xk, xv) = _dec_layer(cfg, p, y, enc_out)
        cache["k"][i, :, :St] = k
        cache["v"][i, :, :St] = v
        cache["xk"][i] = xk
        cache["xv"][i] = xv
    return _logits(cfg, params, y[:, -1:]), cache


@torch.no_grad()
def decode_step(cfg, params: Whisper, cache: dict, tokens, pos):
    """One decode step. tokens [B,1]; pos: the absolute position (int).
    Returns (logits [B,1,V], cache), the self-attention cache updated in
    place."""
    pos = int(pos)
    dt = cfg.dtype
    y = _embed(cfg, params, tokens, offset=pos)
    T = cache["k"].shape[2]
    slot = pos % T
    valid = (torch.arange(T, device=y.device) <= pos)[None, None, None, None]
    every = torch.ones((1, 1, 1, 1, cache["xk"].shape[2]), dtype=torch.bool,
                       device=y.device)
    for i, p in enumerate(params.dec_layers):
        k, v = cache["k"][i], cache["v"][i]
        h = _apply_norm(cfg, p["ln1"], y)
        q, k_new, v_new = B.qkv_proj(p["attn"], h, cfg.n_heads,
                                     cfg.n_kv_heads, None, None)
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)
        o = B.gqa_attend(q, k.to(dt), v.to(dt), valid)
        y = y + B.out_proj(o, p["attn"]["wo"])
        h = _apply_norm(cfg, p["ln_x"], y)
        y = y + B.cross_attention(p["xattn"], h, (cache["xk"][i].to(dt),
                                                  cache["xv"][i].to(dt)),
                                  mask=every)
        h = _apply_norm(cfg, p["ln2"], y)
        y = y + B.mlp(p["mlp"], h, cfg.act)
    return _logits(cfg, params, y), cache
