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
scan, and :func:`cross_attention` without a mask goes through the
flash-attention kernel (non-causal).

:func:`moe_ffn` keeps the JAX package's capacity dispatch with every index
step made deterministic: top-k from a stable descending sort (lower expert
first on ties, as ``jax.lax.top_k``), a stable sort of the slots by expert,
and a combine that gathers each (token, k) slot's buffer row and sums over
k in a fixed order instead of scatter-adding (no atomics on the card).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.local import as_dtensor, kept, shard_index, unsplit
from repro_torch.sharding.policy import placements_on, shard_as, shard_count

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


def build_params(generator: torch.Generator, specs, device,
                 finish=None) -> Any:
    """A tree of float32 tensors on ``device`` in the layout of ``specs``
    (nested dicts and lists of :class:`ParamSpec`), drawn from
    ``generator`` leaf by leaf in tree order: normal·scale, "small" =
    normal·scale/√(last dim), zeros or ones. ``finish(path, tensor)``, if
    given, maps each leaf as soon as it is drawn (a cast to the dtype the
    model holds, so that the float32 tree never exists whole)."""
    def draw(s):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=torch.float32, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=torch.float32, device=device)
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        if s.init == "small":
            return w * (s.scale / math.sqrt(max(s.shape[-1], 1)))
        return w * s.scale

    def build(s, path):
        if isinstance(s, dict):
            return {k: build(v, (*path, k)) for k, v in s.items()}
        if isinstance(s, list):
            return [build(v, (*path, i)) for i, v in enumerate(s)]
        return draw(s) if finish is None else finish(path, draw(s))
    return build(specs, ())


def count_specs(specs) -> int:
    """Number of scalar parameters in a spec tree."""
    return sum(math.prod(s.shape) for s in _leaves(specs))


def map_specs(fn, specs) -> Any:
    """The tree of ``specs`` (nested dicts and lists) with each
    :class:`ParamSpec` ``s`` replaced by ``fn(s)``."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v) for v in specs]
    return fn(specs)


def spec_axes(specs) -> Any:
    """Same-structure tree of logical-axes tuples."""
    return map_specs(lambda s: s.axes, specs)


def abstract_params(specs) -> Any:
    """Same-structure tree of float32 meta tensors: shapes without
    storage (the JAX package's ``ShapeDtypeStruct``s)."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=torch.float32,
                                           device="meta"), specs)


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


class _GradInLayout(torch.autograd.Function):
    """The identity; the gradient comes back in the input's placements."""

    @staticmethod
    def forward(ctx, w):
        ctx.placements = w.placements
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(placements=ctx.placements)


def tied(w):
    """A weight read in more than one way (a tied embedding: its rows and
    its transpose). On a mesh each read's gradient is brought back to the
    weight's own placements, so that autograd sums like with like: the
    embedding's and the unembedding's come out partial over different mesh
    dims, and DTensor (torch 2.11) cannot add those. ``w`` itself
    otherwise."""
    return _GradInLayout.apply(w) if isinstance(w, DTensor) else w


def _embed_local(w, tokens, first: int):
    """Rows ``tokens`` of the table shard ``w`` that holds rows first..
    first + len(w) - 1; zero rows for tokens outside it."""
    idx = tokens.long() - first
    ok = (idx >= 0) & (idx < w.shape[0])
    rows = F.embedding(torch.where(ok, idx, 0), w)
    return rows * ok[..., None].to(rows.dtype)


def embed_rows(w, tokens, dtype):
    """``w.to(dtype)[tokens]``, the rows of an embedding table gathered
    from the table cast to ``dtype``, so that the table's gradient is a
    ``dtype`` gradient as in the JAX package. Through ``F.embedding``: the
    backward of indexing (``index_put``) cannot be sharded by DTensor
    (torch 2.11).

    On a mesh each rank runs ``F.embedding`` on its own shards
    (``local_map``): its tokens (their batch and sequence splits kept,
    replicated over the mesh dims that split the vocab) against its shard
    of the table's vocab (the embed dim gathered, as FSDP gathers a
    weight). A token outside the shard gives a zero row, and one
    all-reduce over the vocab's mesh dims sums the rows. The table's
    gradient comes back as each rank's partial sum over its own tokens,
    which DTensor reduces into the table's placements. (DTensor's own
    sharded embedding gathers the batch before it reduces its masked
    partial, whose mask then meets all rows: an IndexError on a 2-D mesh.)
    """
    w = w.to(dtype)
    if not isinstance(w, DTensor) and not isinstance(tokens, DTensor):
        return F.embedding(tokens, w)
    mesh = next(t for t in (w, tokens) if isinstance(t, DTensor)).device_mesh
    w, tokens = as_dtensor(w, mesh), as_dtensor(tokens, mesh)
    vocab = [p == Shard(0) for p in w.placements]
    w_pl = tuple(Shard(0) if v else Replicate() for v in vocab)
    tok_pl = tuple(Replicate() if v else p
                   for v, p in zip(vocab, kept(tokens.placements, (0, 1))))
    out_pl = tuple(Partial() if v else p for v, p in zip(vocab, tok_pl))
    w_grad = tuple(Shard(0) if v else Partial() if isinstance(p, Shard)
                   else Replicate() for v, p in zip(vocab, tok_pl))
    shard, n = shard_index(mesh, w_pl, 0)
    out = local_map(
        functools.partial(_embed_local, first=shard * (w.shape[0] // n)),
        out_placements=list(out_pl), in_placements=(w_pl, tok_pl),
        in_grad_placements=(w_grad, tok_pl), device_mesh=mesh,
        redistribute_inputs=True)(w, tokens)
    return out.redistribute(placements=[
        Replicate() if p.is_partial() else p for p in out.placements])


def seq_op(fn, *xs):
    """``fn(*xs)``, an op along the sequence dim of [B, S, D] activations
    (a concatenation, a slice). On a mesh it runs on each rank's shards, in
    the first input's placements with the sequence whole (every input is
    put in them), and so does its gradient. DTensor (torch 2.11)
    replicates the batch for a slice that starts inside the sequence, and
    gathers the sequence for a concatenation's backward."""
    ds = [x for x in xs if isinstance(x, DTensor)]
    if not ds:
        return fn(*xs)
    mesh = ds[0].device_mesh
    pl = unsplit(ds[0].placements, 1)
    return local_map(fn, out_placements=list(pl),
                     in_placements=(pl,) * len(xs),
                     device_mesh=mesh, redistribute_inputs=True)(
        *(as_dtensor(x, mesh) for x in xs))


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


def splittable(x, dim: int, parts: int):
    """``x`` ready for a view that splits tensor dim ``dim`` into ``parts``
    × the rest: a DTensor whose shards of that dim do not divide ``parts``
    gathers it first (DTensor's view cannot split such a dim; XLA re-shards
    on its own); ``x`` itself otherwise."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    n = math.prod(size for size, p in zip(x.device_mesh.shape, x.placements)
                  if p == Shard(dim))
    if parts % n == 0:
        return x
    return x.redistribute(placements=unsplit(x.placements, dim))


class _SplittableGrad(torch.autograd.Function):
    """The identity, whose gradient is made :func:`splittable`: put after
    a view that merges a dim, whose backward splits that dim again."""

    @staticmethod
    def forward(ctx, x, dim: int, parts: int):
        ctx.dim, ctx.parts = dim, parts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return splittable(g, ctx.dim, ctx.parts), None, None


def merged(x, dim: int, parts: int):
    """``x``, a view that merged ``parts`` × the rest into tensor dim
    ``dim``, with its gradient made :func:`splittable` for that view's
    backward (on a mesh, where DTensor's matmul may return the gradient
    sharded along the merged dim)."""
    if isinstance(x, DTensor) and x.requires_grad:
        return _SplittableGrad.apply(x, dim, parts)
    return x


def _heads_proj(x, w):
    """"bsd,dhk->bshk" as one matmul; the result is contiguous."""
    D, nh, hd = w.shape
    w = merged(w.to(x.dtype).reshape(D, nh * hd), -1, nh)
    return splittable(x @ w, -1, nh).view(*x.shape[:-1], nh, hd)


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
    return (merged(o.reshape(*o.shape[:-2], nh * hd), -1, nh)
            @ merged(wo.to(o.dtype).reshape(nh * hd, D), 0, nh))


def _gqa_attend_mesh(q, k, v, mask):
    """:func:`gqa_attend` on DTensors (decode on a mesh), as batched
    products over (sequence, KV head) pairs: the einsum form flattens the
    batch and head dims, and DTensor (torch 2.11) cannot flatten two
    sharded dims. The heads are made whole (a decode step's q is one
    token; the cache's KV heads are whole under the default rules, its
    positions split over "model"), so that only the batch dim of each
    flatten is split; the products' FLOPs are the einsum's."""
    mesh = next(t for t in (q, k, v) if isinstance(t, DTensor)).device_mesh
    q, k, v = (as_dtensor(t, mesh) for t in (q, k, v))
    q, k, v = (t.redistribute(placements=unsplit(t.placements, 2))
               for t in (q, k, v))
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qb = q.reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4).reshape(
        B * K, G * S, hd)
    kb = k.permute(0, 2, 3, 1).reshape(B * K, hd, T)
    vb = v.permute(0, 2, 1, 3).reshape(B * K, T, hd)
    scores = (torch.bmm(qb, kb) * (1.0 / math.sqrt(hd))).float()
    mask = torch.broadcast_to(mask, (B, 1, 1, S, T)).expand(
        B, K, G, S, T).reshape(B * K, G * S, T)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.bmm(probs, vb).reshape(B, K, G, S, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def gqa_attend(q, k, v, mask):
    """Grouped-query attention core (softmax in float32).

    q: [B,S,H,hd], k/v: [B,T,K,hd] with H = K·G. mask: broadcastable to
    [B,1,1,S,T] (True = attend). Returns [B,S,H,hd].
    """
    if isinstance(q, DTensor) or isinstance(k, DTensor):
        return _gqa_attend_mesh(q, k, v, mask)
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    q = q.reshape(B, S, K, G, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) * scale  # [B,K,G,S,T]
    # sharding fallback for head counts not divisible by the model axis:
    # shard the query-sequence dim of the score tensor instead
    scores = shard_as(scores.float(), "batch", "kv_heads", None, "act_seq",
                      None)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, hd)


def causal_mask(S: int, T: int, offset: int = 0, device=None):
    """True where query i (at absolute pos offset+i) may attend key j."""
    i = torch.arange(S, device=device)[:, None] + offset
    j = torch.arange(T, device=device)[None, :]
    return (j <= i)[None, None, None]


def _divisor_block(n: int, target: int) -> int:
    """The largest divisor of ``n`` that is at most ``target``."""
    for d in range(min(target, n), 0, -1):
        if n % d == 0:
            return d
    return n


def blockwise_gqa_attend(q, k, v, *, causal: bool, block_q: int = 1024,
                         block_k: int = 2048):
    """Memory-bounded attention: a loop over query blocks, an inner loop
    over KV blocks with an online softmax (the flash-attention dataflow in
    PyTorch ops). Peak live score tile is [B,K,G,BQ,BK] instead of
    [B,K,G,S,T]. Same math as :func:`gqa_attend`. The port's models run the
    flash-attention kernel at every length instead (the JAX package
    switches to this at S >= 8192)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    bq = _divisor_block(S, block_q)
    bk = _divisor_block(T, block_k)
    scale = 1.0 / math.sqrt(hd)
    # [nq,B,K,G,bq,hd] and [nk,B,K,bk,hd]
    qb = q.reshape(B, S // bq, bq, K, G, hd).permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(B, T // bk, bk, K, hd).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, T // bk, bk, K, hd).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(S // bq):
        q_i = qb[qi].float()
        acc = torch.zeros((B, K, G, bq, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, K, G, bq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        denom = torch.zeros((B, K, G, bq, 1), dtype=torch.float32,
                            device=q.device)
        for kj in range(T // bk):
            s = torch.einsum("bkgqd,bktd->bkgqt", q_i, kb[kj].float()) * scale
            if causal:
                rows = qi * bq + torch.arange(bq, device=q.device)[:, None]
                cols = kj * bk + torch.arange(bk, device=q.device)[None, :]
                s = torch.where(cols <= rows, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
            pr = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            denom = denom * corr + torch.sum(pr, dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bkgqt,bktd->bkgqd", pr,
                                            vb[kj].float())
            m = m_new
        outs.append(acc / torch.clamp(denom, min=1e-30))
    # [nq,B,K,G,bq,hd] -> [B,S,H,hd]
    out = torch.stack(outs).permute(1, 2, 3, 0, 4, 5).reshape(B, H, S, hd)
    return out.transpose(1, 2).to(q.dtype)


def attention(p, x, cfg, positions, mask=None):
    """Full-sequence attention through :func:`gqa_attend` (the JAX
    package's block; the port's models run the flash-attention kernel
    instead). Returns (out, (k, v))."""
    q, k, v = qkv_proj(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.rope_theta,
                       positions)
    q = shard_as(q, "batch", "seq", "heads", None)
    k = shard_as(k, "batch", "seq", "kv_heads", None)
    v = shard_as(v, "batch", "seq", "kv_heads", None)
    S = x.shape[1]
    if mask is None:
        mask = (causal_mask(S, S, device=x.device) if cfg.causal else
                torch.ones((1, 1, 1, S, S), dtype=torch.bool,
                           device=x.device))
    out = gqa_attend(q, k, v, mask)
    out = shard_as(out_proj(out, p["wo"]), "batch", "seq", "embed_act")
    return out, (k, v)


def write_seq(cache, start: int, new) -> None:
    """``cache[:, start:start + n] = new`` in place: ``new`` [B,n,...] into
    positions start.. start+n-1 of a [B,T,...] cache buffer (a KV ring
    buffer's slot, a prefill's prompt). On a mesh each rank writes the part
    of ``new`` that falls in its own shard of the buffer into its local
    shard, ``new`` first put in the buffer's placements with its positions
    whole. (A write through DTensor's indexing goes into a copy that
    DTensor gathers when the buffer's positions are split, "kv_seq" over
    "model", and is lost.)"""
    n = new.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, start:start + n] = new.to(cache.dtype)
        return
    mesh = cache.device_mesh
    new = as_dtensor(new, mesh).to(cache.dtype)
    new = new.redistribute(mesh, unsplit(cache.placements, 1)).to_local()
    shard, count = shard_index(mesh, cache.placements, 1)
    size = cache.shape[1] // count
    lo, hi = max(start, shard * size), min(start + n, (shard + 1) * size)
    if lo < hi:
        cache.to_local()[:, lo - shard * size:hi - shard * size] = \
            new[:, lo - start:hi - start]


def attention_decode(p, x, cfg, cache_k, cache_v, pos: int):
    """Single-token decode against a KV cache. x: [B,1,D]; cache_k/v:
    [B,T,K,hd] (ring buffer, absolute positions), written at slot
    ``pos % T`` in place (the JAX package returns new buffers). Returns
    (out, (cache_k, cache_v))."""
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    q, k_new, v_new = qkv_proj(p, x, cfg.n_heads, cfg.n_kv_heads,
                               cfg.rope_theta, positions)
    T = cache_k.shape[1]
    slot = pos % T
    write_seq(cache_k, slot, k_new)
    write_seq(cache_v, slot, v_new)
    cache_k = shard_as(cache_k, "batch", "kv_seq", "kv_heads", None)
    cache_v = shard_as(cache_v, "batch", "kv_seq", "kv_heads", None)
    valid = (torch.arange(T, device=x.device) <= pos)[None, None, None, None]
    out = gqa_attend(q, cache_k, cache_v, valid)
    return out_proj(out, p["wo"]), (cache_k, cache_v)


def cross_attention(p, x, kv_cached, mask=None):
    """Encoder-decoder cross attention (whisper). kv_cached = (k, v) from
    the encoder output projections; no RoPE. Without a mask every query
    sees every key, through the flash-attention kernel (non-causal); with
    one (decode), through :func:`gqa_attend`."""
    dt = x.dtype
    q = _heads_proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(dt)
    k, v = kv_cached
    if mask is None:
        out = flash_attention(q, k, v, causal=False)
    else:
        out = gqa_attend(q, k, v, mask)
    return out_proj(out, p["wo"])


def cross_kv(p, enc_out):
    dt = enc_out.dtype
    k = _heads_proj(enc_out, p["wk"])
    v = _heads_proj(enc_out, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return k, v


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
        h = shard_as(h, "batch", "seq", "mlp")
        return h @ p["w_down"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_in"].to(dt) + p["b_in"].to(dt), approximate="tanh")
    h = shard_as(h, "batch", "seq", "mlp")
    return h @ p["w_out"].to(dt) + p["b_out"].to(dt)


# --------------------------------------------------------------------------
# Mixture of Experts (top-k router, sort-based capacity dispatch)
# --------------------------------------------------------------------------
def moe_specs(d_model: int, d_ff: int, n_experts: int) -> dict:
    return {
        "router": ParamSpec((d_model, n_experts), ("embed", "experts")),
        "w_gate": ParamSpec((n_experts, d_model, d_ff),
                            ("experts", "embed", "expert_mlp"), "small"),
        "w_up": ParamSpec((n_experts, d_model, d_ff),
                          ("experts", "embed", "expert_mlp"), "small"),
        "w_down": ParamSpec((n_experts, d_ff, d_model),
                            ("experts", "expert_mlp", "embed"), "small"),
    }


# The list that moe_ffn calls append their routing to while
# :func:`record_routes` is active, else None.
ROUTES: list | None = None


@contextlib.contextmanager
def record_routes():
    """Within the block, each :func:`moe_ffn` call appends a dict of its
    routing to the list this yields (tensors, left on the input's device):
    ``top_idx`` [T,K], ``probs`` the top K+1 router probabilities [T,K+1]
    (descending), ``dropped`` the number of (token, k) slots past their
    expert's capacity, ``kept`` [T,K] which slots fit, and ``tokens`` T.
    Calls on a mesh (DTensors) record nothing."""
    global ROUTES
    prev, ROUTES = ROUTES, []
    try:
        yield ROUTES
    finally:
        ROUTES = prev


def _moe_route(probs, xf, K: int, C: int, e_first: int = 0,
               n_local: int | None = None):
    """The index steps of :func:`moe_ffn`, batched over the G groups of the
    leading dim. probs [G,Tl,E] f32, xf [G,Tl,D] -> (xe [G,El,C,D] the
    gathered tokens of experts e_first.. e_first+El-1 (zero in unused
    buffer rows; El = ``n_local``, all E by default), src_gate [G,El,C]
    f32 their gates, row_of_slot [G,Tl·K] each (token, k) slot's buffer
    row among all E·C (E·C when dropped), counts [G,E] the slots routed to
    each expert, top_idx [G,Tl,K], top probabilities [G,Tl,K+1]). Every
    rank routes its groups' tokens to all E experts; it gathers only its
    own experts' rows."""
    G, Tl, E = probs.shape
    D = xf.shape[-1]
    dev = probs.device
    # stable descending sort: on equal probabilities the lower expert comes
    # first, as jax.lax.top_k returns it (torch.topk promises no order)
    sorted_p, sorted_idx = torch.sort(probs, dim=-1, descending=True,
                                      stable=True)
    top_p, top_idx = sorted_p[..., :K], sorted_idx[..., :K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # ---- sort (token, k)-slots by expert id, per group -----------------
    expert_flat = top_idx.reshape(G, Tl * K)
    order = torch.argsort(expert_flat, dim=-1, stable=True)     # [G,Tl*K]
    tok_sorted = order // K
    exp_sorted = torch.gather(expert_flat, 1, order)
    gate_sorted = torch.gather(top_p.reshape(G, Tl * K), 1, order)
    # position of each slot within its expert's run
    seg_start = torch.searchsorted(
        exp_sorted, torch.arange(E, device=dev).expand(G, E).contiguous(),
        side="left")
    pos_in_e = (torch.arange(Tl * K, device=dev)
                - torch.gather(seg_start, 1, exp_sorted))
    keep = pos_in_e < C                                          # capacity

    # ---- gather tokens to [G, E, C, D] ----------------------------------
    # row E*C is the trash row: every dropped slot writes there (torch does
    # not say which write wins), and it is sliced off
    slot = torch.where(keep, exp_sorted * C + pos_in_e, E * C)

    def fill(val, dtype):
        buf = torch.zeros((G, E * C + 1), dtype=dtype, device=dev)
        return buf.scatter(1, slot, val.to(dtype))[:, :E * C]

    El = E if n_local is None else n_local
    own = slice(e_first * C, (e_first + El) * C)
    src_tok = fill(tok_sorted, torch.long)[:, own]
    src_gate = fill(torch.where(keep, gate_sorted, 0.0), torch.float32)
    src_valid = fill(keep, torch.float32)[:, own]
    xe = torch.gather(xf, 1, src_tok[..., None].expand(G, El * C, D))
    xe = (xe * src_valid[..., None].to(xf.dtype)).reshape(G, El, C, D)
    row_of_slot = torch.empty_like(slot).scatter_(1, order, slot)
    # integer counts: exact in any order of the adds
    counts = torch.zeros((G, E), dtype=torch.long, device=dev).scatter_add_(
        1, expert_flat, torch.ones_like(expert_flat))
    return (xe, src_gate[:, own].reshape(G, El, C), row_of_slot, counts,
            top_idx, sorted_p[..., :K + 1])


def _moe_combine(out_e, row_of_slot, e_first: int, K: int):
    """out_e [G,El,C,D], the buffer rows of experts e_first.. e_first+El-1
    -> [G,Tl,D]: each (token, k) slot reads its buffer row (a zero row when
    it was dropped or its expert is not among these), and the K rows are
    summed in k order in out_e's dtype; no scatter-add, so the bits do not
    depend on the order of atomics. One [G,Tl,D] gather per k: the K rows
    of every token are never held at once, forward or backward."""
    G, El, C, D = out_e.shape
    rows = torch.cat([out_e.reshape(G, El * C, D),
                      torch.zeros((G, 1, D), dtype=out_e.dtype,
                                  device=out_e.device)], dim=1)
    local = row_of_slot - e_first * C
    local = torch.where((local >= 0) & (local < El * C), local, El * C)
    local = local.reshape(G, -1, K)
    out = None
    for k in range(K):
        idx = local[:, :, k]
        picked = torch.gather(rows, 1, idx[..., None].expand(*idx.shape, D))
        out = picked if out is None else out + picked
    return out


def _moe_experts(probs, xf, w_gate, w_up, w_down, *, K: int, C: int,
                 e_first: int):
    """Route, expert FFN and combine of :func:`moe_ffn` for the experts
    e_first.. e_first+El-1 whose weights [El,D,F], [El,D,F], [El,F,D]
    (cast to the compute dtype) are given: -> (out [G,Tl,D], the sum of
    these experts' rows for each token, row_of_slot, counts, top_idx, top
    probabilities). With every expert (e_first 0) ``out`` is the MoE's
    output; with a slice of them it is that slice's share of it, and the
    gradients of probs and xf are that slice's shares of theirs."""
    El = w_gate.shape[0]
    xe, gate, row_of_slot, counts, top_idx, top_p = _moe_route(
        probs, xf, K, C, e_first, El)
    G, _, _, D = xe.shape
    # the groups' buffers side by side: [El, G*C, D] against [El, D, F]
    xg = xe.permute(1, 0, 2, 3).reshape(El, G * C, D)
    h = silu(torch.bmm(xg, w_gate))
    h = h * torch.bmm(xg, w_up)
    out_e = torch.bmm(h, w_down)
    out_e = out_e.reshape(El, G, C, D).permute(1, 0, 2, 3)
    out_e = out_e * gate[..., None].to(out_e.dtype)
    out = _moe_combine(out_e, row_of_slot, e_first, K)
    return out, row_of_slot, counts, top_idx, top_p


def _moe_on_mesh(mesh, probs, xf, weights, K: int, C: int):
    """:func:`_moe_experts` on each rank's local shards: its token groups
    (split over the batch axes) and its experts (split over the experts'
    axes; weights gathered over the others, as FSDP gathers them). The
    output is a partial sum over the experts' axes; the gradients of
    probs and xf are partial sums there too, and the weights' partial
    sums over the batch axes, so that DTensor reduces each gradient as it
    puts it back in its tensor's placements. No rank holds another rank's
    expert rows or an unsplit group."""
    G, Tl, E = probs.shape
    D = xf.shape[-1]
    rows = placements_on(mesh, probs.shape, "batch", None, None)
    ex = placements_on(mesh, (G, E, C, D), "batch", "experts", None, None)
    split_e = [q == Shard(1) for q in ex]
    w_pl = tuple(Shard(0) if e else Replicate() for e in split_e)
    w_grad = tuple(Shard(0) if e else Partial() if isinstance(r, Shard)
                   else Replicate() for e, r in zip(split_e, rows))
    rows_grad = tuple(Partial() if e else r for e, r in zip(split_e, rows))
    shard, n = shard_index(mesh, ex, 1)
    fn = local_map(
        functools.partial(_moe_experts, K=K, C=C, e_first=shard * E // n),
        out_placements=(rows_grad,) + (rows,) * 4,
        in_placements=(rows, rows) + (w_pl,) * 3,
        in_grad_placements=(rows_grad, rows_grad) + (w_grad,) * 3,
        device_mesh=mesh, redistribute_inputs=True)
    return fn(probs, xf, *weights)


def moe_ffn(p, x, n_experts: int, top_k: int, capacity_factor: float = 1.25):
    """Token-choice top-k MoE with shard-local sort-based capacity dispatch.

    As in the JAX package, the token dim is split into G groups, one per
    shard of the active policy's batch axis (G = 1 outside a mesh, or when
    the tokens do not split evenly), and every index step (sort, gather,
    combine) runs per group, so dispatch never moves tokens across the
    batch axis. Each group has its own capacity C = max(ceil(top_k·T/G/E ·
    cap_factor), top_k); overflow slots are dropped for that expert
    (Switch/GShard semantics). Every expert runs over its C buffer rows per
    group, used or not, as in the JAX package. Returns (out, aux_loss).

    On a mesh (DTensor inputs) each rank routes its groups and gathers,
    runs and combines only its own experts' rows (:func:`_moe_on_mesh`):
    the [G, E, C, D] dispatch is split by group and by expert (EP), as the
    reference's ``shard_as`` splits it, forward and backward.
    """
    dt = x.dtype
    B, S, D = x.shape
    T = B * S
    E, K = n_experts, top_k
    G = shard_count("batch")
    if T % G:
        G = 1
    Tl = T // G
    C = max(int(math.ceil(K * Tl / E * capacity_factor)), K)

    xf = shard_as(x.reshape(G, Tl, D), "batch", None, "embed_act")
    logits = (xf @ p["router"].to(dt)).float()                  # [G,Tl,E]
    probs = torch.softmax(logits, dim=-1)
    mesh = xf.device_mesh if isinstance(xf, DTensor) else None
    weights = [p[k].to(dt) for k in ("w_gate", "w_up", "w_down")]
    if mesh is None:
        out, row_of_slot, counts, top_idx, top_probs = _moe_experts(
            probs, xf, *weights, K=K, C=C, e_first=0)
    else:
        out, row_of_slot, counts, top_idx, top_probs = _moe_on_mesh(
            mesh, probs, xf, weights, K, C)
    out = shard_as(out.reshape(B, S, D), "batch", "act_seq", "embed_act")

    # load-balancing aux loss (Switch-style, global mean)
    me = probs.mean(dim=(0, 1))                                  # [E]
    ce = counts.sum(0).float() / T
    aux = E * torch.sum(me * ce / K)
    if ROUTES is not None and mesh is None:
        kept = (row_of_slot < E * C).reshape(T, K)
        ROUTES.append(dict(top_idx=top_idx.reshape(T, K),
                           probs=top_probs.reshape(T, -1),
                           dropped=(~kept).sum(), tokens=T, kept=kept))
    return out, aux.float()


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
    """Depthwise causal conv. x: [B,S,C], w: [k,C]. The k-1 zero rows in
    front are concatenated, not padded: DTensor's pad (torch 2.11) returns
    a placement for one mesh dim on a 2-D mesh."""
    k = w.shape[0]
    zeros = torch.zeros_like(x[:, :1]).expand(-1, k - 1, -1)
    xp = torch.cat([zeros, x], dim=1)
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
    xs = shard_as(xs, "batch", "seq", "inner")

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
