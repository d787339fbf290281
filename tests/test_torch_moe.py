"""The port's MoE pieces against the JAX package, on the same numpy inputs,
in float32 on the CPU: ``moe_ffn`` (output, load-balancing aux, routing,
dropped slots), its tie and drop cases, the qk-norm attention blocks of
qwen3-moe, and ``active_params``. Tolerance 1e-5, as
``tests/test_torch_blocks.py`` holds the single-pass blocks (sums in
another order); the routing and the dropped slots must be equal."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, t32

from repro.models import blocks as jb
from repro.models import lm as jlm
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro_torch.models import blocks as tb
from repro_torch.models import lm
from repro_torch.models.registry import get_config, get_model

TOL = dict(rtol=1e-5, atol=1e-5)


def _moe_params(rng, D, F, E, router_scale=1.0):
    tree = {k: (rng.standard_normal(s.shape) * 0.3).astype(np.float32)
            for k, s in tb.moe_specs(D, F, E).items()}
    tree["router"] *= np.float32(router_scale)
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: t32(v) for k, v in tree.items()})


def _jax_routing(x, router, E, K, cf):
    """The JAX reference's routing steps (``blocks.py:371-392``, one
    group): top-k experts per token and the number of (token, k) slots
    past capacity."""
    B, S, D = x.shape
    T = B * S
    C = max(int(math.ceil(K * T / E * cf)), K)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(T, D) @ router, axis=-1)
    _, top_idx = jax.lax.top_k(probs, K)
    flat = top_idx.reshape(T * K)
    exp_sorted = flat[jnp.argsort(flat, stable=True)]
    seg = jnp.searchsorted(exp_sorted, jnp.arange(E), side="left")
    pos = jnp.arange(T * K) - seg[exp_sorted]
    return np.asarray(top_idx), int((pos >= C).sum())


def _run(tp, x, E, K, cf):
    """The port's moe_ffn with its routing recorded."""
    with tb.record_routes() as routes:
        out, aux = tb.moe_ffn(tp, t32(x), E, K, cf)
    (route,) = routes
    assert tb.ROUTES is None
    return out, aux, route


def test_moe_specs_match_jax():
    j, t = jb.moe_specs(32, 48, 6), tb.moe_specs(32, 48, 6)
    assert {k: dataclasses.astuple(v) for k, v in j.items()} == \
           {k: dataclasses.astuple(v) for k, v in t.items()}


@pytest.mark.parametrize("B,S,D,F,E,K,cf", [
    (2, 8, 32, 16, 4, 2, 1.25),
    (1, 16, 32, 24, 8, 3, 1.25),
    (3, 5, 16, 8, 6, 2, 2.0),
    (2, 12, 32, 16, 8, 8, 1.0),          # K = E: every expert per token
])
def test_moe_ffn_matches_jax(B, S, D, F, E, K, cf):
    rng = np.random.default_rng(B * S + E)
    jp, tp = _moe_params(rng, D, F, E)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    out, aux, route = _run(tp, x, E, K, cf)
    jout, jaux = jb.moe_ffn(jp, jnp.asarray(x), E, K, cf)
    top_idx, dropped = _jax_routing(x, jp["router"], E, K, cf)
    assert np.array_equal(route["top_idx"].numpy(), top_idx)
    assert int(route["dropped"]) == dropped and route["tokens"] == B * S
    assert out.shape == (B, S, D) and aux.dtype == torch.float32
    assert_close(out, np.asarray(jout), **TOL)
    assert_close(aux, np.asarray(jaux), **TOL)


def test_moe_ffn_tie_case_takes_lower_experts():
    """Zero router weights: every probability is 1/E, and jax.lax.top_k
    takes experts 0..K-1 for every token; so must the port (torch.topk
    promises no order on ties)."""
    B, S, D, F, E, K = 2, 6, 16, 8, 8, 3
    rng = np.random.default_rng(0)
    jp, tp = _moe_params(rng, D, F, E, router_scale=0.0)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    out, aux, route = _run(tp, x, E, K, 1.25)
    jout, jaux = jb.moe_ffn(jp, jnp.asarray(x), E, K, 1.25)
    top_idx, dropped = _jax_routing(x, jp["router"], E, K, 1.25)
    assert np.array_equal(top_idx, np.tile(np.arange(K), (B * S, 1)))
    assert np.array_equal(route["top_idx"].numpy(), top_idx)
    # experts 0..K-1 take all T slots each, C = ceil(K·T/E·1.25) = 6
    assert int(route["dropped"]) == dropped == K * (B * S - 6)
    assert_close(out, np.asarray(jout), **TOL)
    assert_close(aux, np.asarray(jaux), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_ffn_drop_case(seed):
    """capacity_factor 0.5: half the slots fit, and the port drops the same
    (token, k) slots as JAX (the output shows which ones were kept)."""
    B, S, D, F, E, K = 2, 16, 32, 16, 4, 2
    rng = np.random.default_rng(seed)
    jp, tp = _moe_params(rng, D, F, E)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    out, aux, route = _run(tp, x, E, K, 0.5)
    jout, jaux = jb.moe_ffn(jp, jnp.asarray(x), E, K, 0.5)
    _, dropped = _jax_routing(x, jp["router"], E, K, 0.5)
    assert dropped >= B * S * K // 2
    assert int(route["dropped"]) == dropped
    assert_close(out, np.asarray(jout), **TOL)
    assert_close(aux, np.asarray(jaux), **TOL)


def _qwen3_layer(rng, cfg):
    """One qwen3-moe attention block's parameters (ln1, attn with q_norm and
    k_norm, none of them at their init), as JAX and as port trees."""
    specs = {"ln1": lm._norm_specs(cfg), "attn": lm._attn_specs(cfg)}
    tree = {n: {k: (rng.standard_normal(s.shape) * 0.3
                    + (1.0 if s.init == "ones" else 0.0)).astype(np.float32)
                for k, s in sub.items()} for n, sub in specs.items()}
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            {n: {k: t32(v) for k, v in sub.items()}
             for n, sub in tree.items()})


def test_qk_norm_attention_blocks_match_jax():
    """qwen3-moe's attention block (RoPE, then the per-head q/k RMSNorm) in
    prefill and in decode against the JAX package."""
    jcfg = dataclasses.replace(jax_config("qwen3-moe-235b-a22b").reduced(),
                               remat=False)
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    assert cfg.qk_norm and "q_norm" in lm._attn_specs(cfg)
    rng = np.random.default_rng(5)
    jp, tp = _qwen3_layer(rng, cfg)
    B, S, T = 2, 7, 12
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S)[None, :]
    jx, (jk, jv) = jlm._attn_block(jcfg, jp, jnp.asarray(x),
                                   jnp.asarray(pos))
    tx, (tk, tv) = lm._attn_block(cfg, tp, t32(x), torch.tensor(pos))
    for g, w in ((tx, jx), (tk, jk), (tv, jv)):
        assert_close(g, np.asarray(w), **TOL)

    ck = rng.standard_normal((B, T, cfg.n_kv_heads, cfg.hd)).astype(
        np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jx, (jk, jv) = jlm._attn_block_decode(jcfg, jp, jnp.asarray(xd),
                                          jnp.asarray(ck), jnp.asarray(cv),
                                          jnp.asarray(9, jnp.int32))
    tx, (tk, tv) = lm._attn_block_decode(cfg, tp, t32(xd), t32(ck), t32(cv),
                                         9)
    for g, w in ((tx, jx), (tk, jk), (tv, jv)):
        assert_close(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "dbrx-132b",
                                  "yi-6b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_active_params_match_jax(name, reduced):
    jcfg, cfg = jax_config(name), get_config(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    got = get_model(cfg, device="cpu").active_params()
    assert got == jax_model(jcfg).active_params()
    if name == "qwen3-moe-235b-a22b" and not reduced:
        assert got == 22_190_763_520


def test_forward_aux_sums_layers():
    """``forward(..., return_aux=True)``: the MoE aux summed over layers,
    as the JAX forward's second output; other families give 0."""
    cfg = get_config("dbrx-132b").reduced()
    model = get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 10)), dtype=torch.long)
    with tb.record_routes() as routes:
        logits, aux = lm.forward(cfg, model, toks, return_aux=True)
    assert len(routes) == cfg.n_layers
    assert torch.equal(logits, lm.forward(cfg, model, toks))
    assert aux.dtype == torch.float32 and float(aux) > 0.0
    dense = get_config("yi-6b").reduced()
    dm = get_model(dense, device="cpu").init(torch.Generator().manual_seed(0))
    _, aux0 = lm.forward(dense, dm, toks, return_aux=True)
    assert float(aux0) == 0.0


def _jax_kept(x, router, E, K, cf, G):
    """Which (token, k) slots the JAX reference keeps when the tokens are
    split into G groups, each with its own capacity and sort
    (``blocks.py:361-392``): [T, K] bool."""
    B, S, D = x.shape
    T = B * S
    Tl = T // G
    C = max(int(math.ceil(K * Tl / E * cf)), K)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(G, Tl, D) @ router, -1)
    _, top_idx = jax.lax.top_k(probs, K)
    kept = []
    for g in range(G):
        flat = np.asarray(top_idx[g]).reshape(Tl * K)
        order = np.argsort(flat, kind="stable")
        exp_sorted = flat[order]
        seg = np.searchsorted(exp_sorted, np.arange(E), side="left")
        keep_sorted = np.arange(Tl * K) - seg[exp_sorted] < C
        keep = np.empty(Tl * K, bool)
        keep[order] = keep_sorted
        kept.append(keep.reshape(Tl, K))
    return np.concatenate(kept)


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_ffn_four_groups_matches_jax(seed, monkeypatch):
    """G = 4 token groups, as on a mesh with 4 batch shards (the JAX
    package's ``shard_count("batch")`` patched to 4; it imports it inside
    ``moe_ffn``): each group has its own capacity and sort, slots are
    dropped, and the port keeps the same slots; outputs at 1e-4."""
    import repro.sharding.policy as jpol
    B, S, D, F, E, K, cf = 4, 8, 32, 16, 4, 2, 0.75
    rng = np.random.default_rng(seed)
    jp, tp = _moe_params(rng, D, F, E)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    monkeypatch.setattr(jpol, "shard_count", lambda name: 4)
    monkeypatch.setattr(tb, "shard_count", lambda name: 4)
    out, aux, route = _run(tp, x, E, K, cf)
    jout, jaux = jb.moe_ffn(jp, jnp.asarray(x), E, K, cf)
    kept = _jax_kept(x, jp["router"], E, K, cf, 4)
    assert not kept.all()
    assert np.array_equal(route["kept"].numpy(), kept)
    assert int(route["dropped"]) == int((~kept).sum())
    assert_close(out, np.asarray(jout), rtol=1e-4, atol=1e-4)
    assert_close(aux, np.asarray(jaux), rtol=1e-4, atol=1e-4)
    # one group: the G = 1 case is not the same dispatch
    monkeypatch.setattr(tb, "shard_count", lambda name: 1)
    one, _, route1 = _run(tp, x, E, K, cf)
    assert not np.array_equal(route1["kept"].numpy(), kept)


def test_moe_ffn_groups_fall_back_to_one(monkeypatch):
    """T % G != 0: one group, as in the JAX package."""
    import repro.sharding.policy as jpol
    B, S, D, F, E, K = 1, 6, 16, 8, 4, 2
    rng = np.random.default_rng(3)
    jp, tp = _moe_params(rng, D, F, E)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    monkeypatch.setattr(jpol, "shard_count", lambda name: 4)
    monkeypatch.setattr(tb, "shard_count", lambda name: 4)
    out, aux, route = _run(tp, x, E, K, 1.0)
    jout, _ = jb.moe_ffn(jp, jnp.asarray(x), E, K, 1.0)
    assert np.array_equal(route["kept"].numpy(),
                          _jax_kept(x, jp["router"], E, K, 1.0, 1))
    assert_close(out, np.asarray(jout), **TOL)
