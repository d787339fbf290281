"""Each ported building block of ``repro_torch.models.blocks`` against its
JAX counterpart in ``repro.models.blocks``, on the same numpy inputs, in
float32: 1e-5 for the single-pass functions (sums in another order), 1e-4
for ``mamba2_forward``/``mamba2_decode``, whose SSD core is the chunked
scan held at 1e-4 by the JAX tests themselves."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, t32

from repro.models import blocks as jb
from repro_torch.models import blocks as tb

TOL = dict(rtol=1e-5, atol=1e-5)


@dataclasses.dataclass(frozen=True)
class _SSMCfg:
    d_model: int = 32
    ssm_state: int = 8
    ssm_head_dim: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """The same numpy tree as JAX arrays and as torch tensors."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: t32(v) for k, v in tree.items()})


def _spec_params(rng, specs):
    """Random values for a spec dict (non-trivial norms, biases, A_log)."""
    return {k: _rand(rng, *s.shape, scale=0.3) + (1.0 if s.init == "ones"
                                                   else 0.0)
            for k, s in specs.items()}


def test_specs_match_jax():
    pairs = [
        (jb.attn_specs(32, 4, 2, 8, True), tb.attn_specs(32, 4, 2, 8, True)),
        (jb.attn_specs(32, 4, 4, 8), tb.attn_specs(32, 4, 4, 8)),
        (jb.mlp_specs(32, 64), tb.mlp_specs(32, 64)),
        (jb.mlp_specs(32, 64, "gelu"), tb.mlp_specs(32, 64, "gelu")),
        (jb.mamba2_specs(32, 8, 16), tb.mamba2_specs(32, 8, 16)),
    ]
    for j, t in pairs:
        assert {k: dataclasses.astuple(v) for k, v in j.items()} == \
               {k: dataclasses.astuple(v) for k, v in t.items()}


def test_build_params_distributions():
    specs = {"n": tb.ParamSpec((200, 300), (None, None)),
             "s": tb.ParamSpec((400, 100), (None, None), "small", 1.0),
             "z": tb.ParamSpec((7,), (None,), "zeros"),
             "o": [tb.ParamSpec((3, 5), (None, None), "ones")]}
    gen = torch.Generator().manual_seed(0)
    p = tb.build_params(gen, specs, "cpu")
    assert p["n"].dtype == torch.float32 and p["n"].shape == (200, 300)
    assert abs(float(p["n"].std()) - 0.02) < 0.001
    assert abs(float(p["s"].std()) - 0.1) < 0.005       # 1/√100
    assert torch.equal(p["z"], torch.zeros(7))
    assert torch.equal(p["o"][0], torch.ones(3, 5))
    again = tb.build_params(torch.Generator().manual_seed(0), specs, "cpu")
    assert torch.equal(p["n"], again["n"]) and torch.equal(p["s"], again["s"])
    assert tb.count_specs(specs) == 200 * 300 + 400 * 100 + 7 + 15


def test_norms_and_activations():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 32, scale=3.0)
    w, b = _rand(rng, 32) + 1.0, _rand(rng, 32)
    assert_close(tb.rms_norm(t32(x), t32(w)),
                 np.asarray(jb.rms_norm(jnp.asarray(x), jnp.asarray(w))),
                 **TOL)
    assert_close(tb.layer_norm(t32(x), t32(w), t32(b)),
                 np.asarray(jb.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b))), **TOL)
    assert_close(tb.silu(t32(x)), np.asarray(jb.silu(jnp.asarray(x))), **TOL)
    big = np.array([-50.0, -3.0, 0.0, 2.0, 19.0, 21.0, 60.0], np.float32)
    assert_close(tb.softplus(t32(big)),
                 np.asarray(jax.nn.softplus(jnp.asarray(big))), **TOL)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 16)
    pos = np.arange(7)[None, :] + 5
    assert_close(tb.rope_freqs(16, theta),
                 np.asarray(jb.rope_freqs(16, theta)), **TOL)
    assert_close(tb.apply_rope(t32(x), torch.tensor(pos), theta),
                 np.asarray(jb.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          theta)), **TOL)


@pytest.mark.parametrize("bias,theta", [(False, 10000.0), (True, 1e6),
                                        (False, None)])
def test_qkv_proj(bias, theta):
    rng = np.random.default_rng(2)
    jp, tp = _both(_spec_params(rng, tb.attn_specs(32, 4, 2, 8, bias)))
    x = _rand(rng, 2, 6, 32)
    pos = np.arange(6)[None, :]
    got = tb.qkv_proj(tp, t32(x), 4, 2, theta, torch.tensor(pos))
    want = jb.qkv_proj(jp, jnp.asarray(x), 4, 2, theta, jnp.asarray(pos))
    for g, w in zip(got, want):
        assert g.is_contiguous()
        assert_close(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("S,T,H,K,offset", [(6, 6, 4, 2, 0), (1, 9, 4, 4, 8),
                                            (5, 8, 6, 3, 3)])
def test_gqa_attend_and_causal_mask(S, T, H, K, offset):
    rng = np.random.default_rng(S * T)
    q, k, v = _rand(rng, 2, S, H, 8), _rand(rng, 2, T, K, 8), _rand(
        rng, 2, T, K, 8)
    tm = tb.causal_mask(S, T, offset)
    jm = jb.causal_mask(S, T, offset)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert_close(tb.gqa_attend(t32(q), t32(k), t32(v), tm),
                 np.asarray(jb.gqa_attend(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jm)), **TOL)


def test_out_proj_matches_einsum():
    rng = np.random.default_rng(3)
    o, wo = _rand(rng, 2, 5, 4, 8), _rand(rng, 4, 8, 32)
    want = np.einsum("bshk,hkd->bsd", o, wo)
    assert_close(tb.out_proj(t32(o), t32(wo)), want, **TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(4)
    jp, tp = _both(_spec_params(rng, tb.mlp_specs(32, 64, act)))
    x = _rand(rng, 2, 5, 32, scale=2.0)
    assert_close(tb.mlp(tp, t32(x), act),
                 np.asarray(jb.mlp(jp, jnp.asarray(x), act)), **TOL)


def test_causal_conv1d():
    rng = np.random.default_rng(5)
    x, w, b = _rand(rng, 2, 9, 12), _rand(rng, 4, 12), _rand(rng, 12)
    assert_close(tb.causal_conv1d(t32(x), t32(w), t32(b)),
                 np.asarray(jb.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(b))), **TOL)


def _mamba_params(rng, cfg):
    specs = tb.mamba2_specs(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                            cfg.ssm_expand, cfg.ssm_conv)
    tree = _spec_params(rng, specs)
    tree["in_proj"] *= 0.5
    return _both(tree)


@pytest.mark.parametrize("S,chunk", [(32, 8), (24, 24), (64, 128)])
def test_mamba2_forward_with_state(S, chunk):
    cfg = _SSMCfg()
    rng = np.random.default_rng(S)
    jp, tp = _mamba_params(rng, cfg)
    x = _rand(rng, 2, S, cfg.d_model)
    out, (conv, h) = tb.mamba2_forward(tp, t32(x), cfg, chunk=chunk,
                                       return_state=True)
    jout, (jconv, jh) = jb.mamba2_forward(jp, jnp.asarray(x), cfg,
                                          chunk=chunk, return_state=True)
    assert_close(out, np.asarray(jout), rtol=1e-4, atol=1e-4)
    assert_close(conv, np.asarray(jconv), rtol=1e-4, atol=1e-4)
    assert_close(h, np.asarray(jh), rtol=1e-4, atol=1e-4)
    plain, none = tb.mamba2_forward(tp, t32(x), cfg, chunk=chunk)
    assert none is None and torch.equal(plain, out)


def test_mamba2_decode():
    cfg = _SSMCfg()
    rng = np.random.default_rng(6)
    jp, tp = _mamba_params(rng, cfg)
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    x = _rand(rng, 2, 1, cfg.d_model)
    conv = _rand(rng, 2, cfg.ssm_conv - 1, d_inner + 2 * cfg.ssm_state)
    ssm = _rand(rng, 2, H, cfg.ssm_head_dim, cfg.ssm_state, scale=0.3)
    got = tb.mamba2_decode(tp, t32(x), cfg, t32(conv), t32(ssm))
    want = jb.mamba2_decode(jp, jnp.asarray(x), cfg, jnp.asarray(conv),
                            jnp.asarray(ssm))
    for g, w in zip(got, want):
        assert_close(g, np.asarray(w), rtol=1e-4, atol=1e-4)
