"""The port's whisper (encdec) against the JAX package's, from the same
parameters carried across with ``params_from_jax``, in float32 on the CPU:
``sinusoid_pos``, ``encode``, ``forward``, ``prefill`` and ``decode_step``
logits and caches, ``ServeEngine`` tokens with ``extra_batch={"frames":
…}``, and teacher forcing within the port. Tolerance 1e-4, as
``tests/test_torch_lm.py`` holds the decoder LMs; ``sinusoid_pos`` at
1e-5 absolute (its values lie in [-1, 1], and at 1,500 positions the
angles reach 1,500 rad, where one float32 ulp is 1.2e-4 rad)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import whisper as jw
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.models import whisper
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import (WHISPER_FRAMES, get_config,
                                         get_model)
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
NAME = "whisper-tiny"
B, N_FRAMES = 2, 24
# zero/one-initialised leaves: the layernorms' weights and biases, the qkv
# and MLP biases
_PERTURB = ("w", "b", "bq", "bk", "bv", "b_in", "b_out")


def _setup(seed=0, embed_gain=1.0):
    """(JAX cfg, JAX params, port cfg, port model) from one JAX init, with
    the zero/one-initialised leaves perturbed and the embedding scaled by
    ``embed_gain`` (a larger one lets the tokens, not the sinusoids of the
    positions, steer greedy decoding)."""
    jcfg = dataclasses.replace(jax_config(NAME).reduced(), remat=False)
    tcfg = get_config(NAME).reduced()
    params = jw.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        key = getattr(path[-1], "key", None)
        if key in _PERTURB:
            return a + rng.normal(0, 0.3, a.shape).astype(np.float32)
        return a * np.float32(embed_gain) if key == "embed" else a
    tree = jax.tree_util.tree_map_with_path(perturb, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, params_from_jax(tcfg, tree, device="cpu")


def _frames(seed, n=B, t=N_FRAMES, d=64):
    return np.random.default_rng(seed).standard_normal((n, t, d)).astype(
        np.float32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("S,D,offset", [(50, 64, 0), (1, 384, 7),
                                        (1500, 384, 0)])
def test_sinusoid_pos_matches_jax(S, D, offset):
    got = whisper.sinusoid_pos(S, D, offset)
    assert got.dtype == torch.float32 and got.shape == (S, D)
    np.testing.assert_allclose(_np(got), np.asarray(jw.sinusoid_pos(
        S, D, offset)), rtol=0, atol=1e-5)


def test_specs_names_and_counts():
    jcfg, jparams, tcfg, model = _setup()
    n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jparams))
    api = get_model(tcfg, device="cpu")
    assert api.count_params() == n == api.active_params()
    assert sum(p.numel() for p in model.parameters()) == n
    names = dict(model.named_parameters())
    for must in ("embed", "frame_proj", "enc_layers.1.attn.bk",
                 "enc_norm.b", "dec_layers.3.xattn.wq", "dec_layers.0.ln_x.w",
                 "final_norm.w"):
        assert must in names
    full = get_model(get_config(NAME), device="cpu").count_params()
    assert full == jax_model(jax_config(NAME)).count_params() == 36_624_768
    cache = api.init_cache(3, 16)
    assert cache["k"].shape == (tcfg.n_layers, 3, 16, tcfg.n_kv_heads,
                                tcfg.hd)
    assert cache["xk"].shape[2] == WHISPER_FRAMES == 1500


def test_encode_matches_jax():
    jcfg, jparams, tcfg, model = _setup()
    fr = _frames(1)
    want = jw.encode(jcfg, jparams, jnp.asarray(fr))
    got = whisper.encode(tcfg, model, torch.tensor(fr))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_forward_prefill_decode_match_jax():
    jcfg, jparams, tcfg, model = _setup()
    rng = np.random.default_rng(2)
    n, k, max_len = 16, 12, 20
    toks = rng.integers(0, tcfg.vocab, (B, n)).astype(np.int32)
    tt = torch.tensor(toks, dtype=torch.long)
    fr = _frames(3)
    tf = torch.tensor(fr)

    want, _ = jw.forward(jcfg, jparams, jnp.asarray(toks), jnp.asarray(fr))
    got = whisper.forward(tcfg, model, tt, tf)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    jlog, jcache = jw.prefill(jcfg, jparams, jnp.asarray(toks[:, :k]),
                              jnp.asarray(fr), max_len)
    tlog, tcache = whisper.prefill(tcfg, model, tt[:, :k], tf, max_len)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    assert set(tcache) == set(jcache)
    for name, arr in jcache.items():
        assert tuple(tcache[name].shape) == arr.shape, name
        np.testing.assert_allclose(_np(tcache[name]), np.asarray(arr),
                                   err_msg=name, **TOL)

    dec = jax.jit(lambda p, c, t, pos: jw.decode_step(jcfg, p, c, t, pos))
    for i in range(k, n):
        jlog, jcache = dec(jparams, jcache, jnp.asarray(toks[:, i:i + 1]),
                           jnp.asarray(i, jnp.int32))
        tlog, tcache = whisper.decode_step(tcfg, model, tcache,
                                           tt[:, i:i + 1], i)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL,
                                   err_msg=f"decode step {i}")
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name]), np.asarray(
            jcache[name]), err_msg=name, **TOL)


def test_prefill_decode_matches_forward():
    """Teacher forcing within the port (tests/test_archs.py's check):
    forward logits at position i equal prefill(tokens[:k]) followed by
    decode steps, with the self-attention ring buffer exactly full at the
    end."""
    _, _, tcfg, model = _setup(seed=1)
    api = get_model(tcfg, device="cpu")
    n, k = 16, 12
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, tcfg.vocab, (B, n)), dtype=torch.long)
    fr = torch.tensor(_frames(4))
    full = api.forward(model, {"tokens": toks, "frames": fr})
    logits, cache = api.prefill(model, {"tokens": toks[:, :k], "frames": fr},
                                n)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, k - 1]), **TOL)
    for i in range(k, n):
        logits, cache = api.decode(model, cache, toks[:, i:i + 1], i)
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, i]), **TOL,
                                   err_msg=f"decode step {i}")


def test_serve_engine_matches_jax():
    """Both engines serve 4 requests in 2 waves with the same frames passed
    through ``extra_batch``: identical tokens."""
    jcfg, jparams, tcfg, model = _setup(seed=2, embed_gain=10.0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, 4).astype(np.int32)
               for _ in range(4)]
    fr = _frames(5)
    jeng = JaxEngine(jax_model(jcfg), max_len=16, batch_slots=B)
    jeng.load(jparams)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=6) for p in prompts]
    jeng.run(jreqs, extra_batch={"frames": jnp.asarray(fr)})
    teng = ServeEngine(get_model(tcfg, device="cpu"), max_len=16,
                       batch_slots=B)
    teng.load(model)
    treqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    teng.run(treqs, extra_batch={"frames": fr})
    assert all(r.done and len(r.out) == 6 for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert len({t for r in treqs for t in r.out}) > 1


def test_whisper_model_rejects_other_families():
    cfg = get_config("yi-6b").reduced()
    with pytest.raises(ValueError, match="encdec"):
        whisper.Whisper(cfg, {})
    with pytest.raises(ValueError, match="whisper"):
        from repro_torch.models import lm
        lm.model_specs(get_config(NAME).reduced())


@pytest.mark.parametrize("name", [NAME, "internvl2-1b", "yi-6b"])
@pytest.mark.parametrize("seq_len", [64, 1024, 4096, 32768])
def test_vis_frames_match_jax(name, seq_len):
    """The stub frontends' prefix length: whisper's frames scale with the
    prompt (capped at 1,500), a vlm's patch tokens come from its config."""
    from repro.models.registry import ShapeSpec as JaxShapeSpec
    from repro.models.registry import _vis_frames as jax_vis_frames
    from repro_torch.models.registry import ShapeSpec, _vis_frames

    spec = ShapeSpec("cell", seq_len, 1, "prefill")
    assert _vis_frames(get_config(name), spec) == jax_vis_frames(
        jax_config(name), JaxShapeSpec("cell", seq_len, 1, "prefill"))
