"""The port's LM (dense, moe, ssm, hybrid and vlm families) and
``ServeEngine`` against the JAX package, from the same parameters carried
across with ``params_from_jax``, in float32 on the CPU (whisper, the encdec
family, is ``tests/test_torch_whisper.py``'s).

Tolerance 1e-4 on logits and caches: the SSD core is a chunked scan that
the JAX tests hold at 1e-4 against the sequential recurrence, and the port
computes it in another order (chunk kernel + recurrence, not the JAX
in-line scan). The teacher-forced prefill + decode = forward check runs
within the port at the same 1e-4. The serving runs must give identical
tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.models.registry import list_archs as jax_list_archs
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_config, get_model, list_archs
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
B = 2

CASES = {
    "zamba2": ("zamba2-1.2b", {}),
    "zamba2-tail": ("zamba2-1.2b", {"n_layers": 7}),
    "zamba2-gqa": ("zamba2-1.2b", {"n_kv_heads": 2}),
    "mamba2": ("mamba2-370m", {}),
    "qwen": ("qwen1.5-0.5b", {}),
    "yi": ("yi-6b", {}),
    "stablelm": ("stablelm-1.6b", {}),
    "starcoder2": ("starcoder2-15b", {}),
    "qwen3-moe": ("qwen3-moe-235b-a22b", {}),
    "dbrx": ("dbrx-132b", {}),
    "internvl2": ("internvl2-1b", {}),
}
# the moe and vlm cases run the per-case tests below from a file of their
# own, tests/test_torch_lm_moe_vlm.py, so that each file stays under a
# minute on the CPU
MOE_VLM = ("qwen3-moe", "dbrx", "internvl2")
HERE = [c for c in CASES if c not in MOE_VLM]
# zero/one-initialised leaves: the norms' weights and layernorm biases, the
# qkv and MLP biases, the Mamba2 scalars
_PERTURB = ("A_log", "dt_bias", "D", "norm_w", "w", "b", "bq", "bk", "bv",
            "b_in", "b_out")
# JAX ``get_model(cfg).count_params()`` at full width
FULL_PARAMS = {
    "mamba2-370m": 368_338_432,
    "qwen1.5-0.5b": 463_987_712,
    "stablelm-1.6b": 1_644_367_872,
    "starcoder2-15b": 15_655_653_376,
    "yi-6b": 6_061_035_520,
    "zamba2-1.2b": 1_104_937_856,
    "qwen3-moe-235b-a22b": 235_093_634_560,
    "dbrx-132b": 131_597_021_184,
    "internvl2-1b": 494_583_808,
}


def _setup(case, seed=0, gain=1.0):
    """(JAX cfg, JAX params, port cfg, port model) from one JAX init, with
    the zero/one-initialised leaves perturbed so they matter and the other
    weights but the embedding scaled by ``gain`` (a larger gain keeps greedy
    decoding from echoing the last prompt token through the tied
    embedding)."""
    name, over = CASES[case]
    jcfg = dataclasses.replace(jax_config(name).reduced(**over), remat=False)
    tcfg = get_config(name).reduced(**over)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        key = getattr(path[-1], "key", None)
        if key in _PERTURB:
            return a + rng.normal(0, 0.3, a.shape).astype(np.float32)
        return a if key == "embed" else a * np.float32(gain)
    tree = jax.tree_util.tree_map_with_path(perturb, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, params_from_jax(tcfg, tree, device="cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _vis(cfg, seed):
    """Seeded patch embeddings [B, n_vis, D] for a vlm config, else None."""
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)


def test_configs_are_copies_of_jax():
    assert list_archs() == ["dbrx-132b", "internvl2-1b", "mamba2-370m",
                            "qwen1.5-0.5b", "qwen3-moe-235b-a22b",
                            "stablelm-1.6b", "starcoder2-15b",
                            "whisper-tiny", "yi-6b", "zamba2-1.2b"]
    for name in list_archs():
        j = dataclasses.asdict(jax_config(name))
        t = dataclasses.asdict(get_config(name))
        assert t["dtype"] == torch.bfloat16 and j["dtype"] == jnp.bfloat16
        for k, v in t.items():
            if k != "dtype":
                assert j[k] == v, (name, k)
        for over in ({}, {"n_layers": 7}):
            jr = dataclasses.asdict(jax_config(name).reduced(**over))
            tr = dataclasses.asdict(get_config(name).reduced(**over))
            assert tr["dtype"] == torch.float32
            assert all(jr[k] == v for k, v in tr.items() if k != "dtype")


@pytest.mark.parametrize("name", sorted(FULL_PARAMS))
def test_full_width_param_count_matches_jax(name):
    """Arithmetic over the specs at full width: nothing is allocated."""
    n = get_model(get_config(name), device="cpu").count_params()
    assert n == jax_model(jax_config(name)).count_params()
    assert n == FULL_PARAMS[name]


@pytest.mark.parametrize("case", HERE)
def test_param_count_and_names(case):
    jcfg, jparams, tcfg, model = _setup(case)
    n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jparams))
    api = get_model(tcfg, device="cpu")
    assert api.count_params() == n
    assert sum(p.numel() for p in model.parameters()) == n
    names = dict(model.named_parameters())
    assert "embed" in names and "final_norm.w" in names
    if tcfg.family == "hybrid":
        assert "groups.1.2.mamba.in_proj" in names
        assert "shared.attn.wq" in names and "shared.mlp.w_gate" in names
        assert ("tail.0.mamba.A_log" in names) == (tcfg.n_layers == 7)
    np.testing.assert_array_equal(
        names["embed"].numpy(), np.asarray(jparams["embed"]))


@pytest.mark.parametrize("case", HERE)
def test_forward_prefill_decode_match_jax(case):
    jcfg, jparams, tcfg, model = _setup(case)
    rng = np.random.default_rng(1)
    n, k = 16, 12
    toks = rng.integers(0, tcfg.vocab, (B, n)).astype(np.int32)
    tt = torch.tensor(toks, dtype=torch.long)
    vis = _vis(tcfg, 2)
    jv, tv = (None, None) if vis is None else (jnp.asarray(vis),
                                               torch.tensor(vis))
    nv = tcfg.n_vis_tokens if vis is not None else 0
    max_len = 20 + nv

    want, jaux = jlm.forward(jcfg, jparams, jnp.asarray(toks), vis_embeds=jv)
    got, aux = lm.forward(tcfg, model, tt, vis_embeds=tv, return_aux=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(aux), np.asarray(jaux), **TOL)

    jlog, jcache = jlm.prefill(jcfg, jparams, jnp.asarray(toks[:, :k]),
                               max_len, vis_embeds=jv)
    tlog, tcache = lm.prefill(tcfg, model, tt[:, :k], max_len, vis_embeds=tv)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    jflat = jax.tree_util.tree_leaves_with_path(jcache)
    tflat = dict(jax.tree_util.tree_leaves_with_path(tcache))
    assert len(jflat) == len(tflat)
    for path, arr in jflat:
        np.testing.assert_allclose(_np(tflat[path]), np.asarray(arr),
                                   err_msg=str(path), **TOL)

    dec = jax.jit(lambda p, c, t, pos: jlm.decode_step(jcfg, p, c, t, pos))
    for i in range(k, n):
        jlog, jcache = dec(jparams, jcache, jnp.asarray(toks[:, i:i + 1]),
                           jnp.asarray(nv + i, jnp.int32))
        tlog, tcache = lm.decode_step(tcfg, model, tcache, tt[:, i:i + 1],
                                      nv + i)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL,
                                   err_msg=f"{case}: decode step {i}")


@pytest.mark.parametrize("case", HERE)
def test_prefill_decode_matches_forward(case):
    """Teacher forcing within the port (tests/test_archs.py's check):
    forward logits at position i equal prefill(tokens[:k]) followed by
    decode steps, including a KV ring buffer exactly full at the end."""
    _, _, tcfg, model = _setup(case, seed=1)
    api = get_model(tcfg, device="cpu")
    n, k = 16, 12
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, tcfg.vocab, (B, n)), dtype=torch.long)
    batch = {"tokens": toks}
    nv = 0
    if tcfg.family == "vlm":
        batch["vis_embeds"] = torch.tensor(_vis(tcfg, 3))
        nv = tcfg.n_vis_tokens
    full = api.forward(model, batch)
    logits, cache = api.prefill(model, {**batch, "tokens": toks[:, :k]},
                                nv + n)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, nv + k - 1]),
                               **TOL)
    for i in range(k, n):
        logits, cache = api.decode(model, cache, toks[:, i:i + 1], nv + i)
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, nv + i]),
                                   **TOL, err_msg=f"{case}: decode step {i}")


@pytest.mark.parametrize("case", ["zamba2-tail", "mamba2", "qwen", "yi",
                                  "stablelm", "starcoder2"])
def test_serve_engine_matches_jax(case):
    jcfg, jparams, tcfg, model = _setup(case, seed=2, gain=8.0)
    rng = np.random.default_rng(3)
    vlm = tcfg.family == "vlm"
    # the vlm engine passes one patch prefix to every wave: full waves
    prompts = [rng.integers(0, tcfg.vocab, 8).astype(np.int32)
               for _ in range(4 if vlm else 5)]
    vis = _vis(tcfg, 4)
    jextra = None if vis is None else {"vis_embeds": jnp.asarray(vis)}
    textra = None if vis is None else {"vis_embeds": vis}
    max_len = 32 + (tcfg.n_vis_tokens if vlm else 0)
    jeng = JaxEngine(jax_model(jcfg), max_len=max_len, batch_slots=2)
    jeng.load(jparams)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=6) for p in prompts]
    jeng.run(jreqs, extra_batch=jextra)
    teng = ServeEngine(get_model(tcfg, device="cpu"), max_len=max_len,
                       batch_slots=2)
    teng.load(model)
    treqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    teng.run(treqs, extra_batch=textra)
    assert all(r.done and len(r.out) == 6 for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert len({t for r in treqs for t in r.out}) > len(prompts)


def test_serve_engine_eos_and_waves():
    _, _, tcfg, model = _setup("zamba2", seed=4, gain=8.0)
    eng = ServeEngine(get_model(tcfg, device="cpu"), max_len=32,
                      batch_slots=2)
    eng.load(model)
    prompt = np.arange(8, dtype=np.int32)
    r = Request(prompt=prompt, max_new_tokens=5)
    eng.run([r])
    assert len(r.out) == 5
    eos = r.out[2]
    eng_eos = ServeEngine(get_model(tcfg, device="cpu"), max_len=32,
                          batch_slots=2, eos_id=eos)
    eng_eos.load(model)
    r2 = Request(prompt=prompt, max_new_tokens=5)
    eng_eos.run([r2])
    # the prefill's token is never taken for EOS, as in the JAX engine
    assert r2.out == r.out[:r.out.index(eos, 1) + 1]
    with pytest.raises(ValueError, match="one length"):
        eng.run([Request(prompt=prompt), Request(prompt=prompt[:4])])


def test_entry_points_default_to_the_card():
    cfg = get_config("zamba2-1.2b").reduced()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(get_model(cfg))
    jcfg = dataclasses.replace(jax_config("zamba2-1.2b").reduced(),
                               remat=False)
    tree = jax.tree_util.tree_map(
        np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(cfg, tree)


def test_list_archs_equals_jax_registry():
    """Every architecture the JAX package registers is served by the port,
    and an unknown family raises."""
    assert list_archs() == jax_list_archs()
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              family="retrieval")
    with pytest.raises(ValueError, match="unknown family"):
        get_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        lm.init_cache(cfg, 1, 8, device="cpu")


def test_prefill_rejects_prompt_longer_than_cache():
    _, _, tcfg, model = _setup("qwen")
    with pytest.raises(ValueError, match="max_len"):
        lm.prefill(tcfg, model, torch.zeros(1, 9, dtype=torch.long), 8)


def test_init_params_on_generator():
    cfg = get_config("zamba2-1.2b").reduced(n_layers=7)
    api = get_model(cfg, device="cpu")
    a = api.init(torch.Generator().manual_seed(0))
    b = api.init(torch.Generator().manual_seed(0))
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert a.groups[0][0]["mamba"]["A_log"].dtype == torch.float32
    logits = api.forward(a, {"tokens": torch.zeros(1, 8, dtype=torch.long)})
    assert logits.shape == (1, 8, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def test_bf16_weights_cast_once_except_f32_reads():
    cfg = get_config("zamba2-1.2b").reduced(dtype=torch.bfloat16)
    model = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    m = model.groups[0][0]
    assert m["mamba"]["in_proj"].dtype == torch.bfloat16
    assert model.embed.dtype == torch.bfloat16
    assert model.shared["attn"]["wq"].dtype == torch.bfloat16
    for key in ("A_log", "D", "dt_bias", "norm_w"):
        assert m["mamba"][key].dtype == torch.float32
    assert m["norm"]["w"].dtype == torch.float32
    assert model.shared["ln1"]["w"].dtype == torch.float32
    assert model.final_norm["w"].dtype == torch.float32
    logits, _ = lm.prefill(cfg, model, torch.zeros(2, 8, dtype=torch.long), 16)
    assert logits.dtype == torch.bfloat16
