"""The port's LM (dense, ssm and hybrid families) and ``ServeEngine``
against the JAX package, from the same parameters carried across with
``params_from_jax``, in float32 on the CPU.

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
}
_PERTURB = ("A_log", "dt_bias", "D", "norm_w", "w", "bq", "bk", "bv")


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


def test_configs_are_copies_of_jax():
    assert list_archs() == ["mamba2-370m", "qwen1.5-0.5b", "zamba2-1.2b"]
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


@pytest.mark.parametrize("case", list(CASES))
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


@pytest.mark.parametrize("case", list(CASES))
def test_forward_prefill_decode_match_jax(case):
    jcfg, jparams, tcfg, model = _setup(case)
    rng = np.random.default_rng(1)
    n, k, max_len = 16, 12, 20
    toks = rng.integers(0, tcfg.vocab, (B, n)).astype(np.int32)
    tt = torch.tensor(toks, dtype=torch.long)

    want, _ = jlm.forward(jcfg, jparams, jnp.asarray(toks))
    got = lm.forward(tcfg, model, tt)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    jlog, jcache = jlm.prefill(jcfg, jparams, jnp.asarray(toks[:, :k]),
                               max_len)
    tlog, tcache = lm.prefill(tcfg, model, tt[:, :k], max_len)
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
                           jnp.asarray(i, jnp.int32))
        tlog, tcache = lm.decode_step(tcfg, model, tcache, tt[:, i:i + 1], i)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL,
                                   err_msg=f"{case}: decode step {i}")


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_decode_matches_forward(case):
    """Teacher forcing within the port (tests/test_archs.py's check):
    forward logits at position i equal prefill(tokens[:k]) followed by
    decode steps, including a KV ring buffer exactly full at the end."""
    _, _, tcfg, model = _setup(case, seed=1)
    api = get_model(tcfg, device="cpu")
    n, k = 16, 12
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, tcfg.vocab, (B, n)), dtype=torch.long)
    full = api.forward(model, {"tokens": toks})
    logits, cache = api.prefill(model, {"tokens": toks[:, :k]}, n)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, k - 1]), **TOL)
    for i in range(k, n):
        logits, cache = api.decode(model, cache, toks[:, i:i + 1], i)
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, i]), **TOL,
                                   err_msg=f"{case}: decode step {i}")


@pytest.mark.parametrize("case", ["zamba2-tail", "mamba2", "qwen"])
def test_serve_engine_matches_jax(case):
    jcfg, jparams, tcfg, model = _setup(case, seed=2, gain=8.0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, 8).astype(np.int32)
               for _ in range(5)]
    jeng = JaxEngine(jax_model(jcfg), max_len=32, batch_slots=2)
    jeng.load(jparams)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=6) for p in prompts]
    jeng.run(jreqs)
    teng = ServeEngine(get_model(tcfg, device="cpu"), max_len=32,
                       batch_slots=2)
    teng.load(model)
    treqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    teng.run(treqs)
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


def test_unported_families_raise():
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              family="moe")
    with pytest.raises(NotImplementedError, match="A.12"):
        get_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="A.12"):
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
