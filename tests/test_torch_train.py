"""The port's training path against the JAX package's, in float32 on the
CPU: the data pipeline (bit for bit), AdamW and its schedules on identical
gradients (1e-6), the losses (1e-6), the flash-attention and SSD
``autograd.Function``s' gradients against ``jax.vjp`` of the JAX oracles
(1e-5 of the largest gradient), the attention blocks (1e-5), and, for the
dense and ssm archs, one train step from the same weights (loss 1e-5
relative, every gradient leaf 1e-4·max|g|), a 5-step loss trajectory
(1e-4) and a 2-microbatch step (``tests/_torch_train_cases.py``).

The hybrid arch and the other dense configs run the same checks from
``tests/test_torch_train_hybrid.py``, the moe, vlm and encdec archs from
``tests/test_torch_train_archs.py``, so that each file stays under a
minute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, t32
from _torch_train_cases import (batches, check_microbatches,
                                check_one_step, check_trajectory, setup)

from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.ssd_scan.ref import ssd_ref
from repro.models import blocks as jb
from repro.train import optim as jopt
from repro.train import step as jstep
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_plain
from repro_torch.models.convert import (named_from_jax, opt_state_from_jax,
                                        params_from_jax)
from repro_torch.models import blocks as tb
from repro_torch.train import optim as topt
from repro_torch.train import step as tstep

HERE = ("qwen", "mamba2")


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [
    dict(vocab=256, seq_len=32, global_batch=4, seed=0),
    dict(vocab=64, seq_len=17, global_batch=6, seed=3, noise=0.3),
    dict(vocab=128, seq_len=16, global_batch=8, seed=1, n_hosts=2,
         host_id=1),
    dict(vocab=100, seq_len=33, global_batch=2, seed=5, structured=False),
])
def test_synthetic_lm_bit_for_bit(kw):
    want, got = JaxSyntheticLM(**kw), SyntheticLM(**kw)
    assert got.host_batch == want.host_batch
    for step in (0, 1, 7, 1000):
        w, g = want.batch(step), got.batch(step)
        assert set(w) == set(g) == {"tokens", "labels"}
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert [b["tokens"].tolist() for b in got.batches(2, start=3)] == \
        [b["tokens"].tolist() for b in want.batches(2, start=3)]


def _assert_grad_close(got, want, rtol=1e-5):
    """Within ``rtol`` of the largest magnitude of ``want`` (elementwise
    sums that cancel keep only that scale's rounding)."""
    want = np.asarray(want)
    assert_close(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


# ----------------------------------------------------------- optimizer
def _trees(rng, scale):
    shapes = {"a": (5, 7), "b": (11,), "c": (3, 2, 4)}
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("sched", ["warmup_cosine", "constant"])
def test_adamw_matches_jax_on_identical_grads(clip, sched):
    """Five updates from the same parameters and gradients (large enough
    that the clip binds): updates, moments, global norms, the applied
    parameters and the step, to 1e-6."""
    rng = np.random.default_rng(0)
    lr = dict(warmup_cosine=(lambda m: m.warmup_cosine(3e-3, warmup=2,
                                                       total=5)),
              constant=(lambda m: m.constant(1e-3)))[sched]
    jo = jopt.AdamW(lr=lr(jopt), clip_norm=clip)
    to = topt.AdamW(lr=lr(topt), clip_norm=clip)
    p = _trees(rng, 1.0)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: t32(v) for k, v in p.items()}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(5):
        g = _trees(rng, 3.0)
        ju, js, jgn = jo.update({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp)
        tu, ts, tgn = to.update({k: t32(v) for k, v in g.items()}, ts, tp)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
        for k in p:
            for got, want in ((tu[k], ju[k]), (ts.m[k], js.m[k]),
                              (ts.v[k], js.v[k])):
                _assert_grad_close(got, want, rtol=1e-6)
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
        for k in p:
            _assert_grad_close(tp[k], jp[k], rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5
    assert ts.step.dtype == torch.int32


def test_schedules_match_jax():
    jlr = jopt.warmup_cosine(1.0, warmup=10, total=110, floor=0.1)
    tlr = topt.warmup_cosine(1.0, warmup=10, total=110, floor=0.1)
    for s in (0, 1, 5, 9, 10, 11, 50, 109, 110, 200):
        np.testing.assert_allclose(
            float(tlr(torch.tensor(s, dtype=torch.int32))),
            float(jlr(jnp.asarray(s, jnp.int32))), rtol=1e-6, atol=1e-7)
    assert float(tlr(torch.tensor(0))) == 0.0
    assert float(tlr(torch.tensor(10))) == pytest.approx(1.0)
    assert float(tlr(torch.tensor(110))) == pytest.approx(0.1)
    assert float(topt.constant(2e-3)(torch.tensor(4))) == \
        float(jopt.constant(2e-3)(jnp.asarray(4)))


def test_global_norm_matches_jax():
    t = _trees(np.random.default_rng(1), 2.0)
    want = float(jopt.global_norm({k: jnp.asarray(v) for k, v in t.items()}))
    got = topt.global_norm({k: t32(v) for k, v in t.items()})
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# --------------------------------------------------------------- losses
def _labels(rng, shape, vocab):
    y = rng.integers(0, vocab, shape).astype(np.int32)
    y[rng.random(shape) < 0.2] = -1
    return y


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_softmax_xent_matches_jax(z_loss):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 9, 40)).astype(np.float32) * 3
    y = _labels(rng, (3, 9), 40)
    want = jstep.softmax_xent(jnp.asarray(logits), jnp.asarray(y), z_loss)
    got = tstep.softmax_xent(t32(logits), torch.as_tensor(y), z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    all_masked = tstep.softmax_xent(t32(logits), torch.full((3, 9), -1))
    assert float(all_masked) == 0.0


@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 512)])
def test_chunked_softmax_xent_and_its_gradients(S, chunk):
    """The loss and its gradients with respect to the hidden states and the
    unembedding, against ``jax.value_and_grad`` of the JAX function."""
    rng = np.random.default_rng(S)
    h = rng.standard_normal((2, S, 16)).astype(np.float32)
    w = rng.standard_normal((16, 50)).astype(np.float32) * 0.5
    y = _labels(rng, (2, S), 50)
    want, (gh_want, gw_want) = jax.value_and_grad(
        lambda a, b: jstep.chunked_softmax_xent(a, b, jnp.asarray(y),
                                                chunk=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = t32(h).requires_grad_(), t32(w).requires_grad_()
    got = tstep.chunked_softmax_xent(th, tw, torch.as_tensor(y), chunk=chunk)
    gh, gw = torch.autograd.grad(got, (th, tw))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert_close(gh, gh_want, rtol=1e-6, atol=1e-6 * float(
        np.abs(gh_want).max()))
    assert_close(gw, gw_want, rtol=1e-6, atol=1e-6 * float(
        np.abs(gw_want).max()))
    full = tstep.softmax_xent(t32(h) @ t32(w), torch.as_tensor(y))
    np.testing.assert_allclose(float(got.detach()), float(full), rtol=1e-6)


# ---------------------------------------------- kernels under autograd
@pytest.mark.parametrize("B,S,T,H,K,hd,causal", [
    (2, 24, 24, 4, 4, 16, True),
    (1, 32, 32, 8, 2, 32, True),       # G 4
    (2, 16, 40, 6, 3, 16, False),      # non-causal, G 2, T != S
    (1, 20, 20, 4, 1, 64, False),
])
def test_flash_attention_gradients_match_jax_vjp(B, S, T, H, K, hd, causal):
    """``FlashAttention``'s backward (the vjp of the plain version) against
    ``jax.vjp`` of ``attention_ref``, in the model's [B,S,H,hd] layout."""
    rng = np.random.default_rng(S + T + H)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    go = rng.standard_normal((B, S, H, hd)).astype(np.float32)

    def jfn(q, k, v):
        o = attention_ref(q.swapaxes(1, 2), k.swapaxes(1, 2),
                          v.swapaxes(1, 2), causal)
        return o.swapaxes(1, 2)
    out, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(go))
    tq, tk, tv = (t32(a).requires_grad_() for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    assert got.grad_fn is not None
    assert_close(got.detach(), out, rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(got, (tq, tk, tv), t32(go))
    for g, w in zip(grads, want):
        _assert_grad_close(g, w)


def test_flash_attention_without_gradients_takes_the_forward_alone(
        monkeypatch):
    """Serving (no_grad, or inputs without gradients) never goes through
    the autograd.Function, and the CPU path counts no launch."""
    calls = []
    monkeypatch.setattr(fa.FlashAttention, "apply",
                        lambda *a: calls.append(a))
    q = torch.randn(1, 8, 2, 16)
    before = fa.LAUNCHES
    out = fa.flash_attention(q, q, q)
    with torch.no_grad():
        out2 = fa.flash_attention(q.requires_grad_(), q, q)
    assert not calls and out.grad_fn is None and out2.grad_fn is None
    assert fa.LAUNCHES == before


def _ssd_inputs(rng, B, S, H, P, N):
    return (rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.5,
            rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32) * 0.5,
            rng.standard_normal((B, S, N)).astype(np.float32) * 0.5)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 3, 8, 16, 16),
    (1, 96, 2, 16, 8, 32),
])
def test_ssd_scan_gradients_match_jax_vjp(B, S, H, P, N, chunk):
    """The port's ``ssd_scan`` (the chunk step through ``SsdChunk``, the
    recurrence through autograd) against ``jax.vjp`` of the sequential
    oracle ``ssd_ref``: outputs and final state, and the gradients of x,
    dt, A, B and C."""
    rng = np.random.default_rng(S + N)
    args = _ssd_inputs(rng, B, S, H, P, N)
    gy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    gh = rng.standard_normal((B, H, P, N)).astype(np.float32)
    (y, h), vjp = jax.vjp(ssd_ref, *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    targs = [t32(a).requires_grad_() for a in args]
    ty, th = ssd.ssd_scan(*targs, chunk=chunk)
    assert_close(ty.detach(), y, rtol=1e-4, atol=1e-4)
    assert_close(th.detach(), h, rtol=1e-4, atol=1e-4)
    grads = torch.autograd.grad((ty, th), targs, (t32(gy), t32(gh)))
    for name, g, w in zip(("x", "dt", "A", "B", "C"), grads, want):
        _assert_grad_close(g, w)


def test_ssd_chunk_function_is_the_plain_vjp():
    """``SsdChunk``'s backward against autograd through
    ``ssd_chunk_plain`` itself, all three outputs carrying a gradient."""
    rng = np.random.default_rng(4)
    BH, nc, Q, P, N, Bsz = 4, 3, 8, 4, 6, 2
    args = [rng.standard_normal((BH, nc, Q, P)) * 0.5,
            rng.uniform(0.01, 0.2, (BH, nc, Q, 1)),
            rng.standard_normal((Bsz, nc, Q, N)) * 0.5,
            rng.standard_normal((Bsz, nc, Q, N)) * 0.5,
            -rng.uniform(0.5, 2.0, (BH, 1))]
    outs_g = [t32(rng.standard_normal(s)) for s in
              ((BH, nc, Q, P), (BH, nc, P, N), (BH, nc, Q, 1))]
    a1 = [t32(a).requires_grad_() for a in args]
    a2 = [t32(a).requires_grad_() for a in args]
    got = torch.autograd.grad(ssd.ssd_chunk(*a1), a1, outs_g)
    want = torch.autograd.grad(ssd_chunk_plain(*a2), a2, outs_g)
    for g, w in zip(got, want):
        _assert_grad_close(g, w.numpy(), rtol=1e-6)
    with torch.no_grad():
        assert ssd.ssd_chunk(*a1)[0].grad_fn is None


# ---------------------------------------------------- attention blocks
class _Cfg:
    n_heads, n_kv_heads, rope_theta = 4, 2, 10000.0

    def __init__(self, causal=True):
        self.causal = causal


def _attn_params(rng, D=32, H=4, K=2, hd=8):
    specs = jb.attn_specs(D, H, K, hd, True)
    p = {k: (rng.standard_normal(s.shape) * 0.3).astype(np.float32)
         for k, s in specs.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: t32(v) for k, v in p.items()})


@pytest.mark.parametrize("causal", [True, False])
def test_attention_block_matches_jax(causal):
    rng = np.random.default_rng(5)
    jp, tp = _attn_params(rng)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    pos = np.arange(12)[None, :]
    want, (wk, wv) = jb.attention(jp, jnp.asarray(x), _Cfg(causal),
                                  jnp.asarray(pos))
    got, (gk, gv) = tb.attention(tp, t32(x), _Cfg(causal),
                                 torch.as_tensor(pos))
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_attention_decode_matches_jax():
    rng = np.random.default_rng(6)
    jp, tp = _attn_params(rng)
    T = 8
    ck = rng.standard_normal((2, T, 2, 8)).astype(np.float32)
    cv = rng.standard_normal((2, T, 2, 8)).astype(np.float32)
    jk, jv = jnp.asarray(ck), jnp.asarray(cv)
    tk, tv = t32(ck), t32(cv)
    for pos in (3, 7, 9):               # 9 wraps the ring buffer
        x = rng.standard_normal((2, 1, 32)).astype(np.float32)
        want, (jk, jv) = jb.attention_decode(jp, jnp.asarray(x), _Cfg(), jk,
                                             jv, jnp.asarray(pos, jnp.int32))
        got, (tk, tv) = tb.attention_decode(tp, t32(x), _Cfg(), tk, tv, pos)
        assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert_close(tk, jk, rtol=1e-6, atol=1e-6)
        assert_close(tv, jv, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S,T,bq,bk,causal", [
    (16, 16, 4, 8, True), (12, 20, 5, 6, False), (8, 8, 1024, 2048, True)])
def test_blockwise_gqa_attend_matches_jax(S, T, bq, bk, causal):
    rng = np.random.default_rng(S * T)
    q = rng.standard_normal((2, S, 6, 8)).astype(np.float32)
    k = rng.standard_normal((2, T, 3, 8)).astype(np.float32)
    v = rng.standard_normal((2, T, 3, 8)).astype(np.float32)
    want = jb.blockwise_gqa_attend(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=causal, block_q=bq, block_k=bk)
    got = tb.blockwise_gqa_attend(*(t32(a) for a in (q, k, v)),
                                  causal=causal, block_q=bq, block_k=bk)
    assert_close(got, want, rtol=1e-5, atol=1e-5)
    mask = (tb.causal_mask(S, T) if causal
            else torch.ones((1, 1, 1, S, T), dtype=torch.bool))
    dense = tb.gqa_attend(*(t32(a) for a in (q, k, v)), mask)
    assert_close(got, dense.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("case", HERE)
def test_one_train_step_matches_jax(case):
    check_one_step(case)


@pytest.mark.parametrize("case", HERE)
def test_loss_trajectory_matches_jax(case):
    check_trajectory(case)


@pytest.mark.parametrize("case", HERE)
def test_microbatches_match_jax(case):
    check_microbatches(case)


def test_opt_state_from_jax_resumes_the_jax_run():
    """Two JAX train steps, the weights and the AdamState carried across
    (``params_from_jax``, ``opt_state_from_jax``), and one more step on
    each side: the same loss and gradient norm (1e-5 relative)."""
    c = setup("qwen", seed=3)
    jo, to = jopt.AdamW(lr=1e-3), topt.AdamW(lr=1e-3)
    jfn = jax.jit(jstep.make_train_step(c.japi, jo))
    jp, js = c.jparams, jo.init(c.jparams)
    for i in range(2):
        jp, js, _ = jfn(jp, js, batches(c.tcfg, i, seed=3)[0])
    jp_np, js_np = jax.tree_util.tree_map(np.asarray, (jp, js))
    model = params_from_jax(c.tcfg, jp_np, device="cpu", trainable=True)
    state = opt_state_from_jax(c.tcfg, js_np, device="cpu")
    assert int(state.step) == 2 and state.step.dtype == torch.int32
    assert list(state.m) == [n for n, _ in model.named_parameters()]
    want_v = named_from_jax(c.tcfg, js_np.v, device="cpu")
    assert all(torch.equal(state.v[k], want_v[k]) for k in want_v)
    jb, tb = batches(c.tcfg, 2, seed=3)
    jm = jfn(jp, js, jb)[2]
    tm = tstep.make_train_step(c.tapi, to)(model, state, tb)[2]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            opt_state_from_jax(c.tcfg, js_np)
