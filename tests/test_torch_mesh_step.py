"""A train step on a mesh, in the port: the counterpart of the JAX
package's dry-run-lite (``tests/test_distribution.py::
test_dryrun_lite_8dev``), the flash wrapper's choice of KV heads per rank,
and a meshed step held to the unmeshed one.

* Dry-run-lite: the reference's three archs, reduced as there, train one
  step on meta tensors on a (2, 4) mesh over a dry world of 8 ranks (the
  ``"fake"`` backend, in this one process); the step must issue
  collectives on both axes and count FLOPs, and decode must run under
  ``cache_shardings``.
* A reduced step on a real one-rank gloo mesh equals the unmeshed step
  (loss, gradients, new weights) on the CPU.

Each dry or real world is opened by a context manager that destroys it,
so that no default process group leaks into the next test file an xdist
worker runs."""
import math

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.launch import comm_stats
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import dry_world, local_world, make_mesh
from repro_torch.models import lm
from repro_torch.models.registry import ShapeSpec, get_config, get_model
from repro_torch.sharding import policy as pol
from repro_torch.train.optim import AdamW
from repro_torch.train.step import make_loss_fn, make_train_step


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "dbrx-132b",
                                  "mamba2-370m"])
def test_dryrun_lite_8dev(arch):
    cfg = get_config(arch).reduced(d_model=128, vocab=1024, n_heads=8,
                                   n_kv_heads=8, head_dim=None)
    api = get_model(cfg, device="cpu")
    with dry_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        recs, flops = comm_stats.trace_train_step(
            api, mesh, ShapeSpec("t", 256, 8, "train"))
        st = comm_stats.collective_stats(recs)
        assert st["count"] > 0, "the meshed step issued no collectives"
        assert flops > 0
        assert {c.axis for c in recs} == {"data", "model"}
        # decode under cache_shardings
        with pol.sharding_policy(mesh):
            model = api.build(S.place_tree(api.abstract_params(),
                                           S.param_shardings(mesh, api)))
            cache = lm.init_cache(cfg, 8, 64, device="meta")
            cache = S.place_tree(cache, S.cache_shardings(mesh, cache))
            tok = api.input_specs(ShapeSpec("d", 64, 8, "decode"))["tokens"]
            tok = S.place(tok, S.batch_shardings(mesh, {"tokens": tok})[
                "tokens"])
            logits, _ = api.decode(model, cache, tok, 5)
        assert tuple(logits.shape) == (8, 1, 1024)


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("n", [2, 4])
def test_kv_heads_for_matches_the_reference_map(K, n):
    """H 8 query heads over n model shards, K KV heads replicated: each
    shard's heads read KV heads first.. first+count-1, and the kernel's
    local map h_local // G_local equals the reference's h // G less
    first."""
    H = 8
    G, Hl = H // K, H // n
    for r in range(n):
        first, count = fops.kv_heads_for(r, Hl, G)
        g_local = Hl // count
        for j in range(Hl):
            assert (r * Hl + j) // G == first + j // g_local
        assert {(r * Hl + j) // G for j in range(Hl)} == set(
            range(first, first + count))
    with pytest.raises(ValueError, match="evenly"):
        fops.kv_heads_for(0, 2, 3)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-1.2b",
                                  "dbrx-132b"])
def test_meshed_step_equals_unmeshed_on_one_rank(arch):
    """A real one-rank gloo mesh: parameters placed by param_shardings
    under TRAIN_RULES, the batch by batch_shardings. The loss and every
    gradient equal the unmeshed step's to 1e-6 relative of the largest
    gradient, and so do the new weights after one AdamW step."""
    over = dict(n_layers=4 if arch == "zamba2-1.2b" else 2, vocab=128)
    if arch == "zamba2-1.2b":
        over.update(hybrid_attn_every=2, ssd_chunk=8)
    cfg = get_config(arch).reduced(**over)
    api = get_model(cfg, device="cpu")
    plain = api.init(torch.Generator().manual_seed(0), trainable=True)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 17))
    batch = {"tokens": torch.tensor(toks[:, :-1], dtype=torch.int32),
             "labels": torch.tensor(toks[:, 1:], dtype=torch.int32)}
    loss_fn = make_loss_fn(api)
    names, leaves = zip(*plain.named_parameters())
    loss0, _ = loss_fn(plain, batch)
    grads0 = torch.autograd.grad(loss0, leaves, allow_unused=True)
    opt = AdamW(lr=1e-3)
    step = make_train_step(api, opt)
    new0, _, m0 = step(plain, opt.init(plain), batch)
    with local_world("cpu"):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        with pol.sharding_policy(mesh, S.TRAIN_RULES):
            psh = S.param_shardings(mesh, api, S.TRAIN_RULES)
            tree = lm.nest({n: p.detach() for n, p in plain.named_parameters()})
            model = api.build(S.place_tree(tree, psh), trainable=True)
            bsh = S.batch_shardings(mesh, batch)
            mb = {k: S.place(v, bsh[k]) for k, v in batch.items()}
            loss1, _ = loss_fn(model, mb)
            grads1 = torch.autograd.grad(
                loss1.redistribute(placements=[Replicate()] * 2),
                list(model.parameters()), allow_unused=True)
            new1, state1, m1 = step(model, opt.init(model), mb)
        scale = max(float(g.abs().max()) for g in grads0 if g is not None)
        assert math.isclose(float(loss1.detach().full_tensor()),
                            float(loss0.detach()),
                            rel_tol=1e-6)
        for n, g0, g1 in zip(names, grads0, grads1):
            if g0 is None:
                assert g1 is None, n
                continue
            assert torch.allclose(g1.full_tensor(), g0, rtol=1e-5,
                                  atol=1e-6 * scale), n
        assert math.isclose(float(m1["loss"].full_tensor()),
                            float(m0["loss"]), rel_tol=1e-6)
        assert isinstance(state1.step, DTensor)
        for (n, p0), (_, p1) in zip(new0.named_parameters(),
                                    new1.named_parameters()):
            assert torch.allclose(p1.full_tensor(), p0, rtol=1e-6,
                                  atol=1e-7), n



@pytest.mark.parametrize("arch", ["yi-6b", "whisper-tiny"])
def test_meshed_serving_equals_unmeshed_on_one_rank(arch):
    """Prefill and two decode steps on a real one-rank gloo mesh
    (parameters by ``param_shardings`` under ``SERVE_RULES``; the prefill
    places its cache by ``cache_shardings``; decode attends through the
    mesh path of ``gqa_attend``) give the unmeshed logits."""
    cfg = get_config(arch).reduced(n_layers=2, vocab=128)
    api = get_model(cfg, device="cpu")
    plain = api.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (2, 8)),
                                    dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.tensor(rng.standard_normal(
            (2, 16, cfg.d_model)), dtype=torch.float32)

    def serve(model, place=lambda t: t):
        logits, cache = api.prefill(model, {k: place(v) for k, v in
                                            batch.items()}, 12)
        out = [logits]
        for pos in (8, 9):
            tok = place(torch.full((2, 1), pos % cfg.vocab, dtype=torch.int32))
            logits, cache = api.decode(model, cache, tok, pos)
            out.append(logits)
        return out

    want = serve(plain)
    with local_world("cpu"):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        with pol.sharding_policy(mesh, S.SERVE_RULES):
            psh = S.param_shardings(mesh, api, S.SERVE_RULES)
            tree = lm.nest({n: p.detach() for n, p in plain.named_parameters()})
            model = api.build(S.place_tree(tree, psh))

            def place(t):
                return S.place(t, S.batch_shardings(mesh, {"x": t})["x"])
            got = [g.full_tensor() for g in serve(model, place)]
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert torch.allclose(g, w, rtol=0, atol=1e-5 * scale)
