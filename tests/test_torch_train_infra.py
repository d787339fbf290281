"""The port's training substrate, mirroring tests/test_train_infra.py (and
test_archs.py's training checks) on the CPU: checkpoint round trip,
atomicity, retention, corruption and async save; the driver's
failure-restart (equal to a clean run), straggler replay and ``reshard_to``;
int8 and top-k error feedback (against the JAX functions too), EF training
that still converges, the wire ratio and the warmup-cosine values; the
structured stream is learnable; and a forward and one train step for every
registered arch, merged as cases of one parametrised test. The moe, vlm and
encdec parity checks are in test_torch_train_archs.py."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import t32
from _torch_train_cases import smoke_forward_and_train_step

from repro.train import compression as jcomp
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.registry import get_config, get_model, list_archs
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.compression import (
    EFState,
    compressed_bytes_ratio,
    dequantize_int8,
    ef_init,
    int8_roundtrip,
    make_dcn_compressor,
    quantize_int8,
    topk_ef_transform,
)
from repro_torch.train.driver import DriverConfig, InjectedFailure, TrainDriver
from repro_torch.train.optim import AdamState, AdamW, apply_updates, warmup_cosine
from repro_torch.train.step import make_loss_fn, make_train_step

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are tiny, so a step is many small ops, which torch's
    thread pool only slows, and badly when other test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny():
    cfg = get_config("qwen1.5-0.5b").reduced(vocab=64, n_layers=2)
    return get_model(cfg, device=CPU)


def _params(api, seed=0, trainable=True):
    return api.init(torch.Generator().manual_seed(seed), trainable=trainable)


def _assert_same_params(a, b):
    na, nb = dict(a.named_parameters()), dict(b.named_parameters())
    assert list(na) == list(nb)
    for k in na:
        assert na[k].dtype == nb[k].dtype
        assert na[k].requires_grad == nb[k].requires_grad
        assert torch.equal(na[k], nb[k]), k


class TestCheckpoint:
    def test_roundtrip_and_integrity(self, tmp_path):
        api = _tiny()
        params = _params(api)
        opt = AdamW().init(params)
        ck = Checkpointer(tmp_path, keep=2)
        ck.save(7, {"params": params, "opt": opt})
        like = {"params": _params(api, seed=1), "opt": AdamW().init(params)}
        restored, step = ck.restore(like, device=CPU)
        assert step == 7
        _assert_same_params(params, restored["params"])
        assert isinstance(restored["opt"], AdamState)
        assert restored["opt"].step.dtype == torch.int32
        for k in opt.m:
            assert torch.equal(opt.m[k], restored["opt"].m[k])
        manifest = (tmp_path / "ckpt_00000007" / "manifest.json").read_text()
        assert '"params/layers/1/attn/wq"' in manifest
        assert ck.saves[-1]["step"] == 7 and ck.saves[-1]["bytes"] > 0

    def test_bf16_serving_model_roundtrip(self, tmp_path):
        """numpy has no bfloat16: stored as float32, cast back."""
        cfg = get_config("zamba2-1.2b").reduced(dtype=torch.bfloat16)
        api = get_model(cfg, device=CPU)
        params = _params(api, trainable=False)
        ck = Checkpointer(tmp_path)
        ck.save(1, {"params": params})
        restored, _ = ck.restore({"params": params}, device=CPU)
        _assert_same_params(params, restored["params"])
        assert restored["params"].embed.dtype == torch.bfloat16

    def test_atomic_and_retention(self, tmp_path):
        params = _params(_tiny())
        ck = Checkpointer(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, {"params": params})
        ckpts = sorted(p.name for p in pathlib.Path(tmp_path).glob("ckpt_*"))
        assert ckpts == ["ckpt_00000003", "ckpt_00000004"]
        assert not list(pathlib.Path(tmp_path).glob("*.tmp"))

    def test_corruption_detected(self, tmp_path):
        params = _params(_tiny())
        ck = Checkpointer(tmp_path)
        ck.save(1, {"params": params})
        f = next(pathlib.Path(tmp_path).glob("ckpt_*/arrays.npz"))
        data = bytearray(f.read_bytes())
        data[len(data) // 2] ^= 0xFF
        f.write_bytes(bytes(data))
        with pytest.raises(Exception):
            ck.restore({"params": params}, device=CPU)

    def test_async_save(self, tmp_path):
        params = _params(_tiny())
        ck = Checkpointer(tmp_path)
        ck.save_async(5, {"params": params})
        ck.wait()
        assert ck.latest_step() == 5

    def test_restore_waits_for_an_async_save(self, tmp_path):
        params = _params(_tiny())
        ck = Checkpointer(tmp_path)
        ck.save_async(2, {"params": params})
        restored, step = ck.restore({"params": params}, device=CPU)
        assert step == 2
        _assert_same_params(params, restored["params"])

    def test_restore_defaults_to_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        params = _params(_tiny())
        ck = Checkpointer(tmp_path)
        ck.save(1, {"params": params})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ck.restore({"params": params})
        with pytest.raises(FileNotFoundError):
            Checkpointer(tmp_path / "empty").restore({"params": params},
                                                     device=CPU)


class TestDriver:
    def test_failure_restart_resumes_stream(self, tmp_path):
        api = _tiny()
        pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=32, global_batch=4)
        dcfg = DriverConfig(steps=25, ckpt_every=10,
                            ckpt_dir=str(tmp_path / "a"))
        drv = TrainDriver(api, AdamW(lr=1e-3), pipe, dcfg, failure_at={17})
        _, _, step = drv.run()
        assert step == 25
        kinds = [e for _, e in drv.events]
        assert any("failure" in k for k in kinds)
        assert (10, "restart-from-ckpt") in drv.events
        # deterministic: a clean run reaches the same loss trajectory
        dcfg2 = DriverConfig(steps=25, ckpt_every=10,
                             ckpt_dir=str(tmp_path / "b"))
        drv2 = TrainDriver(api, AdamW(lr=1e-3), pipe, dcfg2)
        drv2.run()
        final = {m["step"]: m["loss"] for m in drv.metrics}
        final2 = {m["step"]: m["loss"] for m in drv2.metrics}
        assert final[24] == pytest.approx(final2[24], rel=1e-4)
        # steps 10-16 ran twice; the replay gave the first run's losses
        # (to float32 noise: two multi-threaded CPU runs need not agree bit
        # for bit)
        replay = [m["loss"] for m in drv.metrics if 10 <= m["step"] < 17]
        np.testing.assert_allclose(replay[7:], replay[:7], rtol=1e-5)

    def test_restart_resumes_from_latest_checkpoint(self, tmp_path):
        api = _tiny()
        pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=32, global_batch=4)
        dcfg = DriverConfig(steps=4, ckpt_every=2, ckpt_dir=str(tmp_path))
        TrainDriver(api, AdamW(lr=1e-3), pipe, dcfg).run()
        more = TrainDriver(api, AdamW(lr=1e-3), pipe,
                           DriverConfig(steps=6, ckpt_every=2,
                                        ckpt_dir=str(tmp_path)))
        _, opt_state, step = more.run()
        assert step == 6 and more.events[0] == (4, "restored")
        assert [m["step"] for m in more.metrics] == [4, 5]
        assert int(opt_state.step) == 6

    def test_failure_just_after_a_checkpoint_restores_it(self, tmp_path):
        api = _tiny()
        pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=32, global_batch=4)
        dcfg = DriverConfig(steps=5, ckpt_every=3, ckpt_dir=str(tmp_path))
        drv = TrainDriver(api, AdamW(lr=1e-3), pipe, dcfg, failure_at={3})
        _, _, step = drv.run()
        assert step == 5
        assert drv.events == [(3, "failure: injected failure at step 3"),
                              (3, "restart-from-ckpt")]

    def test_too_many_failures_raise(self, tmp_path):
        api = _tiny()
        pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=32, global_batch=4)
        dcfg = DriverConfig(steps=4, ckpt_every=2, ckpt_dir=str(tmp_path),
                            max_retries=0)
        with pytest.raises(InjectedFailure):
            TrainDriver(api, AdamW(lr=1e-3), pipe, dcfg,
                        failure_at={3}).run()

    def test_straggler_replay(self, tmp_path):
        api = _tiny()
        pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=32, global_batch=4)
        dcfg = DriverConfig(steps=6, ckpt_every=100, ckpt_dir=str(tmp_path),
                            deadline_s=0.2)
        drv = TrainDriver(api, AdamW(lr=1e-3), pipe, dcfg,
                          straggle_at={3: 0.5})
        _, _, step = drv.run()
        assert step == 6
        assert any("straggler" in e for _, e in drv.events)
        # the replay ran from the same state: a clean run has its losses
        clean = TrainDriver(api, AdamW(lr=1e-3), pipe,
                            DriverConfig(steps=6, ckpt_every=100,
                                         ckpt_dir=str(tmp_path / "clean")))
        clean.run()
        np.testing.assert_allclose([m["loss"] for m in drv.metrics],
                                   [m["loss"] for m in clean.metrics],
                                   rtol=1e-5)

    def test_reshard_to_cpu(self, tmp_path):
        api = _tiny()
        pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=32, global_batch=4)
        dcfg = DriverConfig(steps=2, ckpt_every=100, ckpt_dir=str(tmp_path))
        drv = TrainDriver(api, AdamW(lr=1e-3), pipe, dcfg)
        params, opt_state, _ = drv.run()
        p2, o2 = drv.reshard_to(params, opt_state, CPU)
        _assert_same_params(params, p2)
        assert int(o2.step) == 2
        for k in opt_state.v:
            assert torch.equal(opt_state.v[k], o2.v[k])

    def test_extra_batch_reaches_the_model(self, tmp_path):
        cfg = get_config("internvl2-1b").reduced()
        api = get_model(cfg, device=CPU)
        pipe = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=2)
        vis = np.random.default_rng(0).standard_normal(
            (2, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
        dcfg = DriverConfig(steps=2, ckpt_every=100, ckpt_dir=str(tmp_path))
        drv = TrainDriver(api, AdamW(lr=1e-3), pipe, dcfg,
                          extra_batch=lambda step: {"vis_embeds": vis})
        _, _, step = drv.run()
        assert step == 2 and all(np.isfinite(m["loss"]) for m in drv.metrics)


class TestCompression:
    def test_int8_roundtrip_error_bounded(self):
        x = t32(np.random.default_rng(0).standard_normal(1000))
        q, s = quantize_int8(x)
        err = (dequantize_int8(q, s) - x).abs().max()
        assert float(err) <= float(s) * 0.5 + 1e-6
        assert q.dtype == torch.int8

    def test_int8_and_topk_match_jax(self):
        rng = np.random.default_rng(1)
        g = {"a": rng.standard_normal((6, 7)).astype(np.float32),
             "b": rng.standard_normal(50).astype(np.float32)}
        e = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
             for k, v in g.items()}
        jq, js = jcomp.quantize_int8(jnp.asarray(g["a"]))
        tq, ts = quantize_int8(t32(g["a"]))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
        jk, jst = jcomp.topk_ef_transform(
            {k: jnp.asarray(v) for k, v in g.items()},
            jcomp.EFState(error={k: jnp.asarray(v) for k, v in e.items()}),
            fraction=0.2)
        tk, tst = topk_ef_transform(
            {k: t32(v) for k, v in g.items()},
            EFState(error={k: t32(v) for k, v in e.items()}),
            fraction=0.2)
        for k in g:
            np.testing.assert_array_equal(tk[k].numpy(), np.asarray(jk[k]))
            np.testing.assert_array_equal(tst.error[k].numpy(),
                                          np.asarray(jst.error[k]))
        jr = jcomp.int8_roundtrip({k: jnp.asarray(v) for k, v in g.items()})
        tr = int8_roundtrip({k: t32(v) for k, v in g.items()})
        for k in g:
            np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]),
                                       rtol=1e-6, atol=1e-7)

    def test_topk_ef_conserves_mass(self):
        g = {"a": torch.arange(-8.0, 8.0), "b": torch.ones((4, 4))}
        st = ef_init(g)
        kept, st2 = topk_ef_transform(g, st, fraction=0.25)
        # kept + error == original (+ previous error 0)
        for k in g:
            np.testing.assert_allclose((kept[k] + st2.error[k]).numpy(),
                                       g[k].numpy(), rtol=1e-6)

    def test_ef_training_still_converges(self):
        api = _tiny()
        pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=32, global_batch=8)
        opt = AdamW(lr=3e-3)
        params = _params(api)
        opt_state = opt.init(params)
        init_ef, transform = make_dcn_compressor(fraction=0.1)
        ef = init_ef(params)
        loss_fn = make_loss_fn(api)
        losses = []
        for b in pipe.batches(150):
            batch = {k: torch.as_tensor(v, dtype=torch.long)
                     for k, v in b.items()}
            loss, metrics = loss_fn(params, batch)
            names, leaves = zip(*params.named_parameters())
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
            kept, ef = transform(grads, ef)
            with torch.no_grad():
                updates, opt_state, _ = opt.update(kept, opt_state, params)
                params = apply_updates(params, updates)
            losses.append(float(metrics["loss"].detach()))
        assert losses[-1] < 0.9 * np.log(api.cfg.vocab)

    def test_wire_ratio(self):
        assert compressed_bytes_ratio(0.01) < 0.05  # >20x reduction
        assert compressed_bytes_ratio(0.01) == \
            jcomp.compressed_bytes_ratio(0.01)


class TestServeEngine:
    def test_batched_greedy_decode(self):
        api = _tiny()
        eng = ServeEngine(api, max_len=64, batch_slots=2)
        eng.load(_params(api, trainable=False))
        rng = np.random.default_rng(0)
        reqs = [Request(prompt=rng.integers(0, api.cfg.vocab, 8,
                                            dtype=np.int32),
                        max_new_tokens=5) for _ in range(5)]
        eng.run(reqs)
        assert all(r.done for r in reqs)
        assert all(len(r.out) == 5 for r in reqs)

    def test_trained_model_serves(self):
        """A trainable model goes into the engine as it is, and the same
        request gives the same tokens twice."""
        api = _tiny()
        opt = AdamW(lr=1e-3)
        params = _params(api, seed=1)
        pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=32, global_batch=4)
        batch = {k: torch.as_tensor(v, dtype=torch.long)
                 for k, v in pipe.batch(0).items()}
        params, _, _ = make_train_step(api, opt)(params, opt.init(params),
                                                 batch)
        eng = ServeEngine(api, max_len=64, batch_slots=1)
        eng.load(params)
        prompt = np.arange(8, dtype=np.int32)
        r, r2 = Request(prompt=prompt, max_new_tokens=4), \
            Request(prompt=prompt, max_new_tokens=4)
        eng.run([r])
        eng.run([r2])
        assert r.out == r2.out and len(r.out) == 4


def test_schedule_warmup_cosine():
    lr = warmup_cosine(1.0, warmup=10, total=110, floor=0.1)
    assert float(lr(torch.tensor(0))) == 0.0
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0)
    assert float(lr(torch.tensor(110))) == pytest.approx(0.1)


def test_structured_pipeline_is_learnable():
    """120 steps on the structured stream clearly cut the loss below the
    uniform baseline ln(V) (tests/test_archs.py's check)."""
    cfg = get_config("qwen1.5-0.5b").reduced(vocab=64, n_layers=2)
    api = get_model(cfg, device=CPU)
    params = _params(api)
    opt = AdamW(lr=3e-3)
    opt_state = opt.init(params)
    step = make_train_step(api, opt)
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0)
    losses = []
    for b in pipe.batches(120):
        batch = {k: torch.as_tensor(v, dtype=torch.long)
                 for k, v in b.items()}
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.8 * np.log(cfg.vocab), (losses[0], losses[-1])


def test_train_step_needs_a_trainable_model():
    api = _tiny()
    opt = AdamW()
    params = _params(api, trainable=False)
    batch = {"tokens": torch.zeros(1, 8, dtype=torch.long),
             "labels": torch.zeros(1, 8, dtype=torch.long)}
    with pytest.raises(ValueError, match="trainable"):
        make_train_step(api, opt)(params, opt.init(params), batch)


@pytest.mark.parametrize("name", sorted(list_archs()))
def test_forward_and_train_step_every_arch(name):
    smoke_forward_and_train_step(name)
