"""Training state on a mesh, in the port: a meshed state through the
checkpointer (gathered whole on save, placed on restore), the driver's
restart and elastic re-shard, and ``make_train_step(constrain_grads=...)``.

Real values need a real world: each test that checks them opens a one-rank
gloo world (``local_world("cpu")``), in which a DTensor's ``full_tensor()``
is the tensor itself. The gradients' placements under ``constrain_grads``
are read on meta tensors on a dry (2, 4) world, whose mesh dims of size
above 1 shard them (a one-rank mesh replicates every tensor). Every world is opened by a context manager that
destroys it."""
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import (dry_world, local_world, make_local_mesh,
                                     make_mesh)
from repro_torch.models import lm
from repro_torch.models.registry import ShapeSpec, get_config, get_model
from repro_torch.sharding.policy import sharding_policy
from repro_torch.train.checkpoint import Checkpointer, Placement
from repro_torch.train.driver import DriverConfig, TrainDriver
from repro_torch.train.optim import AdamW
from repro_torch.train.step import make_train_step

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mesh():
    """A (1, 1) ("data", "model") mesh over a one-rank gloo world."""
    with local_world(CPU):
        yield make_local_mesh(device_type=CPU)


def _api():
    return get_model(get_config("qwen1.5-0.5b").reduced(vocab=64, n_layers=2),
                     device=CPU)


def _pipe(api):
    return SyntheticLM(vocab=api.cfg.vocab, seq_len=32, global_batch=4)


def _meshed(api, mesh, seed=0):
    """``api``'s model from ``seed``, placed on ``mesh`` by
    ``param_shardings``."""
    plain = api.init(torch.Generator().manual_seed(seed), trainable=True)
    tree = lm.nest({n: p.detach() for n, p in plain.named_parameters()})
    return api.build(S.place_tree(tree, S.param_shardings(mesh, api)),
                     trainable=True)


def _leaves(state):
    """{name: tensor} of a {"params": model, "opt": AdamState} state, each
    DTensor gathered whole."""
    out = {f"params/{n}": p for n, p in state["params"].named_parameters()}
    opt = state["opt"]
    out["opt/step"] = opt.step
    out.update({f"opt/m/{n}": t for n, t in opt.m.items()})
    out.update({f"opt/v/{n}": t for n, t in opt.v.items()})
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach()
            for k, v in out.items()}


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert list(la) == list(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


def test_meshed_driver_checkpoints_and_restarts_bit_for_bit(mesh, tmp_path):
    """A driver over a meshed state checkpoints it (async, every 2 steps);
    a failure at step 3 restores step 2's checkpoint onto the mesh, and the
    replay gives the first pass's loss and a clean run's final state bit
    for bit."""
    api = _api()
    opt = AdamW(lr=1e-3)
    with sharding_policy(mesh, S.TRAIN_RULES):
        runs = {}
        for name, fail in (("clean", set()), ("failed", {3})):
            params = _meshed(api, mesh)
            drv = TrainDriver(api, opt, _pipe(api),
                              DriverConfig(steps=5, ckpt_every=2,
                                           ckpt_dir=str(tmp_path / name)),
                              failure_at=fail)
            p, o, step = drv.run(params, opt.init(params))
            assert step == 5
            runs[name] = (drv, {"params": p, "opt": o})
    drv, state = runs["failed"]
    assert (2, "restart-from-ckpt") in drv.events
    assert all(isinstance(t, DTensor) for t in state["params"].parameters())
    # steps 0, 1, 2, then (3 fails) 2 again from the checkpoint, 3, 4
    assert [m["step"] for m in drv.metrics] == [0, 1, 2, 2, 3, 4]
    clean_drv, clean = runs["clean"]
    losses = [m["loss"] for m in clean_drv.metrics]
    assert [m["loss"] for m in drv.metrics] == losses[:3] + losses[2:]
    _assert_bitwise(state, clean)
    # and a new driver restarts from the last checkpoint, on the mesh
    with sharding_policy(mesh, S.TRAIN_RULES):
        params = _meshed(api, mesh, seed=1)
        more = TrainDriver(api, opt, _pipe(api),
                           DriverConfig(steps=5, ckpt_every=2,
                                        ckpt_dir=str(tmp_path / "clean")))
        (p4, o4), step = more._restore(params, opt.init(params))
    assert step == 4 and isinstance(o4.step, DTensor)
    assert int(o4.step.full_tensor()) == 4


def test_save_async_of_a_meshed_state(mesh, tmp_path):
    api = _api()
    opt = AdamW(lr=1e-3)
    params = _meshed(api, mesh)
    state = {"params": params, "opt": opt.init(params)}
    ck = Checkpointer(tmp_path)
    ck.save_async(3, state)
    ck.wait()
    assert ck.latest_step() == 3 and ck.saves[-1]["bytes"] > 0
    plain = _api().init(torch.Generator().manual_seed(5), trainable=True)
    like = {"params": plain, "opt": opt.init(plain)}
    restored, step = ck.restore(like, device=CPU)
    assert step == 3
    assert not any(isinstance(t, DTensor)
                   for t in restored["params"].parameters())
    _assert_bitwise(restored, state)


def test_restore_places_each_leaf_on_the_given_shardings(mesh, tmp_path):
    """``restore(shardings=...)``: ``param_shardings`` and ``opt_shardings``
    trees, and hand-made placements (the moments sharded on dim 0 of the
    mesh's "data" dim); None leaves go to ``device``."""
    api = _api()
    opt = AdamW(lr=1e-3)
    plain = api.init(torch.Generator().manual_seed(0), trainable=True)
    state = {"params": plain, "opt": opt.init(plain)}
    ck = Checkpointer(tmp_path)
    ck.save(1, state)
    psh = S.param_shardings(mesh, api)
    osh = S.opt_shardings(mesh, psh)
    m_sh = {n: Placement(mesh, (Shard(0), Replicate())) for n in osh.m}
    osh = osh._replace(m=m_sh, v={n: None for n in osh.v})
    restored, _ = ck.restore(state, shardings={"params": psh, "opt": osh},
                             device=CPU)
    named = S.flatten(psh)
    for n, p in restored["params"].named_parameters():
        assert isinstance(p, DTensor) and p.requires_grad
        assert tuple(p.placements) == named[n].placements, n
    for n, t in restored["opt"].m.items():
        assert tuple(t.placements) == (Shard(0), Replicate()), n
    assert not any(isinstance(t, DTensor) for t in restored["opt"].v.values())
    assert tuple(restored["opt"].step.placements) == (Replicate(),) * 2
    _assert_bitwise(restored, state)


def test_elastic_reshard(mesh, tmp_path):
    """The mirror of tests/test_train_infra.py::test_elastic_reshard: a
    state trained off the mesh, re-sharded onto the (one-rank) mesh through
    the checkpointer's placement path, equal leaf for leaf."""
    api = _api()
    drv = TrainDriver(api, AdamW(lr=1e-3), _pipe(api),
                      DriverConfig(steps=2, ckpt_every=100,
                                   ckpt_dir=str(tmp_path)))
    params, opt_state, _ = drv.run()
    p_sh = S.param_shardings(mesh, api)
    o_sh = S.opt_shardings(mesh, p_sh)
    p2, o2 = drv.reshard_to(params, opt_state, p_sh, o_sh)
    assert all(isinstance(p, DTensor) for p in p2.parameters())
    _assert_bitwise({"params": params, "opt": opt_state},
                    {"params": p2, "opt": o2})


def _capture_step(api, opt, constrain):
    grads = {}

    def keep(g):
        grads.update(g)
        return g
    return make_train_step(api, opt, grad_transform=keep,
                           constrain_grads=constrain), grads


def test_constrain_grads_is_bitwise_on_one_rank(mesh):
    api = _api()
    opt = AdamW(lr=1e-3)
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, api.cfg.vocab, (2, 17)),
                        dtype=torch.int32)
    out = {}
    with sharding_policy(mesh, S.TRAIN_RULES):
        bsh = S.batch_shardings(mesh, {"tokens": toks[:, :-1]})["tokens"]
        batch = {"tokens": S.place(toks[:, :-1], bsh),
                 "labels": S.place(toks[:, 1:], bsh)}
        for constrain in (False, True):
            params = _meshed(api, mesh)
            step, grads = _capture_step(api, opt, constrain)
            new, _, m = step(params, opt.init(params), batch)
            out[constrain] = (float(m["loss"].full_tensor()), grads,
                              {n: p.full_tensor() for n, p in
                               new.named_parameters()})
    assert out[True][0] == out[False][0]
    for n, g in out[False][1].items():
        assert torch.equal(out[True][1][n].full_tensor(), g.full_tensor()), n
        assert torch.equal(out[True][2][n], out[False][2][n]), n


def test_constrain_grads_puts_gradients_in_the_parameters_placements():
    """On a dry (2, 4) mesh, on meta tensors: with ``constrain_grads`` each
    gradient has its parameter's placements; without, some do not (a
    replicated or partial gradient of an FSDP-sharded weight)."""
    cfg = get_config("qwen1.5-0.5b").reduced(d_model=64, vocab=256,
                                             n_layers=1, n_heads=4,
                                             n_kv_heads=4, head_dim=None)
    api = get_model(cfg, device=CPU)
    opt = AdamW(lr=1e-3)
    with dry_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), CPU)
        with sharding_policy(mesh, S.TRAIN_RULES):
            psh = S.param_shardings(mesh, api, S.TRAIN_RULES)
            want = {n: sh.placements for n, sh in S.flatten(psh).items()}
            specs = api.input_specs(ShapeSpec("t", 32, 4, "train"))
            bsh = S.batch_shardings(mesh, specs)
            batch = {k: S.place(v, bsh[k]) for k, v in specs.items()}
            got = {}
            for constrain in (False, True):
                model = api.build(S.place_tree(api.abstract_params(), psh),
                                  trainable=True)
                step, grads = _capture_step(api, opt, constrain)
                step(model, opt.init(model), batch)
                got[constrain] = {n: tuple(g.placements)
                                  for n, g in grads.items()}
    assert got[True] == want
    assert got[False] != want
