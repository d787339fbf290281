"""What each rank of a real world runs in ``tests/test_torch_world.py``.

``spawn_world`` starts every rank in a process of its own and imports the
rank's function there by name, so the functions live in this module, which
imports the port and nothing of JAX (each rank starts in a second or two).
Every function takes the rank first and returns numpy arrays and Python
values; the test holds them to the JAX package in its own process.

A rank runs a list of jobs and returns one result per job: a job that
raises gives its traceback as a string in place of a result, so that one
fault fails its own test and the others still run in the same world.
"""
from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_config, get_model
from repro_torch.sharding.policy import sharding_policy
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.driver import DriverConfig, TrainDriver
from repro_torch.train.optim import AdamW
from repro_torch.train.step import make_loss_fn

CPU = "cpu"
AXES = ("data", "model")


def run_jobs(rank: int, jobs: list) -> list:
    """``[JOBS[kind](rank, **job) for each (kind, job)]``, a job's traceback
    (a string) in place of its result when it raises."""
    out = []
    for kind, job in jobs:
        try:
            out.append(JOBS[kind](rank, **job))
        except Exception:           # noqa: BLE001 - the test reports it
            out.append(traceback.format_exc())
    return out


def _full(t) -> np.ndarray:
    """A tensor whole, as numpy (a DTensor gathered: a collective)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy().copy()


def _placed(mesh, api, tree: dict, rules, trainable: bool):
    """The port's model of a JAX tree, placed on ``mesh`` by
    ``param_shardings`` under ``rules``."""
    plain = params_from_jax(api.cfg, tree, device=CPU, trainable=trainable)
    named = lm.nest({n: p.detach() for n, p in plain.named_parameters()})
    return api.build(S.place_tree(named, S.param_shardings(mesh, api, rules)),
                     trainable=trainable)


def _place_batch(mesh, batch: dict) -> dict:
    bsh = S.batch_shardings(mesh, batch)
    return {k: S.place(v, bsh[k]) for k, v in batch.items()}


def _tensors(batch: dict) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.long if v.dtype == np.int32
                               else torch.float32) for k, v in batch.items()}


def train_grads(rank: int, arch: str, over: dict, tree: dict, batch: dict,
                mesh: tuple) -> dict:
    """Loss, metrics and every gradient (whole) of one step of the model of
    ``tree`` on a ``mesh``-shaped ("data", "model") mesh under
    ``TRAIN_RULES``, its batch split by ``batch_shardings``."""
    cfg = get_config(arch).reduced(**over)
    api = get_model(cfg, device=CPU)
    m = make_mesh(mesh, AXES, CPU)
    with sharding_policy(m, S.TRAIN_RULES):
        model = _placed(m, api, tree, S.TRAIN_RULES, trainable=True)
        loss, met = make_loss_fn(api)(model, _place_batch(m, _tensors(batch)))
        names, leaves = zip(*model.named_parameters())
        grads = torch.autograd.grad(
            loss.redistribute(placements=[Replicate()] * 2), leaves)
        grads = {n: _full(g) for n, g in zip(names, grads)}
        met = {k: float(_full(v)) for k, v in met.items()}
    return {"loss": float(_full(loss)), "metrics": met, "grads": grads}


def serve_logits(rank: int, arch: str, over: dict, tree: dict, batch: dict,
                 mesh: tuple, max_len: int, steps: list) -> list:
    """The logits (whole) of a prefill of ``batch`` and one decode step per
    ``(token, position)`` of ``steps`` (the same token for every row), on a
    ``mesh``-shaped mesh under ``SERVE_RULES``, the cache placed by
    ``cache_shardings``."""
    cfg = get_config(arch).reduced(**over)
    api = get_model(cfg, device=CPU)
    m = make_mesh(mesh, AXES, CPU)
    with sharding_policy(m, S.SERVE_RULES):
        model = _placed(m, api, tree, S.SERVE_RULES, trainable=False)
        b = _place_batch(m, _tensors(batch))
        logits, cache = api.prefill(model, b, max_len)
        out = [_full(logits)]
        rows = batch["tokens"].shape[0]
        for tok, pos in steps:
            t = _place_batch(m, {"t": torch.full((rows, 1), tok,
                                                 dtype=torch.long)})["t"]
            logits, cache = api.decode(model, cache, t, pos)
            out.append(_full(logits))
    return out


# ---- checkpoints and the driver -------------------------------------------
def _driver_api():
    return get_model(get_config("qwen1.5-0.5b").reduced(vocab=64, n_layers=2),
                     device=CPU)


def _pipe(api):
    return SyntheticLM(vocab=api.cfg.vocab, seq_len=32, global_batch=4)


def _meshed_model(api, mesh, seed: int = 0):
    plain = api.init(torch.Generator().manual_seed(seed), trainable=True)
    tree = lm.nest({n: p.detach() for n, p in plain.named_parameters()})
    return api.build(S.place_tree(tree, S.param_shardings(mesh, api)),
                     trainable=True)


def _state_leaves(params, opt_state) -> dict:
    """{name: numpy} of a state, every DTensor gathered whole."""
    out = {f"params/{n}": p for n, p in params.named_parameters()}
    out["opt/step"] = opt_state.step
    out.update({f"opt/m/{n}": t for n, t in opt_state.m.items()})
    out.update({f"opt/v/{n}": t for n, t in opt_state.v.items()})
    return {k: _full(v) for k, v in out.items()}


def checkpoint_roundtrip(rank: int, directory: str, mesh: tuple) -> dict:
    """A meshed state saved (blocking, then async) and restored onto the
    mesh's shardings. Returns what the directory held after each save, the
    saves this rank wrote, and whether every restored leaf equals the saved
    one bit for bit (rank 0 also returns the leaves)."""
    api = _driver_api()
    opt = AdamW(lr=1e-3)
    m = make_mesh(mesh, AXES, CPU)
    with sharding_policy(m, S.TRAIN_RULES):
        params = _meshed_model(api, m)
        state = opt.init(params)
        ck = Checkpointer(directory, keep=2)
        ck.save(1, {"params": params, "opt": state})
        after_save = sorted(p.name for p in ck.dir.iterdir())
        for step in (2, 3):
            ck.save_async(step, {"params": params, "opt": state})
        ck.wait()
        after_async = sorted(p.name for p in ck.dir.iterdir())
        psh = S.param_shardings(m, api)
        like = {"params": params, "opt": state}
        restored, step = ck.restore(
            like, shardings={"params": psh, "opt": S.opt_shardings(m, psh)},
            device=CPU)
        on_mesh = all(isinstance(p, DTensor) and p.device_mesh == m
                      for p in restored["params"].parameters())
        want = _state_leaves(params, state)
        got = _state_leaves(restored["params"], restored["opt"])
    same = list(want) == list(got) and all(
        np.array_equal(want[k], got[k]) and want[k].dtype == got[k].dtype
        for k in want)
    return {"after_save": after_save, "after_async": after_async,
            "writes": [s["step"] for s in ck.saves], "step": step,
            "on_mesh": on_mesh, "bitwise": same,
            "leaves": want if rank == 0 else None}


def driver_runs(rank: int, directory: str, mesh: tuple, straggler_rank: int,
                deadline_s: float, straggle_s: float) -> dict:
    """``TrainDriver`` on a meshed state, twice from the same weights: a
    clean run, and a run in which one rank sleeps past the deadline before
    step 1 and every rank fails at step 3. Returns each run's steps, losses,
    events and checkpoint writes, and the final states (rank 0, whole). The
    faulty run's final state is then saved by this world under
    ``directory``/elastic, for :func:`reshard_from` in a world of another
    size. The clean run goes first, so that DTensor's propagation cache is
    warm when the faulty run reads its deadline."""
    api = _driver_api()
    opt = AdamW(lr=1e-3)
    m = make_mesh(mesh, AXES, CPU)
    out = {}
    runs = (("clean", set(), {}, 1e9),
            ("faulty", {3}, {1: straggle_s} if rank == straggler_rank else {},
             deadline_s))
    with sharding_policy(m, S.TRAIN_RULES):
        for name, fail, straggle, deadline in runs:
            params = _meshed_model(api, m)
            drv = TrainDriver(api, opt, _pipe(api), DriverConfig(
                steps=4, ckpt_every=2, ckpt_dir=f"{directory}/{name}",
                deadline_s=deadline), failure_at=fail, straggle_at=straggle)
            p, o, step = drv.run(params, opt.init(params))
            leaves = _state_leaves(p, o)        # a collective: every rank
            out[name] = {
                "step": step, "events": drv.events,
                "steps": [r["step"] for r in drv.metrics],
                "losses": [r["loss"] for r in drv.metrics],
                "writes": [s["step"] for s in drv.ckpt.saves],
                "state": leaves if rank == 0 else None}
        Checkpointer(f"{directory}/elastic").save(step, {"params": p,
                                                         "opt": o})
    return out


def reshard_from(rank: int, directory: str, mesh: tuple,
                 writer_done: str) -> dict:
    """The elastic re-scale's second half, in a world of another size than
    the writer's: the checkpoint under ``directory`` (awaited while the
    writer's world runs, until the file ``writer_done`` exists) restored
    onto this
    world's ``param_shardings`` and ``opt_shardings`` through the driver,
    its ``like`` a meta model (nothing is drawn). Returns the rank, the
    world's size, the step, whether every parameter got its placements,
    and (rank 0) the leaves whole."""
    api = _driver_api()
    opt = AdamW(lr=1e-3)
    m = make_mesh(mesh, AXES, CPU)
    drv = TrainDriver(api, opt, _pipe(api),
                      DriverConfig(steps=0, ckpt_dir=directory))
    while drv.ckpt.latest_step() is None:
        if os.path.exists(writer_done) and drv.ckpt.latest_step() is None:
            raise FileNotFoundError(f"the writer's world ended without a "
                                    f"checkpoint under {directory}")
        time.sleep(0.2)
    with sharding_policy(m, S.TRAIN_RULES):
        psh = S.param_shardings(m, api)
        like = api.build(api.abstract_params(), trainable=True)
        params, state, step = drv.restore_onto(
            like, opt.init(like), psh, S.opt_shardings(m, psh))
        placed = {n: tuple(p.placements) for n, p in params.named_parameters()}
        want = {n: sh.placements for n, sh in S.flatten(psh).items()}
        leaves = _state_leaves(params, state)
    return {"rank": rank, "world": dist.get_world_size(), "step": step,
            "placed": placed == want, "leaves": leaves if rank == 0 else None}


JOBS = {"train": train_grads, "serve": serve_logits,
        "checkpoint": checkpoint_roundtrip, "driver": driver_runs,
        "reshard": reshard_from}


# ---- spawn_world's own failure paths ---------------------------------------
def raise_on_rank_1(rank: int) -> None:
    """Rank 1 raises; rank 0 waits in a barrier that rank 1 never joins."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def stall_on_rank_1(rank: int) -> None:
    """Rank 0 waits in a barrier; rank 1 never reaches it."""
    if rank == 1:
        import time
        time.sleep(3600)
    dist.barrier()
