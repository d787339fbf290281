"""The port on real worlds of several ranks: ``spawn_world`` runs 4 (and 2)
``gloo`` ranks on this CPU, one process and one torch thread each, and the
meshed paths that a dry world (``"fake"`` collectives, meta tensors) or a
one-rank world cannot check run there with real values, split for real.

* Training: qwen1.5-0.5b and zamba2 (4 layers, ``hybrid_attn_every`` 2,
  ``ssd_chunk`` 8) on (2, 2) and (1, 4) ("data", "model") meshes under
  ``TRAIN_RULES``, weights from ``params_from_jax``, held to the JAX
  package's unmeshed step: the loss to 1e-5 relative, every gradient leaf
  to 1e-4·max|g_leaf| (``_torch_train_cases``). dbrx on (2, 2) is held to
  the JAX step on a (2, 2) mesh of four forced CPU devices (a subprocess,
  as ``tests/test_distribution.py`` forces them), so that both sides route
  G = 2 token groups.
* Serving: yi-6b and whisper-tiny prefill and two decode steps on (2, 2)
  and (1, 4) under ``SERVE_RULES`` within 1e-5·max|logits| of JAX.
* Checkpoints and the driver on 4 ranks: a checkpoint is written once (by
  rank 0) and restores bit for bit; a driver run with a straggler on one
  rank and a failure on every rank replays the clean run's losses and
  final state bit for bit; a state saved by the 4-rank world restores onto
  a 2-rank world's shardings (the elastic re-scale).
* ``spawn_world`` itself: every rank's result, a rank that raises, a
  collective that stalls past the timeout, and no card.

Every world runs in ``spawn_world``, which always destroys its process
groups and kills its ranks at its deadline, so nothing here can leave a
process group open or hang the suite. The 4-rank world runs every job
once, on a background thread, while the JAX references are computed in
this process."""
import concurrent.futures
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_world_ranks as R
from _torch_train_cases import _PERTURB, LOSS_RTOL, assert_grads_close
from repro.models import lm as jax_lm
from repro.models import whisper as jax_whisper
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.train import step as jstep
from repro_torch.launch.mesh import spawn_world
from repro_torch.models.registry import get_config

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
RANKS = 4
MESHES = ((2, 2), (1, 4))
WORLD_TIMEOUT_S = 300.0
LOGITS_RTOL = 1e-5          # of max|logits|
TRAIN = {"qwen": ("qwen1.5-0.5b", dict(n_layers=2, vocab=128)),
         "zamba2": ("zamba2-1.2b", dict(n_layers=4, hybrid_attn_every=2,
                                        ssd_chunk=8, vocab=128)),
         "dbrx": ("dbrx-132b", dict(n_layers=2, vocab=128))}
SERVE = {"yi": ("yi-6b", dict(n_layers=2, vocab=128)),
         "whisper": ("whisper-tiny", dict(n_layers=2, vocab=128))}
B, S = 4, 32                # train batch: 2 rows a data rank on (2, 2)
PROMPT, MAX_LEN, N_FRAMES = 8, 12, 16
DECODE = [(8, PROMPT), (9, PROMPT + 1)]   # (token, position)
# the driver's straggler: a sleep well past the deadline, which is well past
# a warm 4-rank step of the 2-layer model (~0.3 s here)
DEADLINE_S, STRAGGLE_S = 2.0, 3.0


def _jax_cfg(name, over):
    return dataclasses.replace(jax_config(name).reduced(**over), remat=False)


def _jax_tree(name, over, seed=0) -> dict:
    """Weights in the JAX package's layout, drawn with numpy from its
    parameter specs as its init draws them (normal·scale, "small" scaled by
    1/√(last dim), zeros, ones; no JAX compile), the zero/one leaves
    perturbed as the training parity tests perturb them."""
    cfg = _jax_cfg(name, over)
    specs = (jax_whisper if cfg.family == "encdec" else jax_lm).model_specs(
        cfg)
    rng = np.random.default_rng(seed)

    def draw(path, spec):
        if spec.init in ("zeros", "ones"):
            a = np.full(spec.shape, spec.init == "ones", np.float32)
        else:
            a = (rng.standard_normal(spec.shape) * spec.scale).astype(
                np.float32)
            if spec.init == "small":
                a /= np.float32(np.sqrt(max(spec.shape[-1], 1)))
        if getattr(path[-1], "key", None) in _PERTURB:
            a = a + rng.normal(0, 0.3, a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(draw, specs)


def _train_batch() -> dict:
    toks = np.random.default_rng(0).integers(0, 128, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _serve_batch(name) -> dict:
    rng = np.random.default_rng(1)
    b = {"tokens": rng.integers(0, 128, (B, PROMPT)).astype(np.int32)}
    if name == "whisper-tiny":
        b["frames"] = rng.standard_normal((B, N_FRAMES, 64)).astype(
            np.float32)
    return b


_DBRX_JAX = textwrap.dedent("""\
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, jax, numpy as np
    from repro.launch.mesh import make_local_mesh
    from repro.launch.shardings import (TRAIN_RULES, batch_shardings,
                                        param_shardings)
    from repro.models.registry import get_config, get_model
    from repro.sharding.policy import sharding_policy
    from repro.train.step import make_loss_fn

    src, dst = sys.argv[1], sys.argv[2]
    cfg = dataclasses.replace(get_config("dbrx-132b").reduced(**{over!r}),
                              remat=False)
    api = get_model(cfg)
    z = np.load(src)
    treedef = jax.tree_util.tree_structure(api.abstract_params())
    params = jax.tree_util.tree_unflatten(
        treedef, [z[f"p{{i}}"] for i in range(treedef.num_leaves)])
    batch = {{"tokens": z["tokens"], "labels": z["labels"]}}
    mesh = make_local_mesh(2)
    assert mesh.shape == {{"data": 2, "model": 2}}, mesh.shape
    with sharding_policy(mesh, TRAIN_RULES):
        fn = jax.jit(jax.value_and_grad(make_loss_fn(api), has_aux=True),
                     in_shardings=(param_shardings(mesh, api, TRAIN_RULES),
                                   batch_shardings(mesh, batch)))
        (loss, met), grads = fn(params, batch)
    np.savez(dst, loss=np.asarray(loss),
             **{{f"m_{{k}}": np.asarray(v) for k, v in met.items()}},
             **{{f"g{{i}}": np.asarray(g) for i, g in
                enumerate(jax.tree_util.tree_leaves(grads))}})
""")


def _start_dbrx_jax(tree, batch, tmp) -> subprocess.Popen:
    """The JAX step of dbrx on a (2, 2) mesh of four forced CPU devices, in
    a subprocess (the device count is fixed before JAX starts)."""
    leaves = jax.tree_util.tree_leaves(tree)
    np.savez(tmp / "dbrx_in.npz", **batch,
             **{f"p{i}": np.asarray(a) for i, a in enumerate(leaves)})
    code = _DBRX_JAX.format(over=TRAIN["dbrx"][1])
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    with open(tmp / "dbrx_err.txt", "w") as err:
        return subprocess.Popen(
            [sys.executable, "-c", code, str(tmp / "dbrx_in.npz"),
             str(tmp / "dbrx_out.npz")], env=env,
            stdout=subprocess.DEVNULL, stderr=err)


@dataclasses.dataclass
class World:
    """The jobs the 4-rank world runs, its results and the 2-rank world's
    (futures: the worlds run on background threads), and the JAX step of
    dbrx (a subprocess)."""
    jobs: dict
    trees: dict
    results: concurrent.futures.Future
    resharded: concurrent.futures.Future
    dbrx: subprocess.Popen
    tmp: pathlib.Path

    def result(self, key):
        res = self.results.result()[0]
        out = res[list(self.jobs).index(key)]
        assert not isinstance(out, str), f"{key} failed on rank 0:\n{out}"
        return out

    def every_rank(self, key):
        i = list(self.jobs).index(key)
        return [r[i] for r in self.results.result()]


def _world(n_ranks: int, jobs: list, done: pathlib.Path | None = None):
    """``spawn_world`` over ``jobs``; ``done`` is created when it ends."""
    try:
        return spawn_world(n_ranks, R.run_jobs, jobs, device_type="cpu",
                           timeout_s=WORLD_TIMEOUT_S)
    finally:
        if done is not None:
            done.touch()


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Starts both worlds and the dbrx subprocess when the module's first
    test starts, so that they run while the tests before the first that
    reads them (``spawn_world``'s own, the JAX references) run here."""
    tmp = tmp_path_factory.mktemp("world")
    trees = {k: _jax_tree(*v) for k, v in {**TRAIN, **SERVE}.items()}
    jobs = {}
    for key, (name, over) in TRAIN.items():
        for mesh in MESHES if key != "dbrx" else ((2, 2),):
            jobs[("train", key, mesh)] = ("train", dict(
                arch=name, over=over, tree=trees[key], batch=_train_batch(),
                mesh=mesh))
    for key, (name, over) in SERVE.items():
        for mesh in MESHES:
            jobs[("serve", key, mesh)] = ("serve", dict(
                arch=name, over=over, tree=trees[key],
                batch=_serve_batch(name), mesh=mesh, max_len=MAX_LEN,
                steps=DECODE))
    jobs["checkpoint"] = ("checkpoint", dict(directory=str(tmp / "ck"),
                                             mesh=(2, 2)))
    jobs["driver"] = ("driver", dict(
        directory=str(tmp / "drv"), mesh=(2, 2), straggler_rank=1,
        deadline_s=DEADLINE_S, straggle_s=STRAGGLE_S))
    dbrx = _start_dbrx_jax(trees["dbrx"], _train_batch(), tmp)
    # the 2-rank world starts with the 4-rank one and waits for the state
    # that the 4 save at the end of their driver job
    pool = concurrent.futures.ThreadPoolExecutor(2)
    four = pool.submit(_world, RANKS, list(jobs.values()), tmp / "four_done")
    two = pool.submit(_world, 2, [("reshard", dict(
        directory=str(tmp / "drv" / "elastic"), mesh=(1, 2),
        writer_done=str(tmp / "four_done")))])
    w = World(jobs, trees, four, two, dbrx, tmp)
    try:
        yield w
    finally:
        pool.shutdown(wait=True)
        if dbrx.poll() is None:
            dbrx.kill()
        dbrx.wait()


@pytest.fixture(scope="module")
def jax_refs(world):
    """The JAX package's unmeshed results, all computed here while the
    worlds run: {key: (loss, metrics, grads)} of the training cases and
    {key: [prefill logits, decode logits...]} of the serving ones."""
    refs = {}
    for key in ("qwen", "zamba2"):
        name, over = TRAIN[key]
        japi = jax_model(_jax_cfg(name, over))
        batch = {k: jnp.asarray(v) for k, v in _train_batch().items()}
        (loss, met), grads = jax.jit(jax.value_and_grad(
            jstep.make_loss_fn(japi), has_aux=True))(
                jax.tree_util.tree_map(jnp.asarray, world.trees[key]), batch)
        refs[key] = (loss, met, grads)
    for key, (name, over) in SERVE.items():
        japi = jax_model(_jax_cfg(name, over))
        params = jax.tree_util.tree_map(jnp.asarray, world.trees[key])
        batch = {k: jnp.asarray(v) for k, v in _serve_batch(name).items()}
        logits, cache = japi.prefill(params, batch, MAX_LEN)
        out = [np.asarray(logits)]
        decode = jax.jit(japi.decode)
        for tok, pos in DECODE:
            logits, cache = decode(params, cache,
                                   jnp.full((B, 1), tok, jnp.int32), pos)
            out.append(np.asarray(logits))
        refs[key] = out
    return refs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- spawn_world itself ---------------------------------------------------
def test_spawn_world_raises_a_ranks_exception_with_its_traceback():
    """Rank 1 raises while rank 0 waits in a barrier: the call raises at
    once with rank 1's traceback, and rank 0 is killed."""
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 2 raised.*"
                                           r"ValueError: rank 1 fails"):
        spawn_world(2, R.raise_on_rank_1, device_type="cpu", timeout_s=120)


def test_spawn_world_raises_at_its_deadline():
    """Rank 0 waits in a barrier that rank 1 never reaches: the call
    raises at its deadline and kills both ranks."""
    with pytest.raises(TimeoutError, match="did not finish within"):
        spawn_world(2, R.stall_on_rank_1, device_type="cpu", timeout_s=10)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_spawn_world_needs_a_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn_world(2, R.raise_on_rank_1)


# ---- the 4-rank world ------------------------------------------------------
def _check_step(key, got, jloss, jmet, jgrads):
    name, over = TRAIN[key]
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=LOSS_RTOL)
    assert set(got["metrics"]) == set(jmet)
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, float(jmet[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    assert_grads_close(types.SimpleNamespace(
                           tcfg=get_config(name).reduced(**over)), jgrads,
                       {n: torch.from_numpy(g)
                        for n, g in got["grads"].items()})


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("key", ["qwen", "zamba2"])
def test_train_step_matches_jax(world, jax_refs, key, mesh):
    """Loss and gradients of one step on 4 real ranks against the JAX
    package's unmeshed step. On (2, 2) this is where the vocab-sharded
    embedding met its batch rows gathered (C.6); wherever the batch is
    split, zamba2's ``A_log`` gradient was one rank's share (C.9)."""
    _check_step(key, world.result(("train", key, mesh)), *jax_refs[key])


def test_dbrx_train_step_matches_jax_on_a_2x2_mesh(world):
    """dbrx on (2, 2) against the JAX step on a (2, 2) mesh: both split the
    tokens into G = 2 groups, each with its own expert capacity."""
    world.dbrx.wait(timeout=WORLD_TIMEOUT_S)
    assert world.dbrx.returncode == 0, (
        world.tmp / "dbrx_err.txt").read_text()[-3000:]
    z = np.load(world.tmp / "dbrx_out.npz")
    treedef = jax.tree_util.tree_structure(world.trees["dbrx"])
    jgrads = jax.tree_util.tree_unflatten(
        treedef, [z[f"g{i}"] for i in range(treedef.num_leaves)])
    jmet = {k[2:]: z[k] for k in z.files if k.startswith("m_")}
    _check_step("dbrx", world.result(("train", "dbrx", (2, 2))), z["loss"],
                jmet, jgrads)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("key", ["yi", "whisper"])
def test_prefill_and_decode_match_jax(world, jax_refs, key, mesh):
    """Prefill and two decode steps on 4 real ranks within
    1e-5·max|logits| of the JAX package. On (1, 4) the decode steps were
    off by half of max|logits| when the K/V written into a cache split over
    "model" went into a copy (C.7)."""
    want = jax_refs[key]
    got = world.result(("serve", key, mesh))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=LOGITS_RTOL * np.abs(w).max(),
                                   err_msg=f"{key} {mesh} step {i}")


def test_checkpoint_is_written_once_and_restores_bit_for_bit(world):
    """4 ranks save one state: rank 0 alone writes (its saves recorded,
    none on the others), no rank sees a half-written directory when
    ``save`` or ``wait`` returns, the async saves prune to ``keep``, and
    the restore onto the mesh gives every leaf bit for bit (C.8: the ranks
    raced on the temporary directory and the rename)."""
    ranks = world.every_rank("checkpoint")
    for r, out in enumerate(ranks):
        assert not isinstance(out, str), f"rank {r}:\n{out}"
        assert out["after_save"] == ["ckpt_00000001"], (r, out)
        assert out["after_async"] == ["ckpt_00000002", "ckpt_00000003"]
        assert out["writes"] == ([1, 2, 3] if r == 0 else []), (r, out)
        assert out["step"] == 3 and out["on_mesh"] and out["bitwise"], r


def test_driver_replays_a_failure_and_a_straggler_bit_for_bit(world):
    """A 4-rank ``TrainDriver`` run with a straggler on one rank at step 1
    (every rank replays it: a step is slow when it is slow anywhere) and a
    failure at step 3 (restored from step 2's checkpoint) gives the clean
    run's losses, replayed, and its final state bit for bit."""
    ranks = world.every_rank("driver")
    for r, out in enumerate(ranks):
        assert not isinstance(out, str), f"rank {r}:\n{out}"
    clean, faulty = ranks[0]["clean"], ranks[0]["faulty"]
    assert clean["steps"] == [0, 1, 2, 3] and clean["events"] == []
    assert faulty["steps"] == [0, 1, 2, 2, 3]
    losses = clean["losses"]
    assert faulty["losses"] == losses[:3] + losses[2:]
    for r, out in enumerate(ranks):
        events = out["faulty"]["events"]
        assert any(s == 1 and e.startswith("straggler") for s, e in events), (
            r, events)
        assert (2, "restart-from-ckpt") in events, (r, events)
        assert out["faulty"]["losses"] == faulty["losses"], r
        for run in ("clean", "faulty"):
            assert out[run]["writes"] == ([2, 4] if r == 0 else []), (r, run)
    for k, v in clean["state"].items():
        assert np.array_equal(faulty["state"][k], v), k


def test_state_saved_by_4_ranks_restores_onto_2(world):
    """The elastic re-scale across worlds: the faulty run's final state,
    saved by the 4-rank world, restored by a 2-rank world onto its own
    ``param_shardings`` and ``opt_shardings`` through
    ``TrainDriver.restore_onto``, every leaf bit for bit; the 2-rank
    world's results come back in rank order."""
    two = [r[0] for r in world.resharded.result()]
    for r, out in enumerate(two):
        assert not isinstance(out, str), f"rank {r}:\n{out}"
        assert out["rank"] == r and out["world"] == 2, out
        assert out["step"] == 4 and out["placed"], r
    saved = world.every_rank("driver")[0]["faulty"]["state"]
    got = two[0]["leaves"]
    assert list(got) == list(saved)
    for k, v in saved.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
