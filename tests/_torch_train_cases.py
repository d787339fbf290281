"""Shared set-up of the training parity tests (``test_torch_train*.py``):
one JAX init carried across with ``params_from_jax(..., trainable=True)``,
the zero/one-initialised leaves perturbed so that they matter, seeded
batches from the data pipeline (and numpy patch embeddings or frames), and
the checks that one train step, a 5-step loss trajectory and a
2-microbatch step agree with the JAX package's, in float32 on the CPU.

Tolerances: the loss to 1e-5 relative, every
gradient leaf to 1e-4·max|g_leaf|, the trajectory to 1e-4 relative. The
port's SSD runs the chunk kernel's plain version plus a recurrence and its
attention the flash kernel's plain version, so float32 sums run in another
order than in the JAX model."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.train import optim as jopt
from repro.train import step as jstep
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.convert import named_from_jax, params_from_jax
from repro_torch.models.registry import get_config, get_model
from repro_torch.train import optim as topt
from repro_torch.train import step as tstep

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4          # of max|g| per leaf
TRAJ_RTOL = 1e-4
EPS32 = float(np.finfo(np.float32).eps)
B, S = 2, 32
N_FRAMES = 32

CASES = {
    "qwen": ("qwen1.5-0.5b", {}),
    "mamba2": ("mamba2-370m", {"ssd_chunk": 16}),
    "zamba2": ("zamba2-1.2b", {"n_layers": 7, "ssd_chunk": 16}),
    "yi": ("yi-6b", {}),
    "stablelm": ("stablelm-1.6b", {}),
    "starcoder2": ("starcoder2-15b", {}),
    "qwen3-moe": ("qwen3-moe-235b-a22b", {}),
    "dbrx": ("dbrx-132b", {}),
    "internvl2": ("internvl2-1b", {}),
    "whisper": ("whisper-tiny", {}),
}
# zero/one-initialised leaves, perturbed so that their gradients matter
_PERTURB = ("A_log", "dt_bias", "D", "norm_w", "w", "b", "bq", "bk", "bv",
            "b_in", "b_out", "conv_b")


@dataclasses.dataclass
class Case:
    jcfg: object
    japi: object
    jparams: dict
    tcfg: object
    tapi: object
    model: torch.nn.Module


def setup(case: str, seed: int = 0) -> Case:
    name, over = CASES[case]
    jcfg = dataclasses.replace(jax_config(name).reduced(**over), remat=False)
    tcfg = get_config(name).reduced(**over)
    japi = jax_model(jcfg)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if getattr(path[-1], "key", None) in _PERTURB:
            return a + rng.normal(0, 0.3, a.shape).astype(np.float32)
        return a
    tree = jax.tree_util.tree_map_with_path(
        perturb, japi.init(jax.random.PRNGKey(seed)))
    return Case(jcfg, japi, jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
                get_model(tcfg, device="cpu"),
                params_from_jax(tcfg, tree, device="cpu", trainable=True))


def batches(cfg, step: int, seed: int = 0):
    """(JAX batch, port batch) of the same numpy arrays: the pipeline's
    tokens and labels, and a vlm's patch embeddings or an encdec model's
    frames (seeded, fixed across steps)."""
    b = SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B,
                    seed=seed).batch(step)
    rng = np.random.default_rng(100 + seed)
    if cfg.family == "vlm":
        b["vis_embeds"] = rng.standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, N_FRAMES, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v, dtype=torch.long if v.dtype == np.int32
                             else torch.float32) for k, v in b.items()}
    return jb, tb


def assert_grads_close(c: Case, jgrads, tgrads: dict) -> None:
    """Every leaf within GRAD_RTOL·max|g_leaf|. A leaf whose exact gradient
    is 0 (an attention key bias: the softmax does not see a shift common
    to all keys) holds rounding noise only, so no leaf is held closer than
    float32's epsilon times the largest gradient of the model."""
    want = named_from_jax(c.tcfg, jax.tree_util.tree_map(np.asarray, jgrads),
                          device="cpu")
    assert set(want) == set(tgrads)
    floor = EPS32 * max(float(w.abs().max()) for w in want.values())
    for name, g in tgrads.items():
        w = want[name].numpy()
        atol = max(GRAD_RTOL * float(np.abs(w).max()), floor)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol,
                                   err_msg=name)


def check_one_step(case: str) -> None:
    """The loss and every gradient leaf of one step against JAX's
    ``value_and_grad`` of its ``make_loss_fn``."""
    c = setup(case)
    jb, tb = batches(c.tcfg, 0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(c.japi), has_aux=True))(c.jparams, jb)
    loss, met = tstep.make_loss_fn(c.tapi)(c.model, tb)
    names, leaves = zip(*c.model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert_grads_close(c, jgrads, grads)


def check_trajectory(case: str, steps: int = 5) -> None:
    """``make_train_step`` with AdamW on a warmup-cosine schedule: the loss
    of each of ``steps`` steps, and the first step's global gradient norm.
    Later gradient norms are not held: Adam moves a weight whose gradient
    is near eps by lr·g/(|g| + eps), so float32 noise in such tiny
    gradients moves it by a visible fraction of lr, and the next gradients
    follow (measured on mamba2: weights 4e-5 apart after one step, the
    norm 6e-4 apart after four, the loss within 3e-6)."""
    c = setup(case, seed=1)
    jo = jopt.AdamW(lr=jopt.warmup_cosine(3e-3, warmup=2, total=steps))
    to = topt.AdamW(lr=topt.warmup_cosine(3e-3, warmup=2, total=steps))
    jfn = jax.jit(jstep.make_train_step(c.japi, jo))
    tfn = tstep.make_train_step(c.tapi, to)
    jp, js = c.jparams, jo.init(c.jparams)
    tp, ts = c.model, to.init(c.model)
    for i in range(steps):
        jb, tb = batches(c.tcfg, i, seed=1)
        jp, js, jm = jfn(jp, js, jb)
        tp, ts, tm = tfn(tp, ts, tb)
        for k in ("loss", "grad_norm")[:2 if i == 0 else 1]:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=TRAJ_RTOL, err_msg=f"{k} {i}")
    assert int(ts.step) == int(js.step) == steps


def check_microbatches(case: str) -> None:
    """``microbatches=2``: the last microbatch's loss (and xent) as JAX
    returns it, and the global norm of the averaged gradient."""
    c = setup(case, seed=2)
    jb, tb = batches(c.tcfg, 0, seed=2)
    jm = jax.jit(jstep.make_train_step(c.japi, jopt.AdamW(lr=1e-3),
                                       microbatches=2))(
        c.jparams, jopt.AdamW().init(c.jparams), jb)[2]
    to = topt.AdamW(lr=1e-3)
    tm = tstep.make_train_step(c.tapi, to, microbatches=2)(
        c.model, to.init(c.model), tb)[2]
    assert set(tm) == set(jm) == {"xent", "loss", "grad_norm"}
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


def smoke_forward_and_train_step(name: str) -> None:
    """tests/test_archs.py's check on the port alone: a reduced model
    from a ``torch.Generator``, its forward's shape and finiteness, and one
    train step with a finite loss and gradient norm that changes the
    parameters."""
    cfg = get_config(name).reduced()
    api = get_model(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(0), trainable=True)
    _, tb = batches(cfg, 0)
    logits = api.forward(model, tb)
    n_vis = cfg.n_vis_tokens if cfg.family == "vlm" else 0
    assert logits.shape == (B, S + n_vis, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    opt = topt.AdamW(lr=1e-3)
    model2, _, m = tstep.make_train_step(api, opt)(model, opt.init(model),
                                                   tb)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    with torch.no_grad():
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(model.parameters(), model2.parameters()))
    assert diff > 0.0
