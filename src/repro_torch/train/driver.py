"""Fault-tolerant training driver, after the JAX package's
``repro.train.driver``, with the same behaviour:

  * checkpoint/restart — periodic async checkpoints; on step failure the
    driver restores the latest checkpoint and replays (the data pipeline is
    stateless-by-step, so the token stream resumes exactly);
  * straggler mitigation — per-step deadline; a straggling step is
    re-executed from the same state (deterministic backup replay), and the
    deadline is widened;
  * re-placement — ``reshard_to`` round-trips the state through the
    checkpointer onto a device (the JAX package's re-shard onto a new mesh
    waits for the port's mesh layer);
  * failure injection — ``failure_at`` (steps that raise) and
    ``straggle_at`` (steps that sleep past the deadline) let tests verify
    the recovery paths end-to-end.

The driver runs on its model API's device (``get_model``'s: the CUDA card
unless the caller asked for the CPU); where the JAX driver blocks on a
result it synchronises the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.registry import ModelApi
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.optim import AdamW
from repro_torch.train.step import make_train_step


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class DriverConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "build/repro_ckpt"
    deadline_s: float = 1e9          # straggler threshold
    max_retries: int = 3
    keep: int = 3


class TrainDriver:
    def __init__(self, api: ModelApi, opt: AdamW, pipe: SyntheticLM,
                 dcfg: DriverConfig,
                 failure_at: set[int] | None = None,
                 straggle_at: dict[int, float] | None = None,
                 extra_batch: Callable[[int], dict] | None = None):
        self.api = api
        self.device = api.device
        self.opt = opt
        self.pipe = pipe
        self.dcfg = dcfg
        self.ckpt = Checkpointer(dcfg.ckpt_dir, keep=dcfg.keep)
        self.step_fn = make_train_step(api, opt)
        self.failure_at = failure_at or set()
        self.straggle_at = straggle_at or {}
        self.extra_batch = extra_batch
        self.events: list[tuple[int, str]] = []
        self.metrics: list[dict] = []

    # ---------------------------------------------------------------- run
    def run(self, params=None, opt_state=None) -> tuple[Any, Any, int]:
        if params is None:
            params = self.api.init(
                torch.Generator(device=self.device).manual_seed(0),
                trainable=True)
        if opt_state is None:
            opt_state = self.opt.init(params)
        start = 0
        if self.ckpt.latest_step() is not None:
            (params, opt_state), start = self._restore(params, opt_state)
            self.events.append((start, "restored"))

        step = start
        retries = 0
        deadline = self.dcfg.deadline_s
        while step < self.dcfg.steps:
            batch = self._batch(step)
            t0 = time.time()
            try:
                if step in self.failure_at and retries == 0:
                    self.failure_at.discard(step)
                    raise InjectedFailure(f"injected failure at step {step}")
                if step in self.straggle_at:
                    time.sleep(self.straggle_at.pop(step))
                params2, opt_state2, m = self.step_fn(params, opt_state,
                                                      batch)
                self._sync()
            except InjectedFailure as e:
                self.events.append((step, f"failure: {e}"))
                retries += 1
                if retries > self.dcfg.max_retries:
                    raise
                (params, opt_state), step = self._restore(params, opt_state)
                self.events.append((step, "restart-from-ckpt"))
                continue
            wall = time.time() - t0
            if wall > deadline:
                # straggler: deterministic backup replay, then widen the
                # deadline so a persistently slow host doesn't livelock
                self.events.append((step, f"straggler {wall:.3f}s"))
                deadline = max(deadline, wall * 1.5)
                params2, opt_state2, m = self.step_fn(params, opt_state,
                                                      batch)
            params, opt_state = params2, opt_state2
            retries = 0
            self.metrics.append(
                {"step": step, "loss": float(m["loss"]),
                 "grad_norm": float(m["grad_norm"]), "wall_s": wall})
            step += 1
            if step % self.dcfg.ckpt_every == 0:
                self.ckpt.save_async(step, {"params": params,
                                            "opt": opt_state})
        self.ckpt.wait()
        return params, opt_state, step

    # ------------------------------------------------------------ helpers
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batch(self, step: int) -> dict:
        b = {k: torch.as_tensor(v, dtype=torch.long, device=self.device)
             for k, v in self.pipe.batch(step).items()}
        if self.extra_batch is not None:
            b.update({k: torch.as_tensor(v, device=self.device)
                      for k, v in self.extra_batch(step).items()})
        return b

    def _restore(self, params, opt_state):
        state, step = self.ckpt.restore(
            {"params": params, "opt": opt_state}, device=self.device)
        return (state["params"], state["opt"]), step

    # ------------------------------------------------------- re-placement
    def reshard_to(self, params, opt_state, device) -> tuple[Any, Any]:
        """Round-trip the state through host memory onto ``device``."""
        self.ckpt.save(0x7FFFFFFF, {"params": params, "opt": opt_state})
        state, _ = self.ckpt.restore(
            {"params": params, "opt": opt_state}, step=0x7FFFFFFF,
            device=device)
        return state["params"], state["opt"]
