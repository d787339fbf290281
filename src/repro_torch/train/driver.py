"""Fault-tolerant training driver, after the JAX package's
``repro.train.driver``, with the same behaviour:

  * checkpoint/restart — periodic async checkpoints; on step failure the
    driver restores the latest checkpoint and replays (the data pipeline is
    stateless-by-step, so the token stream resumes exactly);
  * straggler mitigation — per-step deadline; a straggling step is
    re-executed from the same state (deterministic backup replay), and the
    deadline is widened;
  * elastic re-scale — ``reshard_to`` round-trips the state through the
    checkpointer onto new shardings (``param_shardings`` and
    ``opt_shardings`` of a mesh that may have another rank count), or onto
    the driver's device where they are None; across worlds, a world of
    another size restores what the old world saved with ``restore_onto``;
  * failure injection — ``failure_at`` (steps that raise) and
    ``straggle_at`` (steps that sleep past the deadline) let tests verify
    the recovery paths end-to-end.

The driver runs on its model API's device (``get_model``'s: the CUDA card
unless the caller asked for the CPU); where the JAX driver blocks on a
result it synchronises the card. A state of DTensors (on a ``DeviceMesh``,
under the ``sharding_policy`` of that mesh) trains on the mesh: each batch
is placed by ``batch_shardings``, every rank taking its own rows of the
pipeline's batch (which every rank draws alike) without sending any. In a
world of more than one rank a step is a straggler when it was one on any
rank, so that every rank replays it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.shardings import batch_shardings
from repro_torch.models.registry import ModelApi
from repro_torch.train.checkpoint import Checkpointer, shardings_of
from repro_torch.train.optim import AdamW
from repro_torch.train.step import make_train_step


# the checkpoint step of reshard_to's round trip
RESHARD_STEP = 0x7FFFFFFF


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
        mesh = next((p.device_mesh for p in params.parameters()
                     if isinstance(p, DTensor)), None)
        while step < self.dcfg.steps:
            batch = self._batch(step, mesh)
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
            wall = self._slowest(time.time() - t0)
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

    def _slowest(self, wall: float) -> float:
        """The longest of every rank's ``wall`` (this one's without a world
        of more than one rank)."""
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return wall
        t = torch.tensor([wall], dtype=torch.float64,
                         device=self.device if dist.get_backend() == "nccl"
                         else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def _batch(self, step: int, mesh=None) -> dict:
        """Step ``step``'s batch; on ``mesh`` placed by ``batch_shardings``,
        each rank keeping its own rows of the batch it drew."""
        b = {k: torch.as_tensor(v, dtype=torch.long, device=self.device)
             for k, v in self.pipe.batch(step).items()}
        if self.extra_batch is not None:
            b.update({k: torch.as_tensor(v, device=self.device)
                      for k, v in self.extra_batch(step).items()})
        if mesh is None:
            return b
        sh = batch_shardings(mesh, b)
        return {k: distribute_tensor(v, mesh, sh[k].placements,
                                     src_data_rank=None)
                for k, v in b.items()}

    def _restore(self, params, opt_state):
        """The latest checkpoint, placed as the running state is (on its
        mesh, for a state of DTensors)."""
        like = {"params": params, "opt": opt_state}
        state, step = self.ckpt.restore(like, shardings=shardings_of(like),
                                        device=self.device)
        return (state["params"], state["opt"]), step

    # ------------------------------------------------------------ elastic
    def reshard_to(self, params, opt_state, shardings_params,
                   shardings_opt) -> tuple[Any, Any]:
        """Elastic re-scale: round-trip the state through host memory onto
        new shardings (a mesh whose rank count may differ: a node dropped
        out); a None leaf or tree goes to the driver's device."""
        self.ckpt.save(RESHARD_STEP, {"params": params, "opt": opt_state})
        params, opt_state, _ = self.restore_onto(
            params, opt_state, shardings_params, shardings_opt,
            step=RESHARD_STEP)
        return params, opt_state

    def restore_onto(self, params, opt_state, shardings_params,
                     shardings_opt, step: int | None = None
                     ) -> tuple[Any, Any, int]:
        """The checkpoint at ``step`` (the latest by default) in the
        structure and dtypes of ``params`` and ``opt_state`` (any state of
        the same model: meta tensors do), placed on the given shardings:
        the second half of an elastic re-scale, in a world that may have
        another rank count than the one that saved it. Returns (params,
        opt_state, step)."""
        state, step = self.ckpt.restore(
            {"params": params, "opt": opt_state}, step=step,
            shardings={"params": shardings_params, "opt": shardings_opt},
            device=self.device)
        return state["params"], state["opt"], step
