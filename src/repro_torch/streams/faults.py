"""Deterministic fault injection for the streaming campaign runtime (the
port's own copy of the reference's ``repro.streams.faults``: same specs,
same consumption order, same seeded plans).

The paper treats runtime failure as a first-class event — links die
mid-run, controllers re-solve, the system degrades and recovers — and the
campaign pipeline (``FleetRunner.run_campaign`` of
``repro_torch.streams.fleet``) inherits that premise on the *harness*
side: a transfer worker can throw, a preemptible device can hang an H2D
copy, one scenario out of 10⁴ can NaN-poison its metric row.
Every one of those recovery paths must be **testable on demand**, not
hoped-for, so this module provides an injectable, seeded
:class:`FaultPlan` the campaign loop consults at each pipeline stage:

* ``"pack"``   — host staging of a chunk raises before the slot is filled;
* ``"transfer"`` — the H2D worker raises (or, with ``hang_s``, sleeps —
  exercising the ``transfer_timeout_s`` watchdog instead of the retry
  path);
* ``"dispatch"`` — the chunk's compute raises when it starts;
* ``"abort"``  — a :class:`FaultAbort` (a ``BaseException``, so no retry
  handler can swallow it) kills the campaign mid-stream, simulating a
  preemption/SIGKILL for checkpoint-resume tests;
* *poisoned scenarios* — the listed scenario indices get their
  ``[n_metrics]`` epilogue row overwritten with NaN at every collection,
  so the poison deterministically **follows the scenario** through chunk
  retries and bisection, exactly like a genuinely NaN-producing run would.

Faults are consumed deterministically: a :class:`FaultSpec` with
``times=2`` fires on the first two matching stage visits (wherever they
happen — pipeline attempt, retry, bisected sub-run) and then never again,
which is what makes "transient failure → retry succeeds" a reproducible
test instead of a race. ``times=-1`` fires forever (a permanently broken
stage). All injection state is behind a lock — the transfer stage fires
on the worker thread.

Nothing here touches the device computation: injection happens in the
host-side pipeline only, so a run with ``faults=None`` is byte-for-byte
the unfaulted campaign path.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterable, Sequence

import numpy as np

#: pipeline stages a FaultSpec may target (in pipeline order)
FAULT_STAGES = ("pack", "transfer", "dispatch", "abort")


class InjectedFault(RuntimeError):
    """A deterministic, injected pipeline failure (retryable)."""

    def __init__(self, stage: str, chunk: int):
        super().__init__(f"injected {stage} fault (chunk {chunk})")
        self.stage = stage
        self.chunk = chunk


class FaultAbort(BaseException):
    """Injected mid-campaign kill. Deliberately a ``BaseException`` (like
    ``KeyboardInterrupt``): the campaign's retry machinery catches
    ``Exception`` only, so an abort always propagates through the
    teardown path — the closest in-process stand-in for a preemption."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injectable failure.

    ``chunk`` is the campaign *job index* to target (``None`` = any
    chunk); ``times`` is how many matching stage visits fire before the
    spec is spent (``-1`` = every visit — a permanent fault); a nonzero
    ``hang_s`` makes the visit *sleep* instead of raising, which is how
    the transfer watchdog (``transfer_timeout_s``) gets exercised."""

    stage: str
    chunk: int | None = None
    times: int = 1
    hang_s: float = 0.0

    def __post_init__(self):
        if self.stage not in FAULT_STAGES:
            raise ValueError(
                f"unknown fault stage {self.stage!r}; expected one of "
                f"{FAULT_STAGES}")
        if self.times == 0 or self.times < -1:
            raise ValueError(f"times must be positive or -1, got {self.times}")
        if self.hang_s < 0:
            raise ValueError(f"hang_s must be >= 0, got {self.hang_s}")
        if self.hang_s > 0 and self.stage != "transfer":
            raise ValueError("hang_s is only meaningful for the 'transfer' "
                             "stage (the watchdogged one)")


@dataclasses.dataclass(frozen=True)
class FailureRecord:
    """One quarantined scenario in a campaign's structured failure report:
    which scenario, which pipeline stage gave up on it, why, and after how
    many attempts. The scenario's ``CampaignResult`` metric row is NaN."""

    scenario: int
    stage: str
    reason: str
    attempts: int


class FaultPlan:
    """A deterministic, consumable schedule of injected faults.

    Construct explicitly from :class:`FaultSpec`\\ s plus a set of
    permanently NaN-poisoned scenario indices, or reproducibly via
    :meth:`random`. The campaign loop calls :meth:`fire` at each pipeline
    stage and :meth:`poison_mask` at each metric collection; ``log``
    records every injection as ``(stage, chunk, kind)`` so tests can
    assert exactly what fired.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (),
                 poison: Iterable[int] = ()):
        self.specs = tuple(specs)
        self.poison = frozenset(int(i) for i in poison)
        self.log: list[tuple[str, int, str]] = []
        self._remaining = [s.times for s in self.specs]
        self._lock = threading.Lock()

    @classmethod
    def random(cls, seed: int, n_chunks: int, n_scenarios: int,
               n_transient: int = 2, n_poison: int = 1,
               stages: Sequence[str] = ("transfer", "dispatch")
               ) -> "FaultPlan":
        """Seeded random plan: ``n_transient`` single-shot faults on random
        chunks/stages plus ``n_poison`` permanently poisoned scenarios —
        the same seed builds the same plan, so a failing fuzz case replays
        exactly."""
        rng = np.random.default_rng(seed)
        specs = [FaultSpec(stage=str(rng.choice(list(stages))),
                           chunk=int(rng.integers(max(n_chunks, 1))))
                 for _ in range(n_transient)]
        poison = (rng.choice(n_scenarios, size=min(n_poison, n_scenarios),
                             replace=False)
                  if n_poison > 0 else ())
        return cls(specs, poison)

    def fire(self, stage: str, chunk: int) -> None:
        """Consult the plan at a pipeline stage visit: consume and apply
        the first live matching spec (raise :class:`InjectedFault` /
        :class:`FaultAbort`, or sleep ``hang_s``); no-op otherwise."""
        hang = None
        with self._lock:
            for k, spec in enumerate(self.specs):
                if spec.stage != stage:
                    continue
                if spec.chunk is not None and spec.chunk != chunk:
                    continue
                if self._remaining[k] == 0:
                    continue
                if self._remaining[k] > 0:
                    self._remaining[k] -= 1
                self.log.append(
                    (stage, chunk, "hang" if spec.hang_s > 0 else "raise"))
                hang = spec.hang_s
                break
            else:
                return
        if stage == "abort":
            raise FaultAbort(f"injected abort at chunk {chunk}")
        if hang and hang > 0:
            time.sleep(hang)  # the watchdog, not this sleep, raises
            return
        raise InjectedFault(stage, chunk)

    def poison_mask(self, idxs: Sequence[int]) -> np.ndarray:
        """[len(idxs)] bool: which of these scenario rows to NaN-poison."""
        return np.asarray([int(i) in self.poison for i in idxs], bool)

    def n_fired(self, stage: str | None = None) -> int:
        with self._lock:
            return sum(1 for s, _, _ in self.log
                       if stage is None or s == stage)
