"""Batched multi-scenario simulation: run a *fleet* of independent
simulations bucket by bucket on one device, behind a persistent
:class:`FleetRunner`.

The paper validates Alg. 1 on one 10-workstation topology (§VI); every
follow-up question — capacity sweeps, placement studies, link failures,
random-DAG robustness — is "run the same simulator on N variants". A
Python loop over scenarios pays one host tick loop per scenario, and the
simulator's tick is host-bound on a GPU (hundreds of small launches of
almost no work each). The runner stacks scenarios of one padded shape into
a *bucket* and runs each bucket's tick loop once: every launch of a tick
then works on all B scenarios of the bucket (``torch.func.vmap`` over the
per-scenario step, :func:`repro_torch.streams.simulator._run_bucket`), so
the launch count stays that of one scenario while the work per launch
grows with B. Padding everything to the *global* max shape would inflate
the solver (the max-min fill is O(F²·L)), so:

  1. **Overhead-aware shape bucketing** — scenarios are grouped into at
     most ``max_buckets`` buckets by greedy agglomerative merging under a
     two-term cost model (:func:`_flop_cost` + ``tick_overhead``): merging
     a pair trades the padded-FLOP waste it adds against the fixed
     per-bucket per-tick overhead it removes. The FLOP model is
     policy-aware (tcp re-solves every tick; appaware pays its allocator
     per controller interval; scheduled shapes add the enforcement
     machinery; "fixed" pays the base tick only). ``tick_overhead`` comes
     from a per-device calibration (:func:`calibrate_backend`).
  2. **One host tick loop per fleet run** (``fused=True``): the buckets'
     steps are interleaved tick by tick in one loop; ``fused=False`` runs
     each bucket's loop in turn (the per-bucket oracle). Per-bucket
     results are bitwise identical either way: a bucket's launches and
     their order do not change. ``last_stats["n_dispatches"]`` counts these
     host tick loops (the JAX reference counts XLA executables there).
  3. **Staging buffers** — per (bucket shape, members, rows) the runner
     keeps preallocated numpy buffers; repeat calls re-stack scenarios by
     slice assignment. Spare rows keep their pad values: they are *inert
     scenarios* (zero generation/demand, huge-capacity INTERNAL links,
     never-active events) whose rows are dropped on return. Bucket rows
     are rounded up to a small quantum (:func:`_round_rows`).
  4. **Device-resident packs** — each staged bucket is copied to the
     device once and the same tensors are re-passed on every warm call; a
     scenario changed in place (caught by a crc32 over its field bytes) is
     restaged and its pack replaced.

Padding within a bucket is *neutral by construction*: padded flows have no
routing-matrix entries, no producers and zero queues; padded links carry
huge capacity and INTERNAL kind, so no solver binds on them; padded
capacity-schedule components are exact no-ops. A static scenario padded
into a *scheduled* bucket keeps its exact static semantics through the
per-scenario enforcement gate of ``_tick``. Appfair buckets group by
*exact* ``n_apps`` (its priority grouping depends on the app count).

Appaware with ``solver="waterfill"`` solves every link of every scenario of
a bucket in **one** launch of the waterfill kernel per bucket update
(:func:`repro_torch.kernels.waterfill.ops.waterfill_fleet`, B·L blocks).

:meth:`FleetRunner.run_campaign` is the **streaming campaign** for
10³–10⁴-scenario studies: the bucket plan is computed over the whole
campaign, each bucket's members are chunked at one padded row count, and
chunks stream through a three-stage pipeline — host *pack* into three
rotating (pinned, on a CUDA device) host slots, *H2D copy* by a worker
thread on a dedicated copy stream (a CUDA event marks the landed bytes),
and *compute*. A slot is refilled only after its occupant's chunk was
*collected*: on the CPU device the "copy" aliases the slot
(``torch.from_numpy``), so a resolved copy does not free it. Only the
``[rows, n_metrics]`` epilogue slab comes back unless
``retain_trajectories=True``. The campaign is resilient (retry with capped
backoff, a transfer watchdog, bisection and quarantine of non-finite rows,
checkpoint/resume; :mod:`repro_torch.streams.faults` injects faults).

``shard`` spreads the work over devices (:meth:`FleetRunner._shard_devices`):
``True`` every visible device of the runner's type (every card on "cuda",
the one CPU device on "cpu"), ``False`` the runner's own device, or a list
of devices, where a repeated device counts once per entry (``["cpu"] * 4``
or ``["cuda:0"] * 4`` stand in for four devices, as the reference's tests
emulate four with ``--xla_force_host_platform_device_count``). ``run``
splits each bucket's padded rows into one contiguous piece per device, each
piece its own tick loop on its device; ``run_campaign`` sends chunk ``j`` to
stream ``j % n_streams``, each stream with its own host slots and copy
stream (and compute stream, on a card). A chunk's padded row count does not
depend on the device count, so the shard changes where a chunk runs, never
what it computes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
import weakref
import zlib
from concurrent.futures import CancelledError as FuturesCancelledError
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.tcp import maxmin_fused
from repro_torch.device import resolve_device
from repro_torch.net.topology import LinkKind
from repro_torch.streams.faults import FailureRecord, FaultPlan, InjectedFault
from repro_torch.streams.graphs import BucketGraphs
from repro_torch.streams.simulator import (
    CAMPAIGN_METRICS,
    CompiledSim,
    SimResult,
    _run_bucket,
    _validate_sim_inputs,
    metric_index,
    resolve_upd_every,
    result_from_padded_row,
    sim_from_numpy,
    smoke_seconds,
)

# padded links must never constrain any solver: effectively infinite pipes
_PAD_CAP = 1e9

# Fallback per-bucket per-tick overhead in `_flop_cost`'s proxy-FLOP units
# (the reference's CPU figure: ≈4 µs per extra bucket-tick against solver
# GEMMs sustaining ≈3.7 GFLOP/s). The default path measures both
# quantities on the device (`calibrate_backend`); this constant is the
# `REPRO_CALIBRATE=0` fallback on the CPU and the anchor of its clamp band.
TICK_OVERHEAD_FLOPS_CPU = 15e3

# Plan-stability clamp for the measured tick overhead, per device type: a
# noisy measurement moves the plan inside the band, never past the
# planner invariants the tests pin. Other devices (the CUDA card) get the
# far looser default band.
_CALIB_CLAMP = {"cpu": (8e3, 64e3)}
_CALIB_CLAMP_DEFAULT = (5e2, 1e6)


def _host(a) -> np.ndarray:
    """A numpy view (CPU tensors, arrays) or copy (device tensors)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with its index: "cuda" is the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass(frozen=True)
class BackendCalibration:
    """Measured per-device overhead model (see :func:`calibrate_backend`).
    All µs figures are medians of warm round trips; ``proxy_mflops`` is the
    rate at which this device retires the proxy FLOPs of `_flop_cost`'s
    solver term, measured on the real batched max-min fill."""

    backend: str
    dispatch_us: float       # tiny op issued and synchronised
    sync_us: float           # [64, n_metrics] device->host fetch
    tick_overhead_us: float  # marginal cost of one extra loop tick
    proxy_mflops: float      # effective proxy-FLOP rate of the solver probe
    tick_overhead_flops: float  # tick_overhead_us × rate, clamped
    clamped: bool            # True when the raw product left the band
    measured: bool           # False for the REPRO_CALIBRATE=0 fallback

    @property
    def chunk_overhead_s(self) -> float:
        """Fixed cost floor of one campaign chunk: one dispatch plus one
        ``[rows, n_metrics]`` metric fetch."""
        return (self.dispatch_us + self.sync_us) * 1e-6


_CALIBRATION: dict[str, BackendCalibration] = {}


def _measure_calibration(dev: torch.device) -> BackendCalibration:
    f32 = torch.float32

    def med_us(fn, reps=7):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts) * 1e6)

    # (a) a tiny op, issued and synchronised: the per-chunk dispatch floor
    x = torch.arange(64, dtype=f32, device=dev)

    def tiny():
        y = x * 2.0 + 1.0
        _sync(dev)
        return y
    tiny()
    dispatch_us = med_us(tiny)
    # (b) device->host fetch of a campaign-sized metric summary
    m = torch.zeros((64, len(CAMPAIGN_METRICS)), dtype=f32, device=dev)
    (m + 1.0).cpu().numpy()
    sync_us = med_us(lambda: (m + 1.0).cpu().numpy())
    # (c) per-tick loop overhead by loop-length differencing, on a body of
    # a few elementwise ops on a small carry (compute cancels out)
    carry0 = torch.ones((32, 16), dtype=f32, device=dev)

    def loop_of(n):
        def run():
            c = carry0
            for _ in range(n):
                c = c * 0.999 + 0.001
                c = c + 0.1 * torch.tanh(c)
                c = torch.clamp_max(c * 1.001, 8.0)
                c = c - 0.05 * torch.clamp_min(c - 1.0, 0.0)
            _sync(dev)
        run()
        return med_us(run, reps=5)

    n_short, n_long = 32, 512
    tick_us = max((loop_of(n_long) - loop_of(n_short)) / (n_long - n_short),
                  0.05)
    # (d) effective proxy-FLOP rate: a vmapped fused max-min fill at seed-
    # corpus scale, credited with the proxy FLOPs `_flop_cost` bills a tcp
    # solve of that shape
    F, L, B = 17, 32, 32
    rng = np.random.default_rng(0)
    R = torch.tensor((rng.random((B, F, L)) < 0.2).astype(np.float32),
                     device=dev)
    caps = torch.full((B, L), 100.0, dtype=f32, device=dev)
    d = torch.tensor(rng.uniform(1.0, 8.0, (B, F)).astype(np.float32),
                     device=dev)
    solve = torch.func.vmap(maxmin_fused)

    def run_solve():
        solve(R, caps, d)
        _sync(dev)
    run_solve()
    t_solve_us = med_us(run_solve, reps=5)
    proxy_flops = B * 3.0 * 2.0 * (F + 1.0) * F * 2.0 * L
    proxy_mflops = proxy_flops / max(t_solve_us, 1e-3)
    lo, hi = _CALIB_CLAMP.get(dev.type, _CALIB_CLAMP_DEFAULT)
    raw = tick_us * proxy_mflops
    return BackendCalibration(
        backend=dev.type, dispatch_us=dispatch_us, sync_us=sync_us,
        tick_overhead_us=tick_us, proxy_mflops=proxy_mflops,
        tick_overhead_flops=float(min(max(raw, lo), hi)),
        clamped=not (lo <= raw <= hi), measured=True)


def calibrate_backend(device: "str | torch.device | None" = None,
                      force: bool = False) -> BackendCalibration:
    """Per-device overhead calibration, measured once per process and
    device type (cached; ``force=True`` re-measures) on ``device`` (default:
    the CUDA card). The planner's overhead constant and the campaign's
    ``chunk_rows="auto"`` sizing both come from these probes.
    ``REPRO_CALIBRATE=0`` skips the probes and returns the documented
    fallback constants (``measured=False``)."""
    dev = resolve_device(device)
    cached = _CALIBRATION.get(dev.type)
    if cached is not None and not force:
        return cached
    if os.environ.get("REPRO_CALIBRATE", "").strip() == "0":
        calib = BackendCalibration(
            backend=dev.type, dispatch_us=10.0, sync_us=20.0,
            tick_overhead_us=4.0, proxy_mflops=3700.0,
            tick_overhead_flops=(TICK_OVERHEAD_FLOPS_CPU
                                 if dev.type == "cpu" else 2e3),
            clamped=False, measured=False)
    else:
        calib = _measure_calibration(dev)
    _CALIBRATION[dev.type] = calib
    return calib


@dataclasses.dataclass(frozen=True)
class FleetShape:
    """Common padded shape of a stacked fleet (or of one bucket)."""

    n_flows: int
    n_links: int
    n_insts: int
    n_apps: int
    # capacity-schedule axes: padded sinusoids have zero amplitude, padded
    # events never activate, so static and scheduled scenarios batch
    # together exactly
    n_sins: int = 0
    n_events: int = 0
    # route-bank axis (S_r): 0 = static routing. A static-routing scenario
    # in a rerouting bucket gets its base R in bank slot 0 with
    # never-activating intervals
    n_route_states: int = 0

    @classmethod
    def cover(cls, sims: Sequence[CompiledSim]) -> "FleetShape":
        """Smallest shape covering every sim in the fleet."""
        return cls(
            n_flows=max(s.R.shape[0] for s in sims),
            n_links=max(s.R.shape[1] for s in sims),
            n_insts=max(s.M_in.shape[0] for s in sims),
            n_apps=max(s.n_apps for s in sims),
            n_sins=max(s.sin_amp.shape[0] for s in sims),
            n_events=max(s.ev_t0.shape[0] for s in sims),
            n_route_states=max(s.route_bank.shape[0] for s in sims),
        )

    def merge(self, other: "FleetShape") -> "FleetShape":
        return FleetShape(*(max(a, b) for a, b in
                            zip(dataclasses.astuple(self),
                                dataclasses.astuple(other))))


def _sim_shape(sim: CompiledSim) -> FleetShape:
    return FleetShape(
        n_flows=sim.R.shape[0], n_links=sim.R.shape[1],
        n_insts=sim.M_in.shape[0], n_apps=sim.n_apps,
        n_sins=sim.sin_amp.shape[0], n_events=sim.ev_t0.shape[0],
        n_route_states=sim.route_bank.shape[0])


def _sim_content_sig(sim: CompiledSim) -> int:
    """crc32 over every staged field's bytes: the content half of the
    staging-reuse fingerprint (object identity, the other half, cannot see
    a scenario's tensors changed in place between warm calls)."""
    h = 0
    for field in _FIELD_SPECS:
        a = np.ascontiguousarray(_host(getattr(sim, field)))
        h = zlib.crc32(a.tobytes(), h)
    return h


def _flop_cost(shape: FleetShape, policy: str = "tcp") -> float:
    """Per-tick per-scenario padded-FLOP proxy (the reference's model).

    The base term covers the [I, F] dataflow products and [F, L] link
    products; scheduled shapes add the capacity stream and the per-tick
    enforcement, rerouting shapes the per-tick bank gather; tcp/appfair add
    the fused max-min fill (O(F²·L), every tick for tcp), appaware its
    allocator's empirical weight, and "fixed" nothing. Constants only
    matter relative to ``tick_overhead`` (same units)."""
    F, L, I = shape.n_flows, shape.n_links, shape.n_insts
    base = F * L + 2.0 * I * F + 6.0 * F
    if shape.n_sins > 0 or shape.n_events > 0:
        base += 3.0 * F * L + 8.0 * L + 4.0 * shape.n_sins * L \
            + 4.0 * shape.n_events
    if shape.n_route_states > 0:
        base += 2.0 * F * L + 4.0 * shape.n_route_states
    if policy in ("tcp", "appfair"):
        base += 3.0 * 2.0 * (F + 1.0) * F * 2.0 * L
    elif policy == "appaware":
        base += 40.0 * F * L
    return base


def _plan_buckets(sims: Sequence[CompiledSim], max_buckets: int,
                  exact_apps: bool = False, policy: str = "tcp",
                  tick_overhead: float = 0.0) -> list[tuple[list[int],
                                                            FleetShape]]:
    """Greedy agglomerative bucketing: start from one bucket per distinct
    true shape, repeatedly apply the cheapest merge. A merge is forced
    while the bucket count exceeds ``max_buckets`` and otherwise taken only
    when the padded-FLOP waste it adds stays below ``tick_overhead``. With
    ``exact_apps`` (appfair) only buckets with equal ``n_apps`` merge."""
    by_shape: dict[tuple, list[int]] = {}
    for i, s in enumerate(sims):
        by_shape.setdefault(dataclasses.astuple(_sim_shape(s)), []).append(i)
    buckets = [(idxs, FleetShape(*key)) for key, idxs in by_shape.items()]

    def merge_waste(a, b):
        (ia, sa), (ib, sb) = a, b
        cover = sa.merge(sb)
        return ((len(ia) + len(ib)) * _flop_cost(cover, policy)
                - len(ia) * _flop_cost(sa, policy)
                - len(ib) * _flop_cost(sb, policy))

    while len(buckets) > 1:
        best = None
        for j in range(len(buckets)):
            for k in range(j + 1, len(buckets)):
                if exact_apps and (buckets[j][1].n_apps
                                   != buckets[k][1].n_apps):
                    continue
                w = merge_waste(buckets[j], buckets[k])
                if best is None or w < best[0]:
                    best = (w, j, k)
        if best is None:  # no feasible merge (exact_apps partitions)
            break
        if len(buckets) <= max_buckets and best[0] >= tick_overhead:
            break  # within budget and no merge pays for itself
        _, j, k = best
        (ij, sj), (ik, sk) = buckets[j], buckets[k]
        merged = (ij + ik, sj.merge(sk))
        buckets = [b for i, b in enumerate(buckets) if i not in (j, k)]
        buckets.append(merged)
    return buckets


def _round_rows(n: int, n_dev: int) -> int:
    """Padded batch-row capacity for a bucket of ``n`` scenarios: rounded
    up to the device count and, for ``n`` ≥ 16, to a small quantum —
    growth headroom, so a fleet that only gains scenarios within the padded
    capacity reuses its staging."""
    n = -(-n // max(n_dev, 1)) * max(n_dev, 1)
    if n >= 16:
        q = 4 * max(n_dev, 1) // math.gcd(4, max(n_dev, 1))
        n = -(-n // q) * q
    return n


# chunk_rows="auto" bounds: the floor keeps chunks at the staging quantum,
# the ceiling bounds peak staged memory whatever the calibration says
AUTO_CHUNK_MIN = 16
AUTO_CHUNK_MAX = 256
AUTO_CHUNK_OVERHEAD_FRAC = 0.02


def _auto_chunk_rows(shape: FleetShape, policy: str, n_ticks: int,
                     calib: BackendCalibration) -> int:
    """Per-bucket chunk sizing from the calibration: the smallest row count
    that keeps the fixed per-chunk cost (one dispatch plus one metric
    fetch) under ``AUTO_CHUNK_OVERHEAD_FRAC`` of the chunk's modeled
    compute."""
    per_row_s = (_flop_cost(shape, policy) * n_ticks
                 / (calib.proxy_mflops * 1e6))
    rows = math.ceil(calib.chunk_overhead_s
                     / (AUTO_CHUNK_OVERHEAD_FRAC * max(per_row_s, 1e-12)))
    return int(min(max(rows, AUTO_CHUNK_MIN), AUTO_CHUNK_MAX))


# padding/stacking run in numpy on the host: hundreds of tiny device pads
# would dominate a fleet run before its tick loop starts
def _pad1(a, n, value=0.0):
    a = _host(a)
    pad = n - a.shape[0]
    return a if pad <= 0 else np.pad(a, (0, pad), constant_values=value)


def _pad2(a, n0, n1):
    a = _host(a)
    p0, p1 = n0 - a.shape[0], n1 - a.shape[1]
    if p0 <= 0 and p1 <= 0:
        return a
    return np.pad(a, ((0, max(p0, 0)), (0, max(p1, 0))))


def _pad_route_fields(sim: CompiledSim, F: int, L: int,
                      SR: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad the route-bank family to ``SR`` states. A static-routing sim
    (S_r = 0) stages its base R into bank slot 0 with every interval at
    +inf (the per-tick lookup clamps to state 0: exactly ``sim.R``); a
    rerouting sim pads with never-selected zero states."""
    sr0 = sim.route_bank.shape[0]
    bank = np.zeros((SR, F, L), np.float32)
    t = np.full((SR,), np.inf, np.float32)
    state = np.zeros((SR,), np.int32)
    if sr0 == 0:
        if SR > 0:
            bank[0] = _pad2(_host(sim.R).astype(np.float32), F, L)
    else:
        b = _host(sim.route_bank).astype(np.float32)
        bank[:sr0, :b.shape[1], :b.shape[2]] = b
        t[:sr0] = _host(sim.route_t)
        state[:sr0] = _host(sim.route_state)
    return bank, t, state


def _padded_fields(sim: CompiledSim, shape: FleetShape) -> dict:
    """``sim``'s fields zero-padded to ``shape`` as numpy arrays."""
    F, L = shape.n_flows, shape.n_links
    I, S, E = shape.n_insts, shape.n_sins, shape.n_events
    if sim.n_apps > shape.n_apps:
        raise ValueError(f"cannot pad n_apps {sim.n_apps} down to "
                         f"{shape.n_apps}")
    # the compile boundary already validates, but sims are mutable and may
    # be hand-built — catch poisoned fields before they pad into a fleet
    _validate_sim_inputs(
        "pad_sim",
        finite_nonneg=[("caps", _host(sim.caps)),
                       ("gen_rate", _host(sim.gen_rate)),
                       ("ev_scale", _host(sim.ev_scale))],
        nonneg_inf_ok=[("proc_rate", _host(sim.proc_rate)),
                       ("ev_t0", _host(sim.ev_t0)),
                       ("ev_t1", _host(sim.ev_t1))])
    f = False
    route_bank, route_t, route_state = _pad_route_fields(
        sim, F, L, shape.n_route_states)
    return dict(
        R=_pad2(sim.R, F, L),
        caps=_pad1(sim.caps, L, _PAD_CAP),
        kinds=_pad1(sim.kinds, L, int(LinkKind.INTERNAL)),
        has_links=_pad1(sim.has_links, F, f),
        M_in=_pad2(sim.M_in, I, F),
        w_out=_pad2(sim.w_out, I, F),
        p_in=_pad1(sim.p_in, F),
        proc_rate=_pad1(sim.proc_rate, I),
        selectivity=_pad1(sim.selectivity, I),
        gen_rate=_pad1(sim.gen_rate, I),
        is_join=_pad1(sim.is_join, I, f),
        is_sink=_pad1(sim.is_sink, I, f),
        join_dst=_pad1(sim.join_dst, F, f),
        droppable=_pad1(sim.droppable, F, f),
        dst_of_flow=_pad1(sim.dst_of_flow, F, 0),
        src_of_flow=_pad1(sim.src_of_flow, F, 0),
        w_of_flow=_pad1(sim.w_of_flow, F),
        path_w=_pad1(sim.path_w, F),
        app_of_flow=_pad1(sim.app_of_flow, F, 0),
        app_of_inst=_pad1(sim.app_of_inst, I, 0),
        sin_amp=_pad2(sim.sin_amp, S, L),
        sin_omega=_pad2(sim.sin_omega, S, L),
        sin_phase=_pad2(sim.sin_phase, S, L),
        ev_t0=_pad1(sim.ev_t0, E, np.inf),
        ev_t1=_pad1(sim.ev_t1, E, np.inf),
        ev_link=_pad1(sim.ev_link, E, 0),
        ev_scale=_pad1(sim.ev_scale, E, 1.0),
        route_bank=route_bank,
        route_t=route_t,
        route_state=route_state,
    )


def pad_sim(sim: CompiledSim, shape: FleetShape,
            tuples_per_mb: float | None = None) -> CompiledSim:
    """Zero-pad ``sim`` to ``shape`` without changing its dynamics; the
    result lives on ``sim``'s device. ``tuples_per_mb`` may be overridden
    (the fleet keeps each scenario's true value for throughput
    conversion)."""
    return sim_from_numpy(
        _padded_fields(sim, shape),
        tuples_per_mb=(sim.tuples_per_mb if tuples_per_mb is None
                       else float(tuples_per_mb)),
        n_apps=shape.n_apps, device=sim.device)


def stack_sims(
    sims: Sequence[CompiledSim], shape: FleetShape | None = None
) -> tuple[CompiledSim, FleetShape]:
    """Pad every sim to a common shape and stack them into one batched
    CompiledSim (every tensor gains a leading scenario axis), on the first
    sim's device."""
    if not sims:
        raise ValueError("empty fleet")
    shape = FleetShape.cover(sims) if shape is None else shape
    padded = [_padded_fields(s, shape) for s in sims]
    dev = sims[0].device
    return CompiledSim(
        tuples_per_mb=1.0, n_apps=shape.n_apps,
        **{f: torch.as_tensor(np.stack([p[f] for p in padded]), device=dev)
           for f in _FIELD_SPECS}), shape


# field -> (padded-dim axes, pad value); dims keyed into {F, L, I, S, E, SR}.
# A staging row never slice-assigned from a real scenario keeps exactly
# these pad values — an *inert scenario*: zero generation and demand, huge-
# capacity INTERNAL links no solver binds on, never-active events.
_FIELD_SPECS: dict[str, tuple[tuple[str, ...], float]] = {
    "R": (("F", "L"), 0.0),
    "caps": (("L",), _PAD_CAP),
    "kinds": (("L",), int(LinkKind.INTERNAL)),
    "has_links": (("F",), False),
    "M_in": (("I", "F"), 0.0),
    "w_out": (("I", "F"), 0.0),
    "p_in": (("F",), 0.0),
    "proc_rate": (("I",), 0.0),
    "selectivity": (("I",), 0.0),
    "gen_rate": (("I",), 0.0),
    "is_join": (("I",), False),
    "is_sink": (("I",), False),
    "join_dst": (("F",), False),
    "droppable": (("F",), False),
    "dst_of_flow": (("F",), 0),
    "src_of_flow": (("F",), 0),
    "w_of_flow": (("F",), 0.0),
    "path_w": (("F",), 0.0),
    "app_of_flow": (("F",), 0),
    "app_of_inst": (("I",), 0),
    "sin_amp": (("S", "L"), 0.0),
    "sin_omega": (("S", "L"), 0.0),
    "sin_phase": (("S", "L"), 0.0),
    "ev_t0": (("E",), np.inf),
    "ev_t1": (("E",), np.inf),
    "ev_link": (("E",), 0),
    "ev_scale": (("E",), 1.0),
    # route bank: pad states are all-zero (never selected), pad intervals
    # never activate; static-routing members of a rerouting bucket get
    # their base R in slot 0 (see _fill_bucket)
    "route_bank": (("SR", "F", "L"), 0.0),
    "route_t": (("SR",), np.inf),
    "route_state": (("SR",), 0),
}
# the route-bank family, packed inside the ``pack_routes`` span
_ROUTE_FIELDS = ("route_bank", "route_t", "route_state")


def _alloc(shape: tuple, dtype, pinned: bool) -> np.ndarray:
    """An uninitialised host buffer; ``pinned`` takes page-locked memory
    (a numpy view of a pinned tensor), from which a copy to the card runs
    asynchronously."""
    if not pinned:
        return np.empty(shape, dtype)
    return torch.empty(shape, dtype=torch.from_numpy(
        np.empty(0, dtype)).dtype, pin_memory=True).numpy()


@dataclasses.dataclass
class CampaignResult:
    """Per-scenario metric summary of a streaming campaign.

    ``metrics`` is the ``[N, len(CAMPAIGN_METRICS)]`` matrix produced by the
    on-device epilogue, in scenario input order. Throughput columns are
    MB-based; the tuple-rate properties apply each scenario's exact
    ``tuples_per_mb`` on the host. ``results`` holds full per-scenario
    :class:`SimResult` trajectories only with ``retain_trajectories=True``.
    ``failures`` lists one :class:`FailureRecord` per quarantined scenario,
    whose ``metrics`` row is all-NaN."""

    metrics: np.ndarray           # [N, n_metrics], MB-based
    tuples_per_mb: np.ndarray     # [N] exact per-scenario conversion
    dt: float
    policy: str
    results: list[SimResult] | None = None
    failures: list[FailureRecord] = dataclasses.field(default_factory=list)

    def metric(self, name: str) -> np.ndarray:
        """[N] column of ``metrics`` by :data:`CAMPAIGN_METRICS` name."""
        return self.metrics[:, metric_index(name)]

    @property
    def quarantined(self) -> np.ndarray:
        """[K] sorted indices of the quarantined scenarios."""
        return np.asarray(sorted({f.scenario for f in self.failures}), int)

    @property
    def throughput_tps(self) -> np.ndarray:
        """[N] post-warmup mean sink throughput, tuples/s."""
        return self.metric("avg_tput_mb_s") * self.tuples_per_mb

    @property
    def final_throughput_tps(self) -> np.ndarray:
        """[N] smoothed end-of-run sink throughput, tuples/s."""
        return self.metric("final_tput_mb_s") * self.tuples_per_mb

    @property
    def avg_latency_s(self) -> np.ndarray:
        return self.metric("avg_latency_s")

    @property
    def utilization(self) -> np.ndarray:
        return self.metric("utilization")

    @property
    def dip_depth(self) -> np.ndarray:
        return self.metric("dip_depth")

    @property
    def recovery_time_s(self) -> np.ndarray:
        return self.metric("recovery_time_s")


# ------------------------------------------------------------- checkpoints
# A campaign checkpoint is a directory: `manifest.jsonl` (one JSON line per
# completed chunk: fingerprint, job index, scenario indices, slab filename,
# failures) plus one `chunk_<fp>_<job>.npy` float32 slab per chunk, written
# and fsync'd BEFORE its manifest line — an entry implies its slab exists,
# and a kill between the two costs one chunk of re-work, never a torn read.

def _campaign_fingerprint(sims: Sequence[CompiledSim], jobs, cap_rows,
                          plan, base_key, qcap, x_fixed) -> str:
    """Hex digest of everything that determines a campaign's metric rows:
    run parameters, bucket plan and chunking, every scenario's staged field
    bytes, and the fixed-rate vectors."""
    h = zlib.crc32(repr(base_key).encode())
    h = zlib.crc32(repr(float(qcap)).encode(), h)
    h = zlib.crc32(repr([(bi, tuple(idxs)) for bi, idxs in jobs]).encode(), h)
    h = zlib.crc32(repr(list(cap_rows)).encode(), h)
    h = zlib.crc32(repr([dataclasses.astuple(s) for _, s in plan]).encode(), h)
    for s in sims:
        h = zlib.crc32(_sim_content_sig(s).to_bytes(8, "little"), h)
    if x_fixed is not None:
        for xf in x_fixed:
            a = np.ascontiguousarray(_host(xf).astype(np.float32))
            h = zlib.crc32(a.tobytes(), h)
    return f"{h:08x}"


def _checkpoint_load(path: str, fp: str, jobs, n_metrics: int
                     ) -> dict[int, tuple[np.ndarray, list[FailureRecord]]]:
    """Restorable chunks: {job index: (metric slab, failures)} for every
    manifest entry matching this campaign's fingerprint whose slab exists
    and whose scenario list still matches the job structure. Torn or
    foreign lines are skipped."""
    done: dict[int, tuple[np.ndarray, list[FailureRecord]]] = {}
    mpath = os.path.join(path, "manifest.jsonl")
    if not os.path.exists(mpath):
        return done
    with open(mpath) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail from a kill mid-append
            if e.get("fp") != fp:
                continue
            j = int(e["job"])
            if j >= len(jobs) or [int(i) for i in e["idxs"]] != list(
                    jobs[j][1]):
                continue
            fn = os.path.join(path, os.path.basename(e["file"]))
            if not os.path.exists(fn):
                continue
            slab = np.load(fn)
            if slab.shape != (len(e["idxs"]), n_metrics):
                continue
            fails = [FailureRecord(int(r[0]), str(r[1]), str(r[2]),
                                   int(r[3]))
                     for r in e.get("failures", [])]
            done[j] = (slab, fails)
    return done


def _checkpoint_append(path: str, fp: str, j: int, idxs,
                       slab: np.ndarray,
                       fails: Sequence[FailureRecord]) -> None:
    fn = f"chunk_{fp}_{j:05d}.npy"
    with open(os.path.join(path, fn), "wb") as f:
        np.save(f, slab)
        f.flush()
        os.fsync(f.fileno())
    entry = {"fp": fp, "job": j, "idxs": [int(i) for i in idxs],
             "file": fn,
             "failures": [[f.scenario, f.stage, f.reason, f.attempts]
                          for f in fails]}
    with open(os.path.join(path, "manifest.jsonl"), "a") as f:
        f.write(json.dumps(entry) + "\n")
        f.flush()
        os.fsync(f.fileno())


class FleetRunner:
    """Persistent bucketed fleet executor (see module docstring), on its
    device (default: the CUDA card; raises without one unless
    ``device="cpu"``) and, with ``shard``, on a list of devices.

    Caches, all per instance: the host staging buffers per (bucket shape,
    members, rows), the device-resident pack per staging key, the bucket
    plan per (fleet shape multiset, policy), and on a card the campaign's
    streams and a CUDA graph per chunk signature. ``fused=True`` runs all
    buckets in one host tick loop, ``fused=False`` one loop per bucket (the
    per-bucket oracle). ``last_stats`` reports the tick loops run
    (``n_dispatches``), the bucket structure and padded row counts of the
    latest run."""

    # staging entries kept before the oldest are evicted
    MAX_STAGED = 32

    def __init__(self, max_buckets: int = 4, fused: bool = True,
                 tick_overhead: float | None = None,
                 fingerprint: str = "content",
                 device: "str | torch.device | None" = None):
        if fingerprint not in ("content", "identity", "off"):
            raise ValueError(f"fingerprint must be 'content', 'identity' or "
                             f"'off', got {fingerprint!r}")
        self.device = resolve_device(device)
        self.max_buckets = int(max_buckets)
        self.fused = bool(fused)
        self.tick_overhead = (calibrate_backend(self.device).tick_overhead_flops
                              if tick_overhead is None
                              else float(tick_overhead))
        # staging-reuse fingerprint: "content" = object identity + crc32
        # over every field's bytes; "identity" = object identity only (the
        # caller guarantees no in-place mutation); "off" = restage every
        # call (the campaign path always stages fresh and never hashes)
        self.fingerprint = fingerprint
        self._staging: dict[tuple, dict[str, np.ndarray]] = {}
        self._stacked: dict[tuple, dict[str, np.ndarray]] = {}
        self._device: dict[tuple, dict[str, torch.Tensor]] = {}
        self._filled: dict[tuple, tuple[list, list]] = {}
        self._plan_cache: dict[tuple, list[tuple[list[int], FleetShape]]] = {}
        # campaign staging slots: (shape, rows, phase) -> buffers
        self._campaign_bufs: dict[tuple, dict[str, np.ndarray]] = {}
        # campaign streams on a card: (device, stream slot) -> (copy
        # stream, compute stream), kept so that the graphs of a slot's
        # chunks replay across calls
        self._cuda_streams: dict[tuple, tuple] = {}
        # a campaign chunk's whole tick loop as one CUDA graph, per
        # signature (repro_torch.streams.graphs)
        self._graphs = BucketGraphs()
        self.last_stats: dict = {}

    # ---------------------------------------------------------- planning
    def plan(self, sims: Sequence[CompiledSim],
             policy: str = "tcp") -> list[tuple[list[int], FleetShape]]:
        """Bucket assignment for a fleet: list of (scenario indices, padded
        bucket shape), cached per (shape multiset, policy)."""
        key = (tuple(dataclasses.astuple(_sim_shape(s)) for s in sims),
               policy)
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = _plan_buckets(sims, self.max_buckets,
                                 exact_apps=(policy == "appfair"),
                                 policy=policy,
                                 tick_overhead=self.tick_overhead)
            self._plan_cache[key] = plan
        return plan

    # ----------------------------------------------------------- staging
    @staticmethod
    def _fill_bucket(bufs: dict[str, np.ndarray], sims: list[CompiledSim],
                     shape: FleetShape, rows: int,
                     pinned: bool = False) -> dict[str, np.ndarray]:
        """Reset + slice-assign ``sims`` into (re)allocated ``rows``-row
        host buffers (one per ``_FIELD_SPECS`` field). Spare rows keep
        their pad values — inert scenarios. The route-bank family is packed
        inside a ``pack_routes`` span."""
        dims = {"F": shape.n_flows, "L": shape.n_links,
                "I": shape.n_insts, "S": shape.n_sins, "E": shape.n_events,
                "SR": shape.n_route_states}
        hosts = [{f: _host(getattr(s, f)) for f in _FIELD_SPECS}
                 for s in sims]

        def fill(field):
            axes, pad = _FIELD_SPECS[field]
            first = hosts[0][field]
            full = (rows,) + tuple(dims[a] for a in axes)
            buf = bufs.get(field)
            if buf is None or buf.shape != full or buf.dtype != first.dtype:
                buf = _alloc(full, first.dtype, pinned)
                bufs[field] = buf
            for b, h in enumerate(hosts):
                a = h[field]
                if a.shape != full[1:]:
                    buf[b].fill(pad)
                buf[(b, *map(lambda n: slice(0, n), a.shape))] = a
            buf[len(hosts):].fill(pad)

        for field in _FIELD_SPECS:
            if field not in _ROUTE_FIELDS:
                fill(field)
        with tracing.span("pack_routes", rows=rows):
            for field in _ROUTE_FIELDS:
                fill(field)
            if shape.n_route_states > 0:
                # static-routing members of a rerouting bucket: their
                # per-tick state lookup clamps to slot 0, which must hold
                # their base R
                bank = bufs["route_bank"]
                for b, (s, h) in enumerate(zip(sims, hosts)):
                    if s.route_bank.shape[0] == 0:
                        a = h["R"]
                        bank[b, 0, :a.shape[0], :a.shape[1]] = a
        return {field: bufs[field] for field in _FIELD_SPECS}

    def _stack_bucket(self, sims: list[CompiledSim], shape: FleetShape,
                      idxs: list[int], rows: int):
        """Stack a bucket into this runner's staging buffers of ``rows``
        rows. When the bucket holds the same scenario objects with the same
        field bytes as the previous call, the filled buffers are reused
        outright. Returns (host pack, staging key, freshly staged)."""
        B = len(sims)
        key = (dataclasses.astuple(shape), tuple(idxs), rows)
        entry = self._filled.get(key) if self.fingerprint != "off" else None
        if entry is not None:
            refs, sigs = entry
            if len(refs) == B and all(
                    r() is s for r, s in zip(refs, sims)) and (
                    self.fingerprint == "identity" or all(
                        g == _sim_content_sig(s)
                        for g, s in zip(sigs, sims))):
                self._staging[key] = self._staging.pop(key)  # LRU touch
                return self._stacked[key], key, False
        # bounded cache: drop the oldest staged buckets (and any whose sims
        # were garbage-collected) before staging a new one
        dead = [k for k, (rs, _) in self._filled.items()
                if any(r() is None for r in rs)]
        evict = dead + [k for k in self._staging
                        if k not in dead][:max(
                            0, len(self._staging) - len(dead)
                            - self.MAX_STAGED + 1)]
        for k in evict:
            if k != key:
                self._staging.pop(k, None)
                self._stacked.pop(k, None)
                self._filled.pop(k, None)
        # restaging rewrites the buffers: this key's device pack (and any
        # evicted key's) is stale
        for dk in [d for d in self._device
                   if d[0] == key or d[0] in evict]:
            self._device.pop(dk, None)
        bufs = self._staging.setdefault(key, {})
        stacked = self._fill_bucket(bufs, sims, shape, rows)
        self._stacked[key] = stacked
        self._filled[key] = ([weakref.ref(s) for s in sims],
                             [_sim_content_sig(s) for s in sims]
                             if self.fingerprint == "content" else
                             [None] * len(sims))
        return stacked, key, True

    @staticmethod
    def _gates(chunk, idxs, shape, rows, x_fixed):
        """The bucket's [rows, F] fixed-rate matrix (or None) and [rows]
        enforcement gate: scheduled scenarios enforce caps(t) per tick;
        static (and inert spare) rows keep exact static semantics."""
        xf = None
        if x_fixed is not None:
            xf = np.zeros((rows, shape.n_flows), np.float32)
            for b, i in enumerate(idxs):
                v = _host(x_fixed[i]).astype(np.float32)
                xf[b, :len(v)] = v
        enf = np.zeros(rows, bool)
        for b, sim in enumerate(chunk):
            enf[b] = sim.is_dynamic
        return xf, enf

    # ------------------------------------------------------------ devices
    def _shard_devices(self, shard) -> list[torch.device]:
        """The devices ``shard`` names: ``False`` this runner's device;
        ``True`` every visible device of its type (each card on "cuda", the
        one CPU device on "cpu"); or a sequence of devices of its type, one
        per entry, repeats included. A device that does not exist
        raises."""
        if shard is False:
            return [_indexed(self.device)]
        if shard is True:
            if self.device.type == "cuda":
                return [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
            return [_indexed(self.device)]
        devs = [_indexed(resolve_device(d)) for d in shard]
        if not devs:
            raise ValueError("shard names no device")
        for d in devs:
            if d.type != self.device.type:
                raise ValueError(f"shard device {d} is not of this runner's "
                                 f"type {self.device.type!r}")
            n = torch.cuda.device_count() if d.type == "cuda" else 1
            if d.index is not None and d.index >= n:
                raise ValueError(f"no device {d}: {n} visible")
        return devs

    # ------------------------------------------------------------ running
    def run(
        self,
        sims: Sequence[CompiledSim],
        policy: str = "tcp",
        seconds: float = 600.0,
        dt: float = 0.5,
        upd_every: int | None = None,
        x_fixed: Sequence[np.ndarray] | None = None,
        alpha: float = 0.5,
        n_groups: int = 8,
        qcap: float = 8.0,
        solver: str = "sort",
        shard: "bool | Sequence[str | torch.device]" = True,
        t_event: float = 0.0,
    ) -> list[SimResult]:
        """Run the whole fleet; one :class:`SimResult` per scenario (input
        order), each sliced back to its true shapes — element-wise equal
        to ``simulate(sims[b], ...)`` within float32 re-association, for
        every policy (appfair buckets by exact app count).

        With several devices (``shard``, :meth:`_shard_devices`) each bucket's
        rows are padded with inert scenarios up to a multiple of the device
        count and cut into one contiguous piece per device; each piece runs
        its own tick loop on its device (all in the one host loop when
        ``fused``), and the rows come back in input order. A scenario's
        trajectories do not depend on the piece it rides in."""
        if not sims:
            raise ValueError("empty fleet")
        sims = list(sims)
        if x_fixed is not None and len(x_fixed) != len(sims):
            raise ValueError("x_fixed must give one rate vector per scenario")
        n_ticks = int(round(smoke_seconds(seconds) / dt))
        upd_every = resolve_upd_every(policy, dt, upd_every)
        devs = self._shard_devices(shard)
        n_dev = len(devs)

        plan = self.plan(sims, policy)
        row_counts = [_round_rows(len(idxs), n_dev) for idxs, _ in plan]
        loops = []
        for (idxs, shape), rows in zip(plan, row_counts):
            chunk = [sims[i] for i in idxs]
            stacked, skey, _ = self._stack_bucket(chunk, shape, idxs, rows)
            # rebuilt per call on purpose: the staging fingerprint covers
            # the scenarios, not the x_fixed values
            xf, enf = self._gates(chunk, idxs, shape, rows, x_fixed)
            per = rows // n_dev
            for d, dev in enumerate(devs):
                part = slice(d * per, (d + 1) * per)
                # device-resident pack of the piece: copied once per
                # staging, re-passed verbatim on warm calls (restaging
                # purges it)
                dkey = (skey, d, n_dev)
                pack = self._device.get(dkey)
                if pack is None:
                    pack = {f: torch.tensor(a[part], device=dev)
                            for f, a in stacked.items()}
                    self._device[dkey] = pack
                loops.append(self._bucket_loop(
                    pack, shape, None if xf is None else xf[part], enf[part],
                    policy, n_ticks, dt, upd_every, alpha, n_groups, qcap,
                    solver, t_event, dev))
        outs = _drive(loops) if self.fused else [_drive([g])[0]
                                                  for g in loops]

        self.last_stats = {
            "n_dispatches": 1 if self.fused else len(loops),
            "n_buckets": len(plan),
            "n_scenarios": len(sims),
            "n_shards": n_dev,
            "devices": [str(d) for d in devs],
            "rows": row_counts,
            "bucket_shapes": [dataclasses.astuple(s) for _, s in plan],
            "policy": policy,
        }
        out: list[SimResult | None] = [None] * len(sims)
        total_rebuilds = 0
        for bi, (idxs, _) in enumerate(plan):
            pieces = outs[bi * n_dev:(bi + 1) * n_dev]
            host = [np.concatenate([p[k].cpu().numpy() for p in pieces])
                    for k in range(len(pieces[0]))]
            for b, i in enumerate(idxs):
                out[i] = result_from_padded_row(sims[i], b, dt, *host)
                total_rebuilds += int(host[4][b].sum())
        self.last_stats["order_rebuilds"] = total_rebuilds
        return out  # type: ignore[return-value]

    @staticmethod
    def _bucket_loop(pack, shape, xf, enf, policy, n_ticks, dt, upd_every,
                     alpha, n_groups, qcap, solver, t_event, dev):
        """A bucket's (or a piece's) tick loop as a generator (one step per
        tick; the device outputs are its return value), on ``dev``."""
        return _run_bucket(
            pack, shape.n_apps, policy, n_ticks, dt, upd_every,
            x_fixed=None if xf is None else torch.as_tensor(xf, device=dev),
            alpha=alpha, n_groups=n_groups, qcap=qcap, solver=solver,
            enforce=torch.as_tensor(enf, device=dev), with_metrics=True,
            t_event=float(t_event), stepwise=True)

    # ---------------------------------------------------------- campaigns
    def run_campaign(
        self,
        sims: Sequence[CompiledSim],
        policy: str = "tcp",
        seconds: float = 600.0,
        dt: float = 0.5,
        upd_every: int | None = None,
        x_fixed: Sequence[np.ndarray] | None = None,
        alpha: float = 0.5,
        n_groups: int = 8,
        qcap: float = 8.0,
        solver: str = "sort",
        shard: "bool | Sequence[str | torch.device]" = True,
        t_event: float = 0.0,
        chunk_rows: int | str = 64,
        retain_trajectories: bool = False,
        faults: FaultPlan | None = None,
        max_retries: int = 3,
        retry_backoff_s: float = 0.05,
        retry_backoff_cap_s: float = 1.0,
        transfer_timeout_s: float | None = 60.0,
        checkpoint: str | os.PathLike | None = None,
        finite_check: bool = True,
    ) -> CampaignResult:
        """Streaming campaign: run an arbitrarily large fleet in chunks of
        one padded row count per bucket, with bounded host and device
        memory (see the module docstring). ``chunk_rows="auto"`` sizes
        chunks per bucket from :func:`calibrate_backend`.

        Pipeline: host pack into three rotating host slots → H2D copy on a
        worker thread (a dedicated copy stream on the card) → compute (the
        bucket's tick loop) → collect the ``[rows, n_metrics]`` slab. A
        slot is refilled only after its occupant's chunk was collected.

        Resilience (host side; a fault-free campaign runs exactly the same
        launches): a chunk whose pack, transfer or dispatch raises, or
        whose transfer exceeds ``transfer_timeout_s``, is retried
        synchronously with capped exponential backoff; a chunk that
        exhausts its retries, or whose slab holds non-finite values
        (``finite_check``; +inf in the recovery column is legitimate), is
        bisected down to single scenarios, which are quarantined (all-NaN
        rows, a :class:`FailureRecord` each). Every re-run uses the
        bucket's own row count, so a scenario's row does not depend on the
        sub-chunk it rides in. ``checkpoint=dir`` appends each collected
        chunk's slab; a re-run with the same fingerprint restores completed
        chunks bitwise without running them. On any error (including
        :class:`~repro_torch.streams.faults.FaultAbort`) the pipeline tears
        down and ``last_stats`` reports ``{"status": "failed", ...}``.

        ``shard`` (:meth:`_shard_devices`) streams the chunks over
        ``n_streams = min(devices, chunks)`` streams: chunk ``j`` runs on
        stream ``j % n_streams``, each stream with its own three host slots,
        its own copy stream and, on a card, its own compute stream, under
        which every launch of its chunks (the waterfill kernel's too) runs.
        Chunking, retries, bisection, quarantine and the checkpoint's
        fingerprint do not depend on the device count, so a campaign's
        metric rows are the same bits on any number of streams, and a
        checkpoint written with one stream resumes a run with four.

        On a card a chunk's whole tick loop is one CUDA graph, captured once
        per signature and replayed for every later chunk with it, on this
        runner's graphs (:class:`~repro_torch.streams.graphs.BucketGraphs`;
        the first chunk on a card runs eager); its rows are the eager
        loop's, bit for bit. The graphs are dropped when a campaign fails.

        The call records host spans (:mod:`repro_torch.tracing`) while
        recording is on: ``campaign``; ``plan``; per chunk ``stage`` (inside
        it ``pack_routes``, the route-bank family's packing), ``transfer``
        (on the copy worker), ``transfer_wait``, ``dispatch`` (inside it the
        tick loop's spans, or ``capture`` and ``replay``) and ``collect``;
        ``recover``. ``last_stats``' ``stage_s``,
        ``transfer_s``, ``transfer_wait_s``, ``dispatch_s`` and ``block_s``
        are the sums of those spans' own clock readings, whether recording
        is on or off; ``n_ticks`` and ``n_updates`` count the bucket ticks
        and controller updates the tick loops ran, retries included, by
        replay or eager; ``route_bank_bytes`` counts the route-bank bytes
        staged for the card (padding included, retries too), and
        ``route_gather_bytes`` the routing-matrix bytes the tick loops gather
        (rows × F × L × 4 for every tick of a rerouting chunk, by replay or
        eager); ``n_graph_captures``, ``n_graph_replays`` and
        ``n_graph_fallbacks`` (captures that raised, whose signature then
        runs eager) count the graph work, and ``graph_tick_share`` is the
        share of ``n_ticks`` that ran by replay."""
        with tracing.timed("campaign", scenarios=len(sims)) as whole:
            return self._campaign(
                whole, sims, policy, seconds, dt, upd_every, x_fixed, alpha,
                n_groups, qcap, solver, shard, t_event, chunk_rows,
                retain_trajectories, faults, max_retries, retry_backoff_s,
                retry_backoff_cap_s, transfer_timeout_s, checkpoint,
                finite_check)

    def _campaign(self, whole, sims, policy, seconds, dt, upd_every, x_fixed,
                  alpha, n_groups, qcap, solver, shard, t_event, chunk_rows,
                  retain_trajectories, faults, max_retries, retry_backoff_s,
                  retry_backoff_cap_s, transfer_timeout_s, checkpoint,
                  finite_check) -> CampaignResult:
        """:meth:`run_campaign`'s body, inside its ``campaign`` span
        ``whole``, which it stops to read the wall time."""
        if not sims:
            raise ValueError("empty campaign")
        auto_chunk = chunk_rows == "auto"
        if isinstance(chunk_rows, str) and not auto_chunk:
            raise ValueError(f"chunk_rows must be an int or 'auto', "
                             f"got {chunk_rows!r}")
        if not auto_chunk and chunk_rows < 1:
            raise ValueError("chunk_rows must be >= 1")
        sims = list(sims)
        if x_fixed is not None and len(x_fixed) != len(sims):
            raise ValueError("x_fixed must give one rate vector per scenario")
        if checkpoint is not None and retain_trajectories:
            raise ValueError(
                "checkpoint + retain_trajectories is unsupported: resumed "
                "chunks restore metric slabs only, never trajectories")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        n_ticks = int(round(smoke_seconds(seconds) / dt))
        upd_every = resolve_upd_every(policy, dt, upd_every)
        dev = self.device
        cuda = dev.type == "cuda"
        with tracing.span("plan"):
            calib = calibrate_backend(dev)
            plan = self.plan(sims, policy)
            # one padded row count per bucket, chunks balanced within it:
            # ceil(members / target) near-equal chunks sharing one quantized
            # row count, so inert waste is bounded by the quantum
            jobs: list[tuple[int, list[int]]] = []  # (bucket, member idxs)
            cap_rows: list[int] = []
            target_rows: list[int] = []
            for bi, (idxs, shape) in enumerate(plan):
                target = (_auto_chunk_rows(shape, policy, n_ticks, calib)
                          if auto_chunk else int(chunk_rows))
                target_rows.append(target)
                n_chunks_b = -(-len(idxs) // max(target, 1))
                per = -(-len(idxs) // n_chunks_b)
                cap_rows.append(_round_rows(per, 1))
                jobs.extend((bi, idxs[lo:lo + per])
                            for lo in range(0, len(idxs), per))
        base_key = (policy, n_ticks, dt, upd_every, alpha, n_groups, solver,
                    1, x_fixed is not None, float(t_event))
        # the chunk stream round-robin over the devices: chunk j on stream
        # j % n_streams
        devs = self._shard_devices(shard)
        n_streams = max(1, min(len(devs), len(jobs)))
        devs = devs[:n_streams]
        for s, d in enumerate(devs if cuda else ()):
            if (d, s) not in self._cuda_streams:
                self._cuda_streams[d, s] = (torch.cuda.Stream(d),
                                            torch.cuda.Stream(d))
        copy_streams, compute_streams = (
            zip(*(self._cuda_streams[d, s] for s, d in enumerate(devs)))
            if cuda else ([None] * n_streams, [None] * n_streams))

        def on_stream(s):
            """Stream ``s``'s device and compute stream current (on a
            card): its chunks' launches, and the copies that read their
            outputs, queue there."""
            if not cuda:
                return contextlib.nullcontext()
            stack = contextlib.ExitStack()
            stack.enter_context(torch.cuda.device(devs[s]))
            stack.enter_context(torch.cuda.stream(compute_streams[s]))
            return stack

        ticks_run = updates_run = 0
        # bytes of route bank staged for the card (padding included), and
        # of routing matrix the tick loops gather, one [rows, F, L] a tick
        # of a rerouting chunk, eager or replayed alike
        bank_bytes = gather_bytes = 0
        graphs = self._graphs
        graphs0 = (graphs.captures, graphs.replays, graphs.fallbacks)

        def compute(bi, pack, xf, enf):
            nonlocal ticks_run, updates_run, gather_bytes
            outs = graphs.run(
                pack, plan[bi][1].n_apps, policy, n_ticks, dt, upd_every,
                x_fixed=xf, alpha=alpha, n_groups=n_groups, qcap=qcap,
                solver=solver, enforce=enf, with_metrics=True,
                t_event=float(t_event))
            ticks_run += n_ticks
            updates_run += -(-n_ticks // upd_every)
            bank = pack["route_bank"]
            if bank.shape[1]:
                gather_bytes += (n_ticks * bank[:, 0].numel()
                                 * bank.element_size())
            return outs

        def staged(leaves):
            nonlocal bank_bytes
            bank_bytes += leaves["route_bank"].nbytes

        n_metrics = len(CAMPAIGN_METRICS)
        metrics_all = np.empty((len(sims), n_metrics), np.float32)
        results: list[SimResult | None] | None = (
            [None] * len(sims) if retain_trajectories else None)
        stage_s = dispatch_s = block_s = 0.0
        transfer_s = transfer_wait_s = 0.0
        hidden_stage_s = hideable_stage_s = 0.0
        peak_rows = peak_bytes = 0
        # per-stream pipeline state: at most ONE submitted-but-undispatched
        # transfer (`pending`), at most two dispatched-but-uncollected
        # chunks (`inflight`), and a staged-chunk counter driving the
        # stream's slot phase
        pending: list = [None] * n_streams
        inflight: list[list] = [[] for _ in range(n_streams)]
        staged_n = [0] * n_streams

        # ---- resilience state (inert on the fault-free path) ----
        failures: list[FailureRecord] = []
        n_retries = n_recovered = n_dispatched = 0
        chunks_done = 0
        rec_col = metric_index("recovery_time_s")

        # ---- checkpoint/resume ----
        ckpt_dir = ckpt_fp = None
        done_jobs: dict[int, tuple[np.ndarray, list[FailureRecord]]] = {}
        if checkpoint is not None:
            ckpt_dir = os.fspath(checkpoint)
            os.makedirs(ckpt_dir, exist_ok=True)
            ckpt_fp = _campaign_fingerprint(
                sims, jobs, cap_rows, plan, base_key, qcap, x_fixed)
            done_jobs = _checkpoint_load(ckpt_dir, ckpt_fp, jobs, n_metrics)
            for j, (slab, fails) in done_jobs.items():
                for b, i in enumerate(jobs[j][1]):
                    metrics_all[i] = slab[b]  # np.save/load f32: bitwise
                failures.extend(fails)
        n_resumed = len(done_jobs)

        def _fire(stage, j):
            if faults is not None:
                faults.fire(stage, j)

        def _slab_rows_ok(m):
            # [n, n_metrics] -> [n] bool. NaN is poison everywhere; +inf
            # is poison everywhere EXCEPT the recovery column ("never
            # recovered within the horizon")
            ok = np.isfinite(m)
            ok[:, rec_col] = ~np.isnan(m[:, rec_col])
            return ok.all(axis=1)

        def _chunk_complete(j, idxs):
            nonlocal chunks_done
            chunks_done += 1
            if ckpt_fp is not None:
                idx_set = set(idxs)
                fl = [f for f in failures if f.scenario in idx_set]
                _checkpoint_append(ckpt_dir, ckpt_fp, j, idxs,
                                   metrics_all[list(idxs)].copy(), fl)

        def _to_device(host, s):
            """Host (leaves, xf, enf) -> tensors on stream ``s``'s device
            and the event that marks their arrival. On the card the copies
            run on the stream's copy stream from pinned slots; on the CPU
            they alias the slots."""
            leaves, xf, enf = host
            if not cuda:
                return ({k: torch.from_numpy(v) for k, v in leaves.items()},
                        None if xf is None else torch.from_numpy(xf),
                        torch.from_numpy(enf), None)
            d, cs = devs[s], copy_streams[s]
            with torch.cuda.device(d), torch.cuda.stream(cs):
                pack = {k: torch.from_numpy(v).to(d, non_blocking=True)
                        for k, v in leaves.items()}
                xfd = (None if xf is None else
                       torch.from_numpy(xf).to(d, non_blocking=True))
                enfd = torch.from_numpy(enf).to(d, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(cs)
            return pack, xfd, enfd, ev

        def _h2d(host, j, s, parent):
            # transfer worker: returns once the bytes landed (so a resolved
            # future means a finished copy, and the watchdog sees a hung
            # one). On the CPU the "copy" aliases the host slot, which the
            # slot rotation below guards. ``parent``: the span that handed
            # the copy over, on the campaign's thread
            with tracing.timed("transfer", parent=parent, chunk=j) as tr:
                _fire("transfer", j)
                out = _to_device(host, s)
                if out[3] is not None:
                    out[3].synchronize()
            return out, tr.seconds

        def _on_compute_stream(pack, xf, enf, ev):
            """Order the current (compute) stream after the copy and keep
            the copied blocks from being reused by the copy stream while
            compute still reads them."""
            if ev is None:
                return
            cur = torch.cuda.current_stream()
            cur.wait_event(ev)
            for t in (*pack.values(), xf, enf):
                if t is not None:
                    t.record_stream(cur)

        def _collect_oldest(s):
            nonlocal block_s
            j, bi, idxs, chunk, outs = inflight[s].pop(0)
            bad = err = None
            with tracing.timed("collect", chunk=j) as col:
                # block ONLY on the [rows, n_metrics] epilogue slab; the
                # [T, ...] trajectories stay on the device and free with
                # `outs`
                try:
                    with on_stream(s):
                        m = outs[6].cpu().numpy()
                except Exception as e:  # noqa: BLE001 — route to recovery
                    err = e
                if err is None:
                    if faults is not None and faults.poison:
                        m = np.array(m)  # a copy: may alias device memory
                        m[:len(idxs)][faults.poison_mask(idxs)] = np.nan
                    if finite_check:
                        ok = _slab_rows_ok(m[:len(idxs)])
                        if not ok.all():
                            bad = ~ok
                    for b, i in enumerate(idxs):
                        if bad is None or not bad[b]:
                            metrics_all[i] = m[b]
                    if results is not None:
                        with on_stream(s):
                            host = [o.cpu().numpy() for o in outs[:6]]
                        for b, i in enumerate(idxs):
                            if bad is None or not bad[b]:
                                results[i] = result_from_padded_row(
                                    chunk[b], b, dt, *host, m)
            block_s += col.seconds
            if err is not None:
                _recover_chunk(bi, j, idxs, chunk, err)
                return
            if bad is not None:
                # non-finite rows: the good rows above are final (rows are
                # independent); bisect only the poisoned ones
                with tracing.span("recover", chunk=j):
                    _bisect(bi, j,
                            [i for b, i in enumerate(idxs) if bad[b]],
                            [c for b, c in enumerate(chunk) if bad[b]])
            _chunk_complete(j, idxs)

        def _dispatch(s):
            nonlocal dispatch_s, transfer_s, transfer_wait_s, n_dispatched
            bi, j, idxs, chunk, fut = pending[s]
            pending[s] = None
            err = None
            timed_out = False
            with tracing.timed("transfer_wait", chunk=j) as wait:
                try:
                    (pack, xf, enf, ev), t_copy = (
                        fut.result() if transfer_timeout_s is None
                        else fut.result(timeout=transfer_timeout_s))
                except FuturesTimeoutError:
                    timed_out = True
                except (Exception, FuturesCancelledError) as e:  # noqa: BLE001
                    # CancelledError here only means "the watchdog replaced
                    # the executor while this copy was queued" — recoverable
                    err = e
            transfer_wait_s += wait.seconds
            if timed_out:
                # hung transfer: abandon the whole executor (the hung
                # thread leaks until it returns; its result is dropped
                # unread), rebuild it, and re-run the chunk synchronously
                _replace_executor()
                err = TimeoutError(f"H2D transfer of chunk {j} exceeded "
                                   f"{transfer_timeout_s}s")
            if err is not None:
                _recover_chunk(bi, j, idxs, chunk, err)
                return
            transfer_s += t_copy
            with tracing.timed("dispatch", chunk=j, bucket=bi) as disp:
                try:
                    _fire("dispatch", j)
                    with on_stream(s):
                        _on_compute_stream(pack, xf, enf, ev)
                        outs = compute(bi, pack, xf, enf)
                except Exception as e:  # noqa: BLE001 — route to recovery
                    err = e
            dispatch_s += disp.seconds
            if err is not None:
                _recover_chunk(bi, j, idxs, chunk, err)
                return
            n_dispatched += 1
            inflight[s].append((j, bi, idxs, chunk, outs))
            if len(inflight[s]) > 1:
                _collect_oldest(s)

        # ---- recovery: synchronous retry / bisect / quarantine ----
        def _replace_executor():
            ex_holder[0].shutdown(wait=False, cancel_futures=True)
            ex_holder[0] = ThreadPoolExecutor(max_workers=n_streams,
                                              thread_name_prefix="h2d")

        def _stage_of(err):
            if isinstance(err, InjectedFault):
                return err.stage
            if isinstance(err, (TimeoutError, FuturesTimeoutError)):
                return "transfer"
            return "run"

        def _run_subset_once(bi, j, idxs, chunk):
            """One synchronous pack→transfer→compute→collect of a chunk
            subset, staged into FRESH scratch buffers — never the rotating
            slots, which an in-flight (or abandoned) transfer may alias."""
            nonlocal n_dispatched
            s = j % n_streams
            shape, rows = plan[bi][1], cap_rows[bi]
            _fire("pack", j)
            leaves = self._fill_bucket({}, chunk, shape, rows)
            staged(leaves)
            xf, enf = self._gates(chunk, idxs, shape, rows, x_fixed)
            _fire("transfer", j)
            pack, xfd, enfd, ev = _to_device((leaves, xf, enf), s)
            _fire("dispatch", j)
            with on_stream(s):
                _on_compute_stream(pack, xfd, enfd, ev)
                outs = compute(bi, pack, xfd, enfd)
                n_dispatched += 1
                m = np.array(outs[6].cpu().numpy()[:len(idxs)])
                host = ([o.cpu().numpy() for o in outs[:6]]
                        if results is not None else None)
            if faults is not None and faults.poison:
                m[faults.poison_mask(idxs)] = np.nan
            return m, host

        def _try_subset(bi, j, idxs, chunk):
            """Run a subset with capped-exponential-backoff retries.
            Returns (m, host, err, attempts); err is the last exception
            when every attempt failed."""
            nonlocal n_retries
            err = None
            for attempt in range(max_retries + 1):
                if attempt:
                    n_retries += 1
                    time.sleep(min(retry_backoff_s * 2.0 ** (attempt - 1),
                                   retry_backoff_cap_s))
                try:
                    m, host = _run_subset_once(bi, j, idxs, chunk)
                    return m, host, None, attempt + 1
                except Exception as e:  # noqa: BLE001 — retried
                    err = e
            return None, None, err, max_retries + 1

        def _accept_rows(idxs, chunk, m, host, ok=None):
            for b, i in enumerate(idxs):
                if ok is None or ok[b]:
                    metrics_all[i] = m[b]
                    if results is not None and host is not None:
                        results[i] = result_from_padded_row(
                            chunk[b], b, dt, *host, m)

        def _quarantine(i, stage, reason, attempts):
            metrics_all[i] = np.nan
            if results is not None:
                results[i] = None
            failures.append(FailureRecord(scenario=int(i), stage=stage,
                                          reason=reason, attempts=attempts))

        def _bisect(bi, j, idxs, chunk):
            """Isolate poisoned scenarios: run halves (with retries);
            surviving rows are accepted, failing halves recurse down to
            single scenarios, which are quarantined."""
            if not idxs:
                return
            if len(idxs) == 1:
                m, host, err, attempts = _try_subset(bi, j, idxs, chunk)
                if err is not None:
                    _quarantine(idxs[0], _stage_of(err), repr(err), attempts)
                elif finite_check and not _slab_rows_ok(m)[0]:
                    _quarantine(idxs[0], "non_finite",
                                "non-finite values in metric epilogue row",
                                attempts)
                else:
                    _accept_rows(idxs, chunk, m, host)
                return
            mid = (len(idxs) + 1) // 2
            for lo, hi in ((0, mid), (mid, len(idxs))):
                sub_i, sub_c = idxs[lo:hi], chunk[lo:hi]
                m, host, err, _ = _try_subset(bi, j, sub_i, sub_c)
                if err is not None:
                    _bisect(bi, j, sub_i, sub_c)
                    continue
                ok = (_slab_rows_ok(m) if finite_check
                      else np.ones(len(sub_i), bool))
                _accept_rows(sub_i, sub_c, m, host, ok)
                if not ok.all():
                    _bisect(bi, j,
                            [i for b, i in enumerate(sub_i) if not ok[b]],
                            [c for b, c in enumerate(sub_c) if not ok[b]])

        def _recover_chunk(bi, j, idxs, chunk, first_error):
            """Chunk-level failure path: whole-chunk retries with backoff;
            retries exhausted (or surviving non-finite rows) bisect down to
            the scenarios responsible. Never raises."""
            nonlocal n_recovered
            n_recovered += 1
            with tracing.span("recover", chunk=j):
                m, host, err, _ = _try_subset(bi, j, idxs, chunk)
                if err is not None:
                    _bisect(bi, j, idxs, chunk)
                else:
                    ok = (_slab_rows_ok(m) if finite_check
                          else np.ones(len(idxs), bool))
                    _accept_rows(idxs, chunk, m, host, ok)
                    if not ok.all():
                        _bisect(bi, j,
                                [i for b, i in enumerate(idxs) if not ok[b]],
                                [c for b, c in enumerate(chunk) if not ok[b]])
            _chunk_complete(j, idxs)

        # manual executor lifecycle: the transfer watchdog may abandon a
        # wedged executor mid-run, and the teardown must cancel whichever
        # executor is current at failure time
        ex_holder = [ThreadPoolExecutor(max_workers=n_streams,
                                        thread_name_prefix="h2d")]
        status = "failed"
        error_repr = None
        try:
            for j, (bi, idxs) in enumerate(jobs):
                if j in done_jobs:
                    continue  # restored bitwise from the checkpoint
                _fire("abort", j)
                s = j % n_streams
                # compute first: if the stream's previous chunk's bytes
                # already landed, run it before packing the next chunk
                if pending[s] is not None and pending[s][4].done():
                    _dispatch(s)
                shape, rows = plan[bi][1], cap_rows[bi]
                shape_t = dataclasses.astuple(shape)
                chunk = [sims[i] for i in idxs]
                err = None
                with tracing.timed("stage", chunk=j, bucket=bi,
                                   rows=rows) as st:
                    try:
                        _fire("pack", j)
                        # THREE slot phases per stream, one per pipeline
                        # stage: a slot may be refilled only once its
                        # previous occupant was *collected* (on the CPU the
                        # device pack aliases the slot). A stream's
                        # pipeline lags its staging by at most two chunks
                        # (one pending transfer plus one uncollected
                        # dispatch), so phase c % 3 of its c-th chunk —
                        # last filled for its chunk c - 3, collected during
                        # its chunk c - 2's dispatch — is idle. The
                        # stream's slots of any other shape are dropped (an
                        # in-flight transfer keeps its arrays alive).
                        for k in [k for k in self._campaign_bufs
                                  if k[0] == s and k[1:3] != (shape_t, rows)]:
                            del self._campaign_bufs[k]
                        bufs = self._campaign_bufs.setdefault(
                            (s, shape_t, rows, staged_n[s] % 3), {})
                        leaves = self._fill_bucket(bufs, chunk, shape, rows,
                                                   pinned=cuda)
                        staged(leaves)
                        xf, enf = self._gates(chunk, idxs, shape, rows,
                                              x_fixed)
                    except Exception as e:  # noqa: BLE001 — to recovery
                        err = e
                stage_s += st.seconds
                if err is not None:
                    # nothing was submitted and the phase counter stays
                    # put; the chunk re-runs on scratch buffers
                    _recover_chunk(bi, j, idxs, chunk, err)
                    continue
                staged_n[s] += 1
                # staging is *hidden* when compute is in flight, and
                # *hideable* unless the pipeline had nothing to run yet
                if any(inflight):
                    hidden_stage_s += st.seconds
                if any(inflight) or any(p is not None for p in pending):
                    hideable_stage_s += st.seconds
                peak_bytes = max(peak_bytes, sum(
                    b.nbytes for slot in self._campaign_bufs.values()
                    for b in slot.values()))
                peak_rows = max(peak_rows,
                                sum(k[2] for k in self._campaign_bufs))
                # single-entry prefetch per stream: dispatch the stream's
                # previous transfer's chunk before submitting the next copy
                if pending[s] is not None:
                    _dispatch(s)
                fut = ex_holder[0].submit(_h2d, (leaves, xf, enf), j, s,
                                          tracing.current())
                pending[s] = (bi, j, idxs, chunk, fut)
            # drain: dispatch each stream's prefetched chunk, then collect
            for s in range(n_streams):
                if pending[s] is not None:
                    _dispatch(s)
            for s in range(n_streams):
                while inflight[s]:
                    _collect_oldest(s)
            status = "ok"
        except BaseException as e:
            error_repr = repr(e)
            raise
        finally:
            # teardown on success AND on any failure (including injected
            # aborts): cancel the pending transfer, drop uncollected
            # chunks, write failure-aware stats
            for s in range(n_streams):
                if pending[s] is not None:
                    pending[s][4].cancel()
                    pending[s] = None
                inflight[s].clear()
            ex_holder[0].shutdown(wait=(status == "ok"),
                                  cancel_futures=True)
            # the recursive bisection closes over itself: unbind it, or the
            # cycle keeps every closure of this call, and through them the
            # runner with its pinned slots and graphs, until the cyclic
            # garbage collector happens to run
            del _bisect
            if status != "ok":
                self._campaign_bufs.clear()
                graphs.clear()
            whole.stop()
            n_capt, n_repl, n_fall = (
                graphs.captures - graphs0[0], graphs.replays - graphs0[1],
                graphs.fallbacks - graphs0[2])
            wall_s = whole.seconds
            self.last_stats = {
                "mode": "campaign",
                "status": status,
                "error": error_repr,
                "n_dispatches": n_dispatched,
                "n_chunks": len(jobs),
                "n_chunks_done": chunks_done,
                "n_chunks_resumed": n_resumed,
                "n_retries": n_retries,
                "n_recovered_chunks": n_recovered,
                "n_quarantined": len({f.scenario for f in failures}),
                "checkpoint": ckpt_dir,
                "fingerprint": ckpt_fp,
                "n_buckets": len(plan),
                "n_scenarios": len(sims),
                "n_streams": n_streams,
                "devices": [str(d) for d in devs],
                "rows": cap_rows,
                "chunk_rows": max(cap_rows),
                "target_chunk_rows": target_rows,
                "auto_chunk": auto_chunk,
                "bucket_shapes": [dataclasses.astuple(s) for _, s in plan],
                "policy": policy,
                "peak_staged_rows": peak_rows,
                "peak_staged_bytes": peak_bytes,
                "stage_s": stage_s,
                "dispatch_s": dispatch_s,
                "transfer_s": transfer_s,
                "transfer_wait_s": transfer_wait_s,
                "block_s": block_s,
                "n_ticks": ticks_run,
                "n_updates": updates_run,
                "route_bank_bytes": bank_bytes,
                "route_gather_bytes": gather_bytes,
                "n_graph_captures": n_capt,
                "n_graph_replays": n_repl,
                "n_graph_fallbacks": n_fall,
                "graph_tick_share": (n_repl * n_ticks / ticks_run
                                     if ticks_run else 0.0),
                "wall_s": wall_s,
                "overlap_fraction": (hidden_stage_s / hideable_stage_s
                                     if hideable_stage_s > 0 else 1.0),
                "transfer_overlap": (
                    max(0.0, 1.0 - transfer_wait_s / transfer_s)
                    if transfer_s > 0 else 0.0),
                "calibration": dataclasses.asdict(calib),
            }
        return CampaignResult(
            metrics=metrics_all,
            tuples_per_mb=np.asarray([s.tuples_per_mb for s in sims],
                                     np.float32),
            dt=dt,
            policy=policy,
            results=results,  # type: ignore[arg-type]
            failures=failures,
        )


def _drive(loops):
    """Run bucket tick-loop generators to completion, interleaved tick by
    tick (one host loop); returns each generator's return value."""
    outs = [None] * len(loops)
    live = list(enumerate(loops))
    while live:
        nxt = []
        for i, g in live:
            try:
                next(g)
                nxt.append((i, g))
            except StopIteration as stop:
                outs[i] = stop.value
        live = nxt
    return outs


_DEFAULT_RUNNERS: dict[torch.device, FleetRunner] = {}


def simulate_many(
    sims: Sequence[CompiledSim],
    policy: str = "tcp",
    seconds: float = 600.0,
    dt: float = 0.5,
    upd_every: int | None = None,
    x_fixed: Sequence[np.ndarray] | None = None,
    alpha: float = 0.5,
    n_groups: int = 8,
    qcap: float = 8.0,
    solver: str = "sort",
    shard: bool = True,
    device: "str | torch.device | None" = None,
) -> list[SimResult]:
    """:meth:`FleetRunner.run` through one module-level runner per device
    (default: the CUDA card)."""
    dev = resolve_device(device)
    runner = _DEFAULT_RUNNERS.get(dev)
    if runner is None:
        runner = _DEFAULT_RUNNERS[dev] = FleetRunner(device=dev)
    return runner.run(
        sims, policy=policy, seconds=seconds, dt=dt, upd_every=upd_every,
        x_fixed=x_fixed, alpha=alpha, n_groups=n_groups, qcap=qcap,
        solver=solver, shard=shard)
