"""Discrete-time fluid simulation of a distributed stream application over a
bandwidth-constrained fabric (reproduces the paper's testbed, §VI), on
tensors.

Each tick (``dt`` seconds):
  1. network transfer: every flow moves min(Q_s, x_f·dt) MB from its sender
     queue to its receiver queue — x is the policy's rate vector (TCP max-min,
     the paper's App-aware Alg. 1, App-Fair, or a fixed vector for the
     brute-force motivation study);
  2. processing: each instance consumes from its receiver queues — *join*
     instances advance in lock-step with their proportional inputs (a starved
     input stalls the join: the paper's core phenomenon), others consume
     work-conserving up to proc_rate;
  3. emission: consumed MB × selectivity is split over outgoing flows per the
     grouping weights; sources additionally generate gen_rate·dt.

The run is a Python loop over ticks whose per-tick outputs are stacked into
``[T, ...]`` device tensors at its end. Policies re-solve their rates on
update ticks (TCP every tick — idealized instant congestion control;
App-aware every Δt, matching the paper's 5 s controller interval). Whether a
tick updates depends only on the host-side tick counter, and nothing in the
loop reads a device value back, so the host runs ahead of the card. The
update and the tick are functional steps (``_update``, ``_advance``): one
sim runs them directly (``_run``), a fleet bucket runs them under
``torch.func.vmap`` over its scenarios (``_run_bucket``).

**In-run network dynamics:** link capacity is a function of time. A
:class:`repro_torch.net.topology.LinkSchedule` compiles into per-sim
tensors; ``_caps_over`` evaluates the whole ``[T, L]`` capacity trajectory
once per run. Policies re-solve against ``caps(t_upd)`` at their update
ticks; between updates the *network itself* enforces the current capacity.
A sim compiled without a schedule (S = 0 sinusoids, E = 0 events) skips
every dynamic term *by shape*. Mid-run rerouting gathers the active route
state's routing matrix from a precompiled ``[S_r, F, L]`` bank per tick.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.allocator import LinkProgram, allocate
from repro_torch.core.flowstate import FlowState
from repro_torch.core.multiapp import (
    ewma_throughput,
    group_by_throughput,
    strict_priority_alloc,
)
from repro_torch.core.tcp import maxmin_fused_step, maxmin_order_init
from repro_torch.device import resolve_device
from repro_torch.net.topology import LinkSchedule, RouteSchedule, Topology
from repro_torch.streams.app import InstanceGraph, source_sink_paths
from repro_torch.streams.placement import _steady_state_flow_volume

_EPS = 1e-9
INTERNAL_RATE = 1e6  # MB/s: same-machine flows move at memory speed
_LAT_CAP = 1e4       # s: cap on per-flow latency contribution (stalled flows)
_INF = float("inf")

# The summary vector computed by `_metrics_epilogue`, in order. Throughput
# entries are MB-based (the per-scenario ``tuples_per_mb`` conversion is one
# exact scalar multiply, applied host-side by the consumers).
CAMPAIGN_METRICS = (
    "avg_tput_mb_s",      # post-warmup mean sink rate
    "final_tput_mb_s",    # smoothed sink rate at the last tick
    "avg_latency_s",      # post-warmup mean path latency
    "utilization",        # bottleneck-link utilization (Fig. 12 metric)
    "dip_depth",          # fractional dip after t_event (0 = none)
    "recovery_time_s",    # settling time after t_event (inf = never)
    "total_sink_mb",      # total MB delivered to sinks
)

# CompiledSim's tensor fields, in the reference's order
DATA_FIELDS = (
    "R", "caps", "kinds", "has_links", "M_in", "w_out", "p_in",
    "proc_rate", "selectivity", "gen_rate", "is_join", "is_sink",
    "join_dst", "droppable", "dst_of_flow", "src_of_flow", "w_of_flow",
    "path_w", "app_of_flow", "app_of_inst",
    "sin_amp", "sin_omega", "sin_phase",
    "ev_t0", "ev_t1", "ev_link", "ev_scale",
    "route_bank", "route_t", "route_state",
)


def metric_index(name: str) -> int:
    return CAMPAIGN_METRICS.index(name)


@dataclasses.dataclass
class CompiledSim:
    """Structure of one simulation: tensors on one device, plus two host
    scalars (``tuples_per_mb``, ``n_apps``)."""

    # network
    R: Any               # [F, L]
    caps: Any            # [L] base capacities (schedule scales them in-run)
    kinds: Any           # [L]
    has_links: Any       # [F] bool
    # dataflow
    M_in: Any            # [I, F] flow f ends at instance i
    w_out: Any           # [I, F] share of inst output onto flow
    p_in: Any            # [F] proportion of dst's input expected on flow
    proc_rate: Any       # [I]
    selectivity: Any     # [I]
    gen_rate: Any        # [I]
    is_join: Any         # [I] bool
    is_sink: Any         # [I] bool
    join_dst: Any        # [F] bool: flow terminates at a join instance
    droppable: Any       # [F] bool: stale excess is discarded at the join
    dst_of_flow: Any     # [F]
    src_of_flow: Any     # [F]
    w_of_flow: Any       # [F] = w_out[src_of_flow[f], f]
    path_w: Any          # [F] per-flow latency weight = Σ_p paths[p, f]/P
    tuples_per_mb: float
    app_of_flow: Any     # [F] int
    app_of_inst: Any     # [I] int
    n_apps: int
    # capacity schedule (see LinkSchedule); S = 0 / E = 0 means static caps
    # and the simulator skips the dynamic terms by shape
    sin_amp: Any         # [S, L]
    sin_omega: Any       # [S, L]
    sin_phase: Any       # [S, L]
    ev_t0: Any           # [E]
    ev_t1: Any           # [E]
    ev_link: Any         # [E]
    ev_scale: Any        # [E]
    # mid-run rerouting bank (see RouteSchedule): S_r = 0 means static
    # routing. Padded interval slots never activate (t0 = inf) and padded
    # bank states are never indexed.
    route_bank: Any      # [S_r, F, L] routing matrix per route state
    route_t: Any         # [S_r] interval start times (inf = padding)
    route_state: Any     # [S_r] state index per interval

    @property
    def program(self) -> LinkProgram:
        return LinkProgram(R=self.R, capacity=self.caps, kind=self.kinds)

    def program_at(self, caps_t, R=None) -> LinkProgram:
        return LinkProgram(R=self.R if R is None else R,
                           capacity=caps_t, kind=self.kinds)

    @property
    def is_dynamic(self) -> bool:
        """Whether a capacity schedule is attached — a *shape* predicate
        (S > 0 sinusoids or E > 0 events)."""
        return self.sin_amp.shape[0] > 0 or self.ev_t0.shape[0] > 0

    @property
    def is_rerouting(self) -> bool:
        """Whether a route bank is attached (S_r > 0)."""
        return self.route_bank.shape[0] > 0

    @property
    def device(self) -> torch.device:
        return self.R.device

    def to(self, device) -> "CompiledSim":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in DATA_FIELDS})


def _as_field(a, device) -> torch.Tensor:
    """One CompiledSim field from an array: floats as float32, integers as
    int64 (index dtype), bools as bool."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        dtype = np.bool_
    elif np.issubdtype(a.dtype, np.integer):
        dtype = np.int64
    else:
        dtype = np.float32
    # astype copies, so the field owns its memory; a host field is that copy
    return torch.from_numpy(a.astype(dtype)).to(device)


def sim_from_numpy(fields: "dict[str, np.ndarray]", *, tuples_per_mb: float,
                   n_apps: int, device) -> CompiledSim:
    """The port's CompiledSim from a reference CompiledSim's data fields as
    numpy arrays (``{f: np.asarray(getattr(jax_sim, f)) for f in
    DATA_FIELDS}``) plus its two static fields — so both packages can be
    fed identical scenario state."""
    dev = resolve_device(device)
    return CompiledSim(tuples_per_mb=float(tuples_per_mb), n_apps=int(n_apps),
                       **{f: _as_field(fields[f], dev) for f in DATA_FIELDS})


def _validate_sim_inputs(where: str, *,
                         finite_nonneg: Sequence[tuple[str, Any]] = (),
                         nonneg_inf_ok: Sequence[tuple[str, Any]] = ()
                         ) -> None:
    """Reject poisoned scenario inputs at the compile boundary with an
    error naming the offending field.

    ``finite_nonneg`` fields (capacities, demands, event scales) must be
    finite and ≥ 0; ``nonneg_inf_ok`` fields may be +inf — event times
    use inf for "never" and ``proc_rate`` uses inf for "unbounded" — but
    NaN and negative values are always poison."""
    for field, a in finite_nonneg:
        a = np.asarray(a, np.float64)
        bad = ~np.isfinite(a) | (a < 0)
        if bad.any():
            i = int(np.flatnonzero(bad.ravel())[0])
            raise ValueError(
                f"{where}: {field} must be finite and non-negative; got "
                f"{field}.ravel()[{i}] = {a.ravel()[i]}")
    for field, a in nonneg_inf_ok:
        a = np.asarray(a, np.float64)
        bad = np.isnan(a) | (a < 0)
        if bad.any():
            i = int(np.flatnonzero(bad.ravel())[0])
            raise ValueError(
                f"{where}: {field} must be non-negative and not NaN "
                f"(+inf is allowed); got "
                f"{field}.ravel()[{i}] = {a.ravel()[i]}")


@tracing.traced("compile_sim")
def compile_sim(
    graph: InstanceGraph,
    topo: Topology,
    machine_of_inst: np.ndarray,
    app_of_inst: np.ndarray | None = None,
    n_apps: int = 1,
    schedule: LinkSchedule | None = None,
    reroute: "bool | RouteSchedule" = False,
    device: "str | torch.device | None" = None,
) -> CompiledSim:
    """Compile one scenario onto ``device`` (default: the CUDA card).
    ``reroute=True`` derives a :class:`RouteSchedule` from ``schedule``'s
    events (the SDN controller reprograms routes around failed links
    mid-run); an explicit ``RouteSchedule`` is used as-is. A schedule whose
    events never change the route set collapses to a single state and
    compiles exactly like ``reroute=False``. Records a ``compile_sim`` span
    while recording is on (:mod:`repro_torch.tracing`), and a
    ``route_bank`` span inside it where a route bank is built."""
    dev = resolve_device(device)
    flows = graph.flow_pairs(machine_of_inst)
    R = topo.routing_matrix(flows)
    M_in = graph.in_matrix()
    # steady-state volumes -> expected input proportions per dst instance,
    # with semantic `join_share` overrides (paper's TI: the join consumes the
    # congestion stream at its *useful* rate, not its volume-average rate)
    vol = _steady_state_flow_volume(graph) + 1e-12
    edges = graph.app.edges
    share = np.array(
        [edges[e].join_share if edges[e].join_share is not None else np.nan
         for e in graph.edge_of_flow]
    )
    p_in = np.zeros(graph.n_flows)
    for i in range(graph.n_instances):
        sel = graph.dst_of_flow == i
        if not sel.any():
            continue
        ov = sel & ~np.isnan(share)
        free = sel & np.isnan(share)
        # overridden edges: edge share split within the edge by volume
        used = 0.0
        for e in np.unique(graph.edge_of_flow[ov]):
            fe = ov & (graph.edge_of_flow == e)
            p_in[fe] = edges[e].join_share * vol[fe] / vol[fe].sum()
            used += edges[e].join_share
        if free.any():
            p_in[free] = max(1.0 - used, 0.0) * vol[free] / vol[free].sum()
        s = p_in[sel].sum()
        if s > 0:
            p_in[sel] /= s
    droppable = np.array([edges[e].droppable for e in graph.edge_of_flow])
    # collapse the [P, F] path masks to one per-flow weight vector: the
    # latency estimate is linear in the per-flow waits
    paths = source_sink_paths(graph)
    path_w = paths.sum(0) / max(paths.shape[0], 1)
    app_of_inst = (
        np.zeros(graph.n_instances, np.int32) if app_of_inst is None else app_of_inst
    )
    if schedule is None:
        schedule = LinkSchedule.empty(topo.n_links)
    elif schedule.n_links != topo.n_links:
        raise ValueError(
            f"schedule covers {schedule.n_links} links, topology has "
            f"{topo.n_links}")
    ev_link = np.asarray(schedule.ev_link)
    if ev_link.size and (ev_link.min() < 0
                         or ev_link.max() >= topo.n_links):
        raise ValueError(
            f"schedule event links {ev_link} out of range for "
            f"{topo.n_links} links")
    _validate_sim_inputs(
        "compile_sim",
        finite_nonneg=[("capacities", topo.capacities),
                       ("gen_rate", graph.gen_rate),
                       ("ev_scale", schedule.ev_scale)],
        nonneg_inf_ok=[("proc_rate", graph.proc_rate),
                       ("ev_t0", schedule.ev_t0),
                       ("ev_t1", schedule.ev_t1)])
    F, L = len(flows), topo.n_links
    route_bank = np.zeros((0, F, L), np.float32)
    route_t = np.zeros((0,), np.float32)
    route_state = np.zeros((0,), np.int32)
    if reroute is True or isinstance(reroute, RouteSchedule):
        with tracing.span("route_bank"):
            if reroute is True:
                reroute = RouteSchedule.from_events(topo, flows, schedule)
            if reroute.routes.shape[1:] != (F, L):
                raise ValueError(
                    f"route schedule is [{reroute.routes.shape[1]} flows, "
                    f"{reroute.routes.shape[2]} links]; scenario has "
                    f"[{F}, {L}]")
            if reroute.n_states > 1:
                # single shared S_r axis for bank + interval arrays: padded
                # intervals never activate, padded bank states never indexed
                sr = max(reroute.n_states, reroute.n_intervals)
                route_bank = np.zeros((sr, F, L), np.float32)
                route_bank[:reroute.n_states] = reroute.routes
                route_t = np.full((sr,), np.inf, np.float32)
                route_t[:reroute.n_intervals] = reroute.t0
                route_state = np.zeros((sr,), np.int32)
                route_state[:reroute.n_intervals] = reroute.state
    fields = dict(
        R=R,
        caps=topo.capacities,
        kinds=topo.link_kinds,
        has_links=R.sum(1) > 0,
        M_in=M_in,
        w_out=graph.w_out,
        p_in=p_in,
        proc_rate=np.minimum(graph.proc_rate, 1e9),
        selectivity=graph.selectivity,
        gen_rate=graph.gen_rate,
        is_join=graph.is_join,
        is_sink=graph.is_sink,
        join_dst=graph.is_join[graph.dst_of_flow],
        droppable=droppable,
        dst_of_flow=graph.dst_of_flow,
        src_of_flow=graph.src_of_flow,
        w_of_flow=graph.w_out[graph.src_of_flow, np.arange(graph.n_flows)],
        path_w=path_w,
        app_of_flow=app_of_inst[graph.dst_of_flow],
        app_of_inst=app_of_inst,
        sin_amp=schedule.sin_amp,
        sin_omega=schedule.sin_omega,
        sin_phase=schedule.sin_phase,
        ev_t0=schedule.ev_t0,
        ev_t1=schedule.ev_t1,
        ev_link=schedule.ev_link,
        ev_scale=schedule.ev_scale,
        route_bank=route_bank,
        route_t=route_t,
        route_state=route_state,
    )
    return sim_from_numpy(fields, tuples_per_mb=float(graph.app.tuples_per_mb),
                          n_apps=int(n_apps), device=dev)


def _route_states_over(sim: CompiledSim, ts: torch.Tensor) -> torch.Tensor:
    """Per-tick route-state index [T]: tick t takes the last interval whose
    start time is ≤ t (f32 comparison). Padded interval slots start at +inf
    (never counted); rows before every interval clamp to interval 0."""
    j = (ts[:, None] >= sim.route_t[None, :]).sum(1) - 1
    return sim.route_state[torch.clamp_min(j, 0)]


def _caps_over(sim: CompiledSim, ts: torch.Tensor) -> torch.Tensor:
    """Evaluate the capacity schedule on a tick grid: [T, L].

    Computed once per run, before the tick loop. Sims without sinusoids
    (S = 0) or events (E = 0) skip those terms by shape. Events on the same
    link compose as a product: each link multiplies the factors of the
    events on it, in event order, through an [E, L] one-hot (out of place,
    so the fleet evaluates a whole bucket under ``torch.func.vmap``; a
    plain indexed multiply would keep only the last write).
    """
    T, L = ts.shape[0], sim.caps.shape[0]
    caps = sim.caps[None, :].expand(T, L)
    if sim.sin_amp.shape[0]:
        wave = (sim.sin_amp[None] * torch.sin(
            sim.sin_omega[None] * ts[:, None, None]
            + sim.sin_phase[None])).sum(1)                  # [T, L]
        caps = caps * (1.0 + wave)
    if sim.ev_t0.shape[0]:
        active = (ts[:, None] >= sim.ev_t0[None]) & (
            ts[:, None] < sim.ev_t1[None])                  # [T, E]
        mult = torch.where(active, sim.ev_scale[None], 1.0)
        idx = torch.clamp(sim.ev_link, 0, L - 1)
        on = idx[:, None] == torch.arange(L, device=idx.device)[None, :]
        scale = torch.where(on[None], mult[:, :, None], 1.0).prod(1)
        caps = caps * scale                                  # [T, L]
    return torch.clamp_min(caps, 0.0)


def _smooth(rate: torch.Tensor, w: int) -> torch.Tensor:
    """``np.convolve(rate, ones(w), mode="same")`` for len(rate) ≥ w: numpy
    centres an even window with w//2 samples before and (w−1)//2 after."""
    padded = torch.nn.functional.pad(rate[None, None],
                                     (w // 2, (w - 1) // 2))[0, 0]
    return padded.unfold(0, w, 1).sum(1)


def _metrics_epilogue(sink, wait, load, caps_grid, path_w, dt: float,
                      t_event: float, win_s: float = 5.0,
                      pre_s: float = 20.0, frac: float = 0.95,
                      hot_thresh: float = 0.5) -> torch.Tensor:
    """On-device reduction of one run's trajectories to the
    :data:`CAMPAIGN_METRICS` vector. Mirrors the host-side ``SimResult``
    properties (``throughput_tps``, ``avg_latency_s``,
    ``bottleneck_utilization``, ``dip_depth``, ``recovery_time_s``) up to
    float re-association."""
    T = sink.shape[0]
    warm = T // 4
    rate = sink / dt                                           # [T] MB/s
    lat_t = wait @ path_w                                      # [T]
    # bottleneck utilization: mean per-tick utilization against the
    # *scheduled* capacity, averaged over links carrying >= hot_thresh of
    # capacity (all-cold fallback: the near-max links)
    util = (load[warm:] / torch.clamp_min(caps_grid[warm:], _EPS)).mean(0)
    hot = util >= hot_thresh
    hot = torch.where(hot.any(), hot, util >= util.max() * 0.999)
    utilization = (torch.where(hot, util, 0.0).sum()
                   / torch.clamp_min(hot.sum(), 1).to(util.dtype))
    # transient metrics on the win_s-smoothed throughput (edge windows
    # divide by the actual sample count)
    w = max(int(round(win_s / dt)), 1)
    r = _smooth(rate, w) / _smooth(torch.ones_like(rate), w)
    i = min(int(round(t_event / dt)), T - 1)
    pre_mean = r[max(0, i - int(round(pre_s / dt))):max(i, 1)].mean()
    post = r[i:]
    post_min = post.min()
    dip = torch.where(pre_mean > _EPS,
                      torch.clamp_min((pre_mean - post_min)
                                      / torch.clamp_min(pre_mean, _EPS), 0.0),
                      0.0)
    # settling time, branchless: a masked argmax over a static window
    P = post.shape[0]
    if P < 2:
        recovery = torch.zeros((), dtype=rate.dtype, device=rate.device)
    else:
        steady = post[-max(P // 4, 1):].mean()
        inside = (post >= frac * steady) & (post * frac <= steady)
        first_out = (~inside).to(torch.int32).argmax()
        cand = inside & (torch.arange(P, device=rate.device) >= first_out)
        recovery = torch.where(
            inside.all(), 0.0,
            torch.where(cand.any(),
                        cand.to(torch.int32).argmax().to(rate.dtype) * dt,
                        _INF))
    return torch.stack([
        rate[warm:].mean(),
        r[-1],
        lat_t[warm:].mean(),
        utilization,
        dip,
        recovery.to(rate.dtype),
        sink.sum(),
    ])


# --------------------------------------------------------------------------
# one simulation tick (shared by all policies)
# --------------------------------------------------------------------------
def _tick(sim: CompiledSim, Qs, Qr, x, dt, qcap, caps_t=None, enforce=True,
          R_t=None):
    """One fluid step against the *current* link capacities ``caps_t``.

    ``M_in`` and ``w_out`` have exactly one nonzero per flow column (the
    flow's destination / source instance), so ``M_in @ (consume·stall[dst])
    = (M_in @ consume)·stall`` and ``w_out.T @ v = v[src]·w_of_flow``.

    With ``caps_t`` given and ``enforce`` true, the network enforces the
    current capacity: between controller updates a failed/shrunk link moves
    at most caps_t·dt, whatever the stale rate vector says. ``enforce`` is
    a Python bool for a lone sim and a per-scenario bool tensor in a fleet
    bucket: an un-enforced row multiplies its transfer by exactly 1.0, so a
    static scenario padded into a scheduled bucket keeps its static
    transfer bit for bit. ``R_t`` is the tick's active routing matrix when
    a route bank is attached (``None`` reads ``sim.R``).
    """
    R = sim.R if R_t is None else R_t
    dst, src = sim.dst_of_flow, sim.src_of_flow

    # receiver-window flow control: never overflow the receive buffer
    desired = torch.minimum(torch.minimum(Qs, x * dt),
                            torch.clamp_min(qcap - Qr, 0.0))
    if caps_t is None or enforce is False:
        # static capacities: the policies' rate vectors are already
        # link-feasible, so the transfer needs no per-tick capacity check
        transfer = desired
    else:
        load0 = desired @ R                                      # [L] MB
        lscale = torch.where(
            load0 > caps_t * dt,
            torch.clamp(caps_t * dt / torch.clamp_min(load0, _EPS), 0.0, 1.0),
            1.0)
        fscale = torch.where(R > 0, lscale[None, :], _INF).amin(1)
        fscale = torch.where(torch.isfinite(fscale), fscale, 1.0)
        if enforce is not True:
            fscale = torch.where(enforce, fscale, 1.0)
        transfer = desired * fscale
    Qs = Qs - transfer
    Qr = Qr + transfer

    # --- processing ---------------------------------------------------
    ratio = Qr / torch.clamp_min(sim.p_in, _EPS)                 # [F]
    masked = torch.where(sim.M_in > 0, ratio[None, :], _INF)     # [I, F]
    join_amt = masked.amin(1)                                    # [I]
    join_amt = torch.where(torch.isfinite(join_amt), join_amt, 0.0)
    join_amt = torch.minimum(join_amt, sim.proc_rate * dt)
    consume_join = join_amt[dst] * sim.p_in                      # [F]

    total_in = sim.M_in @ Qr                                     # [I]
    amt = torch.minimum(total_in, sim.proc_rate * dt)
    frac = amt / torch.clamp_min(total_in, _EPS)
    consume_any = Qr * frac[dst]

    consume = torch.where(sim.join_dst, consume_join, consume_any)
    consume = torch.minimum(consume, Qr)

    # sender-side backpressure (Storm's bounded send buffers): an instance
    # whose outgoing queue is full stalls its processing / generation
    in_i = sim.M_in @ consume                                    # [I]
    out_i = sim.selectivity * in_i + sim.gen_rate * dt
    prod = out_i[src] * sim.w_of_flow                            # [F]
    space = torch.clamp_min(qcap - Qs, 0.0)
    scale_f = torch.clamp(space / torch.clamp_min(prod, _EPS), 0.0, 1.0)
    # droppable (latest-value) streams never backpressure upstream
    stalled = torch.where((sim.w_out > 0) & ~sim.droppable[None, :],
                          scale_f[None, :], _INF)
    stall_i = stalled.amin(1)                                    # [I]
    stall_i = torch.where(torch.isfinite(stall_i), stall_i, 1.0)

    consume = consume * stall_i[dst]
    Qr = Qr - consume
    # stale-data discard: droppable join inputs keep only a small window
    Qr = torch.where(sim.droppable, torch.clamp_max(Qr, 0.5), Qr)
    in_i = in_i * stall_i        # = M_in @ (consume·stall[dst]), fused
    out_i = sim.selectivity * in_i + sim.gen_rate * dt * stall_i
    Qs = Qs + out_i[src] * sim.w_of_flow   # = w_out.T @ out_i, fused
    # latest-value send queues hold only the freshest working window
    Qs = torch.where(sim.droppable, torch.clamp_max(Qs, 0.5), Qs)

    sink_in = torch.where(sim.is_sink, in_i, 0.0)
    sink_mb = sink_in.sum()
    if sim.n_apps == 1:
        sink_mb_app = sink_mb[None]
    else:
        onehot = (sim.app_of_inst[None, :]
                  == torch.arange(sim.n_apps, device=Qs.device)[:, None]
                  ).to(sink_in.dtype)
        sink_mb_app = onehot @ sink_in
    drain = consume / dt                                         # [F] MB/s

    # --- latency estimate: raw per-flow waits --------------------------
    wait = torch.clamp_max(
        Qs / torch.clamp_min(x, _EPS) + Qr / torch.clamp_min(drain, _EPS),
        _LAT_CAP)

    link_load = transfer @ R / dt                                # [L] MB/s
    return Qs, Qr, transfer, drain, (sink_mb, sink_mb_app, wait, link_load)


# --------------------------------------------------------------------------
# policies
# --------------------------------------------------------------------------
def _tcp_rates(sim: CompiledSim, R, caps_t, Qs, Qr, prod_rate, drain_ewma,
               dt, qcap, order_carry):
    # sender-side demand, clamped by the receiver window (rwnd): a flow whose
    # receive buffer is full only demands its drain rate
    send = Qs / dt + prod_rate
    rwnd = torch.clamp_min(qcap - Qr, 0.0) / dt + drain_ewma
    demand = torch.minimum(send, rwnd)
    x, order_carry, rebuilt = maxmin_fused_step(R, caps_t, demand,
                                                order_carry)
    x = torch.where(sim.has_links, torch.minimum(x, demand), INTERNAL_RATE)
    return x, order_carry, rebuilt


def _appaware_rates(sim: CompiledSim, R, caps_t, state: FlowState, dt_alloc,
                    backfill_iters=8, solver: str = "sort", per_link=None):
    x = allocate(sim.program_at(caps_t, R=R), state, dt=dt_alloc,
                 backfill_iters=backfill_iters, solver=solver,
                 per_link=per_link)
    return torch.where(sim.has_links, x, INTERNAL_RATE)


@dataclasses.dataclass
class SimResult:
    sink_mb: np.ndarray        # [T]
    sink_mb_app: np.ndarray    # [T, A]
    latency: np.ndarray        # [T]
    link_load: np.ndarray      # [T, L]
    caps: np.ndarray           # [L] base capacities
    kinds: np.ndarray          # [L]
    tuples_per_mb: float
    dt: float
    caps_t: np.ndarray | None = None   # [T, L] per-tick capacities
    # [T] bool — ticks on which the tcp solver's demand-order cache rebuilt
    # its rank operand (all-False for non-tcp policies)
    order_rebuilds: np.ndarray | None = None
    # [n_metrics] — the CAMPAIGN_METRICS summary from `_metrics_epilogue`
    metrics: np.ndarray | None = None

    def metric(self, name: str) -> float:
        """One entry of the epilogue vector by name (see
        ``CAMPAIGN_METRICS``)."""
        if self.metrics is None:
            raise ValueError("run did not compute the metric epilogue")
        return float(self.metrics[metric_index(name)])

    @property
    def n_order_rebuilds(self) -> int:
        return 0 if self.order_rebuilds is None else int(
            np.sum(self.order_rebuilds))

    def _warm(self, arr):
        return arr[arr.shape[0] // 4:]

    @property
    def caps_grid(self) -> np.ndarray:
        """Per-tick capacities [T, L] (static caps broadcast if no
        schedule ran)."""
        if self.caps_t is not None:
            return self.caps_t
        return np.broadcast_to(self.caps[None, :], self.link_load.shape)

    @property
    def throughput_tps(self) -> float:
        """App throughput: completed tuples/s at the sinks (post-warmup)."""
        return float(self._warm(self.sink_mb).mean() / self.dt * self.tuples_per_mb)

    @property
    def throughput_tps_per_app(self) -> np.ndarray:
        return np.asarray(
            self._warm(self.sink_mb_app).mean(0) / self.dt * self.tuples_per_mb
        )

    @property
    def avg_latency_s(self) -> float:
        return float(self._warm(self.latency).mean())

    def bottleneck_utilization(self, threshold: float = 0.5) -> float:
        """Avg utilization over bottlenecked links — links carrying ≥
        ``threshold`` of their capacity (paper Fig. 12), per tick against
        the *scheduled* capacity."""
        load = self._warm(self.link_load)
        caps = self._warm(self.caps_grid)
        util_t = load / np.maximum(caps, _EPS)            # [T', L]
        util = util_t.mean(0)
        hot = util >= threshold
        if not hot.any():
            hot = util >= util.max() * 0.999
        return float(util[hot].mean())

    # ---- transient response (in-run schedules) -----------------------
    def _smooth_tput(self, win_s: float = 5.0) -> np.ndarray:
        """Sink throughput [T] (tuples/s) smoothed over ``win_s``; edge
        windows divide by the actual sample count."""
        w = max(int(round(win_s / self.dt)), 1)
        rate = self.sink_mb / self.dt * self.tuples_per_mb
        kern = np.ones(w)
        num = np.convolve(rate, kern, mode="same")
        den = np.convolve(np.ones_like(rate), kern, mode="same")
        return num / den

    def dip_depth(self, t_event: float, pre_s: float = 20.0,
                  win_s: float = 5.0) -> float:
        """Fractional throughput dip after an event at ``t_event`` (0 = no
        dip, 1 = complete stall)."""
        r = self._smooth_tput(win_s)
        i = min(int(round(t_event / self.dt)), r.shape[0] - 1)
        pre = r[max(0, i - int(round(pre_s / self.dt))):max(i, 1)]
        pre_mean = float(pre.mean()) if pre.size else 0.0
        if pre_mean <= _EPS:
            return 0.0
        post_min = float(r[i:].min()) if r[i:].size else pre_mean
        return max(0.0, (pre_mean - post_min) / pre_mean)

    def recovery_time_s(self, t_event: float, frac: float = 0.95,
                        win_s: float = 5.0) -> float:
        """Settling time after an event at ``t_event``: how long the
        smoothed throughput takes to first re-enter the ±(1−``frac``) band
        around its post-event steady state *after having left it*. 0 if it
        never leaves the band; ``inf`` if it leaves and never settles."""
        r = self._smooth_tput(win_s)
        i = min(int(round(t_event / self.dt)), r.shape[0] - 1)
        post = r[i:]
        if post.size < 2:
            return 0.0
        steady = float(post[-max(post.size // 4, 1):].mean())
        inside = (post >= frac * steady) & (post * frac <= steady)
        if inside.all():
            return 0.0
        first_out = int(np.argmax(~inside))
        ok = inside[first_out:]
        if not ok.any():
            return float("inf")
        return float(first_out + int(np.argmax(ok))) * self.dt


# --------------------------------------------------------------------------
# the tick loop: one functional update / advance pair, run on one sim or,
# under torch.func.vmap, on a fleet bucket
# --------------------------------------------------------------------------
POLICIES = ("tcp", "fixed", "appaware", "appfair")

# The fields a tick reads (the schedule and route-bank fields are consumed
# once per run, before the loop, by `_caps_over` / `_route_states_over`).
STEP_FIELDS = (
    "R", "caps", "kinds", "has_links", "M_in", "w_out", "p_in", "proc_rate",
    "selectivity", "gen_rate", "is_join", "is_sink", "join_dst", "droppable",
    "dst_of_flow", "src_of_flow", "w_of_flow", "app_of_flow", "app_of_inst",
)


def _init_carry(policy: str, F: int, A: int, device):
    """The loop state ``(Qs, Qr, B, x, v_acc, ls, lr, prod_rate,
    drain_ewma, mu, mu_acc, oc)``: queues, the appaware profiler's backlog
    and interval accumulators, tcp's demand terms, appfair's throughput
    EWMA, and tcp's demand-order cache (an empty tuple for the others)."""
    z = torch.zeros((F,), dtype=torch.float32, device=device)
    mu0 = torch.zeros((A,), dtype=torch.float32, device=device)
    oc = maxmin_order_init(F, device=device) if policy == "tcp" else ()
    return (z, z, z, z, z, z, z, z, z, mu0, mu0, oc)


def _flow_state(carry) -> FlowState:
    """What the application profiler reports at an update: the interval's
    start backlogs, its transfer, and the *useful* receiver backlog B
    (bytes transferred but not yet joined)."""
    Qs, _, B, _, v_acc, ls, lr = carry[:7]
    return FlowState(ls_t=ls, lr_t=lr, v=v_acc, ls_t1=Qs, lr_t1=B)


def _update(sim: CompiledSim, policy: str, carry, R_upd, caps_upd, x_fixed,
            *, dt: float, upd_every: int, alpha: float, n_groups: int,
            qcap: float, solver: str, per_link=None):
    """A controller update: the policy's new rate vector, and the interval
    accumulators reset. Returns ``(carry', rebuilt)``; ``rebuilt`` is tcp's
    order-cache rebuild flag (False for the other policies). ``per_link``
    is appaware's per-link solve when the caller already made it (the
    fleet's one waterfill launch per bucket update)."""
    (Qs, Qr, B, x, v_acc, ls, lr, prod_rate, drain_ewma, mu, mu_acc,
     oc) = carry
    reb = torch.zeros((), dtype=torch.bool, device=Qs.device)
    if policy == "tcp":
        x, oc, reb = _tcp_rates(sim, R_upd, caps_upd, Qs, Qr, prod_rate,
                                drain_ewma, dt, qcap, oc)
    elif policy == "fixed":
        x = torch.where(sim.has_links, x_fixed, INTERNAL_RATE)
    elif policy == "appaware":
        x = _appaware_rates(sim, R_upd, caps_upd, _flow_state(carry),
                            dt * upd_every, solver=solver, per_link=per_link)
    else:  # appfair
        mu = ewma_throughput(mu, mu_acc / (dt * upd_every), alpha)
        prio = group_by_throughput(mu, n_groups)
        x = strict_priority_alloc(R_upd, caps_upd, sim.app_of_flow, prio,
                                  n_groups=n_groups)
        x = torch.where(sim.has_links, x, INTERNAL_RATE)
    z = torch.zeros_like(Qs)
    return ((Qs, Qr, B, x, z, Qs, B, prod_rate, drain_ewma, mu,
             torch.zeros_like(mu_acc), oc), reb)


def _advance(sim: CompiledSim, policy: str, carry, caps_t, R_t, enforce,
             *, dt: float, qcap: float):
    """One tick at the current rates. Returns ``(carry', (sink, sink_app,
    wait, load))``; a policy that never reads prod_rate/B/mu_acc doesn't
    pay their per-tick ops."""
    (Qs, Qr, B, x, v_acc, ls, lr, prod_rate, drain_ewma, mu, mu_acc,
     oc) = carry
    Qs1, Qr1, transfer, drain, ys = _tick(
        sim, Qs, Qr, x, dt, qcap, caps_t=caps_t, enforce=enforce, R_t=R_t)
    if policy == "tcp":
        t_in = sim.M_in @ transfer
        out_i = sim.selectivity * t_in + sim.gen_rate * dt
        prod_rate = out_i[sim.src_of_flow] * sim.w_of_flow / dt
        drain_ewma = 0.5 * drain_ewma + 0.5 * drain
    elif policy == "appaware":
        B = torch.clamp(B + transfer - drain * dt, 0.0, 8.0 * qcap)
        v_acc = v_acc + transfer
    elif policy == "appfair":
        mu_acc = mu_acc + ys[1]
    return ((Qs1, Qr1, B, x, v_acc, ls, lr, prod_rate, drain_ewma, mu,
             mu_acc, oc), ys)


def _run(sim: CompiledSim, policy: str, n_ticks: int, dt: float,
         upd_every: int, x_fixed=None, alpha: float = 0.5, n_groups: int = 8,
         qcap: float = 8.0, solver: str = "sort", enforce=None,
         with_metrics: bool = True, t_event: float = 0.0):
    """The tick loop of one sim. Returns device tensors ``(sink [T],
    sink_app [T, A], wait [T, F], load [T, L], rebuilds [T], caps_sched
    [T|0, L])`` and, with ``with_metrics``, the :data:`CAMPAIGN_METRICS`
    vector after them. ``enforce`` (default True) gates the capacity
    enforcement of a scheduled sim (see :func:`_tick`).

    Whether a tick updates the policy's rates is decided on the host from
    the tick counter alone; no value is read back from the device inside
    the loop."""
    if policy not in POLICIES:
        raise ValueError(policy)
    dev = sim.device
    F, L = sim.R.shape
    f32 = torch.float32
    dynamic = sim.is_dynamic
    rerouting = sim.is_rerouting
    # tick times in float32, like the event and route times they are
    # compared with
    ts = torch.arange(n_ticks, dtype=f32, device=dev) * dt
    with tracing.span("schedule"):
        caps_sched = (_caps_over(sim, ts) if dynamic
                      else torch.zeros((0, L), dtype=f32, device=dev))
        states_seq = _route_states_over(sim, ts) if rerouting else None
    if policy == "fixed":
        x_fixed = torch.as_tensor(x_fixed, dtype=f32, device=dev)
    kw = dict(dt=dt, upd_every=upd_every, alpha=alpha, n_groups=n_groups,
              qcap=qcap, solver=solver)
    enforce = True if enforce is None else enforce

    carry = _init_carry(policy, F, sim.n_apps, dev)
    no_rebuild = torch.zeros((), dtype=torch.bool, device=dev)
    ys_all, reb_all = [], []
    for tick in range(n_ticks):
        caps_t = caps_sched[tick] if dynamic else None
        caps_upd = sim.caps if caps_t is None else caps_t
        # active routing matrix: one [F, L] bank gather per tick
        R_t = (sim.route_bank.index_select(0, states_seq[tick:tick + 1])[0]
               if rerouting else None)
        R_upd = sim.R if R_t is None else R_t
        reb = no_rebuild
        if tick % upd_every == 0:
            with tracing.span("update", tick=tick):
                carry, reb = _update(sim, policy, carry, R_upd, caps_upd,
                                     x_fixed, **kw)
        with tracing.span("advance", tick=tick):
            carry, ys = _advance(sim, policy, carry, caps_t, R_t, enforce,
                                 dt=dt, qcap=qcap)
        ys_all.append(ys)
        reb_all.append(reb)
    with tracing.span("epilogue"):
        sink, sink_app, wait, load = (torch.stack(c) for c in zip(*ys_all))
        out = (sink, sink_app, wait, load, torch.stack(reb_all), caps_sched)
        if not with_metrics:
            return out
        caps_grid = (caps_sched if dynamic
                     else sim.caps[None, :].expand(n_ticks, L))
        return out + (_metrics_epilogue(sink, wait, load, caps_grid,
                                        sim.path_w, dt, t_event),)


def _run_bucket(pack: "dict[str, torch.Tensor]", n_apps: int, policy: str,
                n_ticks: int, dt: float, upd_every: int, x_fixed=None,
                alpha: float = 0.5, n_groups: int = 8, qcap: float = 8.0,
                solver: str = "sort", enforce=None,
                with_metrics: bool = True, t_event: float = 0.0,
                stepwise: bool = False):
    """The tick loop of a fleet bucket: ``pack`` holds every
    :data:`DATA_FIELDS` tensor with a leading scenario axis [B, ...] (one
    padded shape, see ``repro_torch.streams.fleet``); ``x_fixed`` is [B, F]
    for the fixed policy and ``enforce`` a [B] bool gate (default: every
    row enforces its schedule). Returns what :func:`_run` returns, each
    tensor with the scenario axis first.

    A host loop over ticks, as in :func:`_run`, whose update and advance
    steps run under ``torch.func.vmap`` over the bucket: each tick issues
    the same launches as one sim's tick, each over B scenarios. Appaware
    with ``solver="waterfill"`` solves every link of every scenario in one
    launch of the waterfill kernel per update (B·L blocks) between two
    vmapped halves of the update.

    ``stepwise=True`` returns the loop as a generator that yields once per
    tick and returns the outputs, so a caller can interleave the ticks of
    several buckets in one host loop. The whole run is also the body that
    :class:`repro_torch.streams.graphs.BucketGraphs` captures as one CUDA
    graph."""
    if policy not in POLICIES:
        raise ValueError(policy)
    loop = _bucket_ticks(pack, n_apps, policy, n_ticks, dt, upd_every,
                         x_fixed, alpha, n_groups, qcap, solver, enforce,
                         with_metrics, t_event)
    if stepwise:
        return loop
    while True:
        try:
            next(loop)
        except StopIteration as stop:
            return stop.value


def _bucket_ticks(pack, n_apps, policy, n_ticks, dt, upd_every, x_fixed,
                  alpha, n_groups, qcap, solver, enforce, with_metrics,
                  t_event):
    from torch.func import vmap

    R = pack["R"]
    Bn, F, L = R.shape
    dev = R.device
    f32 = torch.float32
    dynamic = pack["sin_amp"].shape[1] > 0 or pack["ev_t0"].shape[1] > 0
    rerouting = pack["route_bank"].shape[1] > 0
    ts = torch.arange(n_ticks, dtype=f32, device=dev) * dt
    if enforce is None:
        enforce = torch.ones((Bn,), dtype=torch.bool, device=dev)

    def sim_of(f: dict):
        return CompiledSim(tuples_per_mb=1.0, n_apps=n_apps,
                           **{k: f.get(k) for k in DATA_FIELDS})

    with tracing.span("schedule", rows=Bn):
        caps_sched = (vmap(lambda f: _caps_over(sim_of(f), ts))(
            {k: pack[k] for k in ("caps", "sin_amp", "sin_omega",
                                  "sin_phase", "ev_t0", "ev_t1", "ev_link",
                                  "ev_scale")})
            if dynamic else torch.zeros((Bn, 0, L), dtype=f32, device=dev))
        states_seq = (vmap(lambda f: _route_states_over(sim_of(f), ts))(
            {k: pack[k] for k in ("route_t", "route_state")})
            if rerouting else None)
    step = {k: pack[k] for k in STEP_FIELDS}
    kw = dict(dt=dt, upd_every=upd_every, alpha=alpha, n_groups=n_groups,
              qcap=qcap, solver=solver)
    rows = torch.arange(Bn, device=dev)
    waterfill = policy == "appaware" and solver == "waterfill"

    def update(f, c, R_upd, caps_upd, xf, per_link):
        return _update(sim_of(f), policy, c, R_upd, caps_upd, xf,
                       per_link=per_link, **kw)

    def wf_args(f, c, R_upd, caps_upd):
        from repro_torch.core.allocator import waterfill_args
        return waterfill_args(sim_of(f).program_at(caps_upd, R=R_upd),
                              _flow_state(c), dt * upd_every)

    def advance(f, c, caps_t, R_t, en):
        return _advance(sim_of(f), policy, c, caps_t, R_t, en, dt=dt,
                        qcap=qcap)

    v_update = vmap(update, in_dims=(0, 0, 0, 0,
                                     None if x_fixed is None else 0,
                                     0 if waterfill else None))
    v_wf_args = vmap(wf_args)
    dyn = 0 if dynamic else None
    v_advance = vmap(advance, in_dims=(0, 0, dyn, 0 if rerouting else None,
                                       dyn))

    carry = tuple(
        tuple(t.expand(Bn, *t.shape).contiguous() for t in c)
        if isinstance(c, tuple) else c.expand(Bn, *c.shape).contiguous()
        for c in _init_carry(policy, F, n_apps, dev))
    no_rebuild = torch.zeros((Bn,), dtype=torch.bool, device=dev)
    ys_all, reb_all = [], []
    for tick in range(n_ticks):
        caps_t = caps_sched[:, tick] if dynamic else None
        caps_upd = pack["caps"] if caps_t is None else caps_t
        R_t = (pack["route_bank"][rows, states_seq[:, tick]] if rerouting
               else None)
        R_upd = R if R_t is None else R_t
        reb = no_rebuild
        if tick % upd_every == 0:
            with tracing.span("update", tick=tick):
                per_link = None
                if waterfill:
                    with tracing.span("solve", tick=tick):
                        from repro_torch.kernels.waterfill.ops import (
                            waterfill_fleet)
                        args = v_wf_args(step, carry, R_upd, caps_upd)
                        per_link = waterfill_fleet(
                            *(a.contiguous() for a in args),
                            dt=dt * upd_every)
                carry, reb = v_update(step, carry, R_upd, caps_upd, x_fixed,
                                      per_link)
        with tracing.span("advance", tick=tick):
            carry, ys = v_advance(step, carry, caps_t, R_t,
                                  enforce if dynamic else None)
        ys_all.append(ys)
        reb_all.append(reb)
        yield
    with tracing.span("epilogue", rows=Bn):
        sink, sink_app, wait, load = (torch.stack(c, 1)
                                      for c in zip(*ys_all))
        out = (sink, sink_app, wait, load, torch.stack(reb_all, 1),
               caps_sched)
        if not with_metrics:
            return out
        caps_grid = (caps_sched if dynamic
                     else pack["caps"][:, None, :].expand(Bn, n_ticks, L))
        metrics = vmap(lambda *a: _metrics_epilogue(*a, dt, t_event))(
            sink, wait, load, caps_grid, pack["path_w"])
        return out + (metrics,)


def result_from_padded_row(sim: CompiledSim, b: int, dt: float,
                           sink, sink_app, wait, load, rebuilds,
                           caps_sched, metrics) -> SimResult:
    """Slice row ``b`` of a padded bucket's host-side (numpy) outputs back
    to ``sim``'s true shapes — the one definition of a scenario's
    :class:`SimResult`, shared by :func:`simulate` (a bucket of one row),
    the fleet and the campaign collector. The path-mean latency is taken
    on the true [F] slice, so it does not depend on the bucket's padding."""
    F, L = sim.R.shape
    A = sim.n_apps
    path_w = sim.path_w.cpu().numpy()
    return SimResult(
        sink_mb=sink[b],
        sink_mb_app=sink_app[b][:, :A],
        latency=wait[b][:, :F] @ path_w,
        link_load=load[b][:, :L],
        caps=sim.caps.cpu().numpy(),
        kinds=sim.kinds.cpu().numpy(),
        tuples_per_mb=sim.tuples_per_mb,
        dt=dt,
        caps_t=caps_sched[b][:, :L] if sim.is_dynamic else None,
        order_rebuilds=rebuilds[b],
        metrics=None if metrics is None else metrics[b],
    )


def smoke_seconds(seconds: float, cap: float = 120.0) -> float:
    """CI short-run mode: ``REPRO_SMOKE=1`` caps run length (same dt, same
    warmup logic)."""
    if os.environ.get("REPRO_SMOKE", "").strip() not in ("", "0"):
        return min(seconds, cap)
    return seconds


def resolve_upd_every(policy: str, dt: float, upd_every: int | None) -> int:
    if upd_every is None:
        return int(round(5.0 / dt)) if policy in ("appaware", "appfair") else 1
    return upd_every


def simulate(
    sim: CompiledSim,
    policy: str = "tcp",
    seconds: float = 600.0,
    dt: float = 0.5,
    upd_every: int | None = None,
    x_fixed=None,
    alpha: float = 0.5,
    n_groups: int = 8,
    qcap: float = 8.0,
    solver: str = "sort",
    t_event: float = 0.0,
    device: "str | torch.device | None" = None,
) -> SimResult:
    """Run one experiment (paper §VI: 600 s runs, Δt = 5 s allocator) on
    ``device`` (default: the CUDA card; ``sim`` is moved there if it lives
    elsewhere). ``solver="waterfill"`` sends appaware's per-link solve
    through the CUDA waterfill kernel."""
    dev = resolve_device(device)
    if sim.device != dev:
        sim = sim.to(dev)
    n_ticks = int(round(smoke_seconds(seconds) / dt))
    upd_every = resolve_upd_every(policy, dt, upd_every)
    outs = _run(sim, policy, n_ticks, dt, upd_every, x_fixed=x_fixed,
                alpha=alpha, n_groups=n_groups, qcap=qcap, solver=solver,
                t_event=float(t_event))
    return result_from_padded_row(sim, 0, dt,
                                  *(t.cpu().numpy()[None] for t in outs))
