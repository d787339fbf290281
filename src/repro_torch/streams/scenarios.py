"""Scenario generators (numpy builders plus the port's ``compile_sim``).

A :class:`Scenario` bundles everything `compile_sim` needs — app DAG,
topology, placement — under a name, so a study is "build a list of
scenarios, `compile` them onto a device, `simulate` each". Generators cover
the axes the paper varies by hand (§VI) plus the robustness axes it leaves
open:

  * ``capacity_sweep``        — the paper's 10/15/20 Mbps grid × workloads
                                × single-/multi-hop bottlenecks (Figs. 8-9);
  * ``random_app``            — randomized layered DAGs (fan-out, joins,
                                key skew) for property-style robustness;
  * ``link_failure_sweep``    — seed workloads with a random subset of
                                links degraded to a fraction of capacity.
                                With ``in_run=True`` the failure happens
                                *mid-run* (and recovers) via a
                                :class:`~repro_torch.net.topology.LinkSchedule`,
                                exercising the controller's transient
                                response; the static form stays as the
                                steady-state parity oracle;
  * ``time_varying_sweep``    — a sinusoidal (diurnal-style) capacity
                                cycle. Static form: one scenario per phase
                                (the batch axis explores time, each phase
                                quasi-static). ``in_run=True``: the cycle
                                runs *inside* each scenario as a schedule;
  * ``seed_fleet``            — a mixed ≥16-scenario fleet of all of the
                                above (including in-run schedules), the
                                default benchmark/test corpus;
  * ``campaign_fleet``        — N-scenario streaming-campaign corpus
                                (``FleetRunner.run_campaign``): the paper's
                                capacity grid × {static, in-run failure,
                                diurnal} × a seeded jitter axis, tiled to
                                exactly N scenarios over only 6 distinct
                                padded shapes;
  * ``bench_fleet``           — the 44-scenario fleet corpus.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.net.topology import (
    Link,
    LinkKind,
    LinkSchedule,
    Topology,
    big_switch,
    diurnal_schedule,
    fat_tree,
    link_failure_schedule,
)
from repro_torch.streams.app import Edge, Grouping, InstanceGraph, Operator, StreamApp, parallelize
from repro_torch.streams.placement import round_robin
from repro_torch.streams.simulator import CompiledSim, compile_sim
from repro_torch.streams.workloads import (
    PAPER_CAPS_MBPS,
    trending_topics,
    trucking_iot,
)


@dataclasses.dataclass
class Scenario:
    """One fully-specified simulation setup (pre-compilation)."""

    name: str
    graph: InstanceGraph
    topo: Topology
    placement: np.ndarray
    schedule: LinkSchedule | None = None   # in-run capacity dynamics
    reroute: bool = False                  # SDN rerouting around failures

    def compile(self, device: "str | torch.device | None" = None
                ) -> CompiledSim:
        return compile_sim(self.graph, self.topo, self.placement,
                           schedule=self.schedule, reroute=self.reroute,
                           device=device)


def compile_fleet(scenarios: list[Scenario],
                  device: "str | torch.device | None" = None
                  ) -> list[CompiledSim]:
    return [s.compile(device) for s in scenarios]


# ---------------------------------------------------------------- topology
def degrade_links(topo: Topology, link_ids: np.ndarray,
                  factor: float) -> Topology:
    """Copy of ``topo`` with the given links' capacity scaled by ``factor``
    (0 < factor ≤ 1): a soft link failure / brown-out."""
    hit = set(int(i) for i in link_ids)
    links = [
        Link(l.name, l.kind, l.capacity * (factor if i in hit else 1.0))
        for i, l in enumerate(topo.links)
    ]
    return dataclasses.replace(topo, links=links)


# ------------------------------------------------------------ random DAGs
def random_app(seed: int, max_depth: int = 4, max_parallelism: int = 3,
               name: str | None = None) -> StreamApp:
    """A random layered stream DAG: source → chain of operators with random
    parallelism / selectivity / joins / groupings → sink. Matches the shape
    distribution of the paper's apps (Fig. 7) without their tuning."""
    rng = np.random.default_rng(seed)
    depth = int(rng.integers(1, max_depth + 1))
    ops = [Operator("src", int(rng.integers(1, max_parallelism + 1)),
                    gen_rate=float(rng.uniform(0.5, 3.0)), proc_rate=100.0)]
    edges = []
    prev = "src"
    for k in range(depth):
        nm = f"op{k}"
        ops.append(Operator(
            nm, int(rng.integers(1, max_parallelism + 1)), proc_rate=100.0,
            selectivity=float(rng.uniform(0.3, 1.5)),
            join=bool(rng.integers(0, 2)),
        ))
        edges.append(Edge(
            prev, nm,
            rng.choice([Grouping.SHUFFLE, Grouping.KEY, Grouping.GLOBAL]),
            key_skew=float(rng.uniform(0.0, 1.0)),
        ))
        prev = nm
    ops.append(Operator("sink", 1, proc_rate=100.0, selectivity=0.0))
    edges.append(Edge(prev, "sink", Grouping.GLOBAL))
    return StreamApp(name or f"rand{seed}", ops, edges, tuples_per_mb=1000.0)


def random_scenarios(n: int, seed: int = 0, n_machines: int = 8,
                     cap_range: tuple[float, float] = (0.75, 3.0)
                     ) -> list[Scenario]:
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        app_seed = int(rng.integers(0, 2**31 - 1))
        g = parallelize(random_app(app_seed), seed=app_seed)
        topo = big_switch(n_machines, float(rng.uniform(*cap_range)))
        out.append(Scenario(f"rand{k}", g, topo,
                            round_robin(g, n_machines)))
    return out


# ------------------------------------------------------- paper-grid sweeps
_SEED_APPS = {"TT": trending_topics, "TI": trucking_iot}


def capacity_sweep(caps: dict[str, float] = PAPER_CAPS_MBPS,
                   multihop: bool = False, n_machines: int = 8,
                   seed: int = 0) -> list[Scenario]:
    """The paper's §VI grid: {TT, TI} × {10, 15, 20 Mbps}, single-hop
    (up/downlink bottleneck) or multi-hop (throttled fat-tree internals)."""
    out = []
    for app_name, mk in _SEED_APPS.items():
        g = parallelize(mk(), seed=seed)
        for cap_name, cap in caps.items():
            if multihop:
                topo = fat_tree(up=12.5).set_capacity(LinkKind.INTERNAL, cap)
            else:
                topo = big_switch(n_machines, cap)
            hop = "multihop" if multihop else "singlehop"
            out.append(Scenario(
                f"{app_name}_{cap_name}_{hop}", g, topo,
                round_robin(g, topo.n_machines)))
    return out


def link_failure_sweep(n: int = 6, seed: int = 0, fail_frac: float = 0.25,
                       degrade: float = 0.1, cap: float = 1.875,
                       in_run: bool = False, t_fail: float = 60.0,
                       t_recover: float = 90.0,
                       reroute: bool = False) -> list[Scenario]:
    """Seed workloads on a fat-tree with a random ``fail_frac`` of links
    degraded to ``degrade``× capacity — does the allocator route value
    (not just bytes) around brown-outs?

    ``in_run=False``: the degradation holds for the whole run (the original
    steady-state form — kept as the parity oracle for the scheduled path).
    ``in_run=True``: links fail at ``t_fail`` and recover at ``t_recover``
    *inside* the run, so the result traces the controller's transient
    (dip depth / recovery time, the paper's Fig. 5/12 regime).
    ``reroute=True`` (implies ``in_run``): the SDN controller additionally
    *reroutes* around the failure via a precompiled route bank
    (:class:`~repro_torch.net.topology.RouteSchedule`); failures are drawn from
    the internal links only, so a surviving alternate core path exists —
    the regime where rerouting (not just re-allocating) pays."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        app_name = ("TT", "TI")[k % 2]
        g = parallelize(_SEED_APPS[app_name](), seed=seed)
        topo = fat_tree(up=12.5).set_capacity(LinkKind.INTERNAL, cap)
        if reroute:
            internal = np.flatnonzero(topo.link_kinds == int(LinkKind.INTERNAL))
            n_fail = max(1, int(fail_frac * internal.size))
            failed = rng.choice(internal, size=n_fail, replace=False)
            sched = link_failure_schedule(topo, failed, t_fail, t_recover,
                                          degrade)
            out.append(Scenario(
                f"{app_name}_failreroute{k}", g, topo,
                round_robin(g, topo.n_machines), schedule=sched,
                reroute=True))
            continue
        n_fail = max(1, int(fail_frac * topo.n_links))
        failed = rng.choice(topo.n_links, size=n_fail, replace=False)
        if in_run:
            sched = link_failure_schedule(topo, failed, t_fail, t_recover,
                                          degrade)
            out.append(Scenario(
                f"{app_name}_failrun{k}", g, topo,
                round_robin(g, topo.n_machines), schedule=sched))
        else:
            out.append(Scenario(
                f"{app_name}_fail{k}", g, degrade_links(topo, failed, degrade),
                round_robin(g, topo.n_machines)))
    return out


def time_varying_sweep(n_phases: int = 8, base_cap: float = 1.875,
                       amplitude: float = 0.4, app: str = "TT",
                       seed: int = 0, in_run: bool = False,
                       period_s: float = 120.0) -> list[Scenario]:
    """A diurnal-style capacity cycle.

    ``in_run=False``: sampled at ``n_phases`` points — link capacity =
    base·(1 + amplitude·sin(2π·phase/n_phases)), one scenario per phase;
    the batch axis *is* the time axis (each phase is long against the 5 s
    controller interval, so quasi-static). Kept as the steady-state oracle.
    ``in_run=True``: the cycle runs *inside* each scenario (period
    ``period_s``, one scenario per starting phase), so the controller
    tracks a genuinely moving capacity."""
    g = parallelize(_SEED_APPS[app](), seed=seed)
    out = []
    for p in range(n_phases):
        if in_run:
            topo = big_switch(8, base_cap)
            sched = diurnal_schedule(topo, period_s, amplitude,
                                     phase=2 * np.pi * p / n_phases)
            out.append(Scenario(f"{app}_cyclerun{p}", g, topo,
                                round_robin(g, 8), schedule=sched))
        else:
            cap = base_cap * (1.0 + amplitude
                              * np.sin(2 * np.pi * p / n_phases))
            topo = big_switch(8, float(cap))
            out.append(Scenario(f"{app}_phase{p}", g, topo,
                                round_robin(g, 8)))
    return out


def seed_fleet(seed: int = 0) -> list[Scenario]:
    """The default ≥16-scenario corpus: paper grid (single- and multi-hop),
    link failures (steady-state *and* in-run), capacity cycles (sampled
    *and* in-run), and random DAGs."""
    return (
        capacity_sweep(multihop=False, seed=seed)            # 6
        + capacity_sweep(multihop=True, seed=seed)           # 6
        + link_failure_sweep(n=4, seed=seed)                 # 4
        + time_varying_sweep(n_phases=4, seed=seed)          # 4
        + random_scenarios(4, seed=seed)                     # 4
        + link_failure_sweep(n=2, seed=seed, in_run=True)    # 2
        + time_varying_sweep(n_phases=2, seed=seed,
                             in_run=True)                    # 2
    )


def campaign_fleet(n: int, seed: int = 0, n_machines: int = 8,
                   n_fail: int = 2) -> list[Scenario]:
    """Parameterized campaign corpus for the streaming runtime: tile
    {TT, TI} × the paper's capacity grid × {static, in-run link failure,
    in-run diurnal cycle} to exactly ``n`` scenarios, with a seeded rng
    jittering the per-scenario knobs (failed links and failure window,
    cycle phase/period/amplitude) so every scenario is distinct.

    The tiling deliberately spans only 6 distinct padded shapes (2 app
    graphs × {no schedule, ``n_fail``-event schedule, 1-sinusoid
    schedule}), so however large ``n`` grows the bucket plan and the
    per-bucket staging shapes stay fixed — the property
    ``FleetRunner.run_campaign`` exploits to stream 10³–10⁴ scenarios
    through a handful of bucket shapes.
    """
    rng = np.random.default_rng(seed)
    caps = list(PAPER_CAPS_MBPS.values())
    out = []
    for k in range(n):
        app_name = ("TT", "TI")[k % 2]
        g = parallelize(_SEED_APPS[app_name](), seed=seed)
        cap = caps[(k // 2) % len(caps)]
        kind = ("static", "fail", "diurnal")[(k // (2 * len(caps))) % 3]
        topo = big_switch(n_machines, cap)
        if kind == "fail":
            failed = rng.choice(topo.n_links, size=n_fail, replace=False)
            t_fail = float(rng.uniform(50.0, 70.0))
            sched = link_failure_schedule(
                topo, failed, t_fail,
                t_fail + float(rng.uniform(20.0, 40.0)),
                float(rng.uniform(0.05, 0.3)))
        elif kind == "diurnal":
            sched = diurnal_schedule(
                topo, period_s=float(rng.uniform(80.0, 160.0)),
                amplitude=float(rng.uniform(0.2, 0.5)),
                phase=float(rng.uniform(0.0, 2.0 * np.pi)))
        else:
            sched = None
        out.append(Scenario(f"{app_name}_{kind}{k}", g, topo,
                            round_robin(g, n_machines), schedule=sched))
    return out


def bench_fleet(seed: int = 0, n_random: int = 16) -> list[Scenario]:
    """The canonical 44-scenario benchmark corpus: :func:`seed_fleet` plus
    ``n_random`` extra random DAGs (fixed generator seed 42, matching the
    reference's fleet benchmark). The same scenarios as the reference's
    ``bench_fleet``, so the two packages' fleets can be compared."""
    return seed_fleet(seed=seed) + random_scenarios(n_random, seed=42)
