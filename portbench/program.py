"""The system under test: the port's builders and entry points, fed the
benchmark's scenario descriptions. Everything of the port is imported
inside these functions, so the harness's own modules load without it."""
from __future__ import annotations

import numpy as np

from portbench.scenario import Scenario

# The fleet planner's per-tick overhead constant, given rather than timed,
# so that a cell's bucket plan is the same in every run and does not follow
# a timing probe on a busy host.
TICK_OVERHEAD_FLOPS = 2e3


def build_app(config: dict, name: str):
    """The port's ``StreamApp`` for the configuration's app ``name``, from
    the port's own builder with the configuration's arguments."""
    from repro_torch.streams import workloads

    spec = config["apps"][name]
    return getattr(workloads, spec["builder"])(**spec["args"])


def build_topology(fabric: dict):
    from repro_torch.net.topology import big_switch, fat_tree

    if fabric["kind"] == "big_switch":
        return big_switch(fabric["n_machines"], fabric["up"], fabric["down"])
    return fat_tree(fabric["n_racks"], fabric["machines_per_rack"],
                    fabric["n_cores"], up=fabric["up"], down=fabric["down"],
                    internal=fabric["internal"])


def compile_scenario(config: dict, sc: Scenario, device="cpu"):
    """The port's ``CompiledSim`` of ``sc``: its app, fabric, placement,
    schedule and route bank, through the port's builders and
    ``compile_sim``. Compiled on the host: the campaign stages host packs
    onto the card, and ``simulate`` moves the sim to the card itself."""
    from repro_torch.net.topology import diurnal_schedule, link_failure_schedule
    from repro_torch.streams import compile_sim, parallelize, round_robin

    graph = parallelize(build_app(config, sc.app), seed=sc.skew_seed)
    topo = build_topology(sc.fabric)
    sched = None
    if sc.failed:
        sched = link_failure_schedule(topo, list(sc.failed), sc.t_fail,
                                      sc.t_recover, sc.scale)
    elif sc.cycle:
        period, amp, phase = sc.cycle
        sched = diurnal_schedule(topo, period, amp, phase=phase)
    return compile_sim(graph, topo, round_robin(graph, topo.n_machines),
                       schedule=sched, reroute=sc.reroute, device=device)


class Job:
    """One job of a cell: one call into the port's entry point, ending when
    its answers are on the host. ``campaign``: one
    ``FleetRunner.run_campaign`` over every scenario of the cell, on one
    runner kept for the run (its plan and staging slots are what the
    program keeps by design); ``simulate``: one ``simulate`` of the next
    scenario in turn. ``seconds`` overrides the configuration's horizon
    (the warm-up job), and ``runner`` hands over an existing runner."""

    def __init__(self, sims: list, config: dict, traffic: dict, device,
                 seconds: float | None = None, runner=None):
        self.sims, self.traffic, self.device = sims, traffic, device
        self.kw = dict(policy=traffic["policy"], dt=float(config["dt_s"]),
                       seconds=float(config["horizon_s"] if seconds is None
                                     else seconds),
                       solver=traffic["solver"], t_event=float(traffic["t_event"]))
        self.runner = runner
        if traffic["entry"] == "campaign":
            if runner is None:
                from repro_torch.streams import FleetRunner
                self.runner = FleetRunner(device=device,
                                          tick_overhead=TICK_OVERHEAD_FLOPS)
        elif traffic["entry"] != "simulate":
            raise ValueError(f"unknown entry {traffic['entry']!r}")
        self.n = 0

    def __call__(self) -> dict:
        """Run the next job. Returns the scenarios it ran (``rows``, by
        index), their [rows, 7] ``metrics``, which of them the program
        quarantined (``bad``), the runner's ``stats``, and for ``simulate``
        the trajectories ``sink``, ``latency`` and ``link_load``."""
        k, self.n = self.n, self.n + 1
        if self.runner is None:
            from repro_torch.streams import simulate
            i = k % len(self.sims)
            res = simulate(self.sims[i], device=self.device, **self.kw)
            return dict(rows=[i], metrics=res.metrics[None].astype(np.float64),
                        bad=np.zeros(1, bool), stats=None,
                        sink=res.sink_mb[None], latency=res.latency[None],
                        link_load=res.link_load[None])
        tr = self.traffic
        out = self.runner.run_campaign(
            self.sims, chunk_rows=int(tr["chunk_rows"]), shard=bool(tr["shard"]),
            checkpoint=None, **self.kw)
        bad = np.zeros(len(self.sims), bool)
        bad[out.quarantined] = True
        return dict(rows=list(range(len(self.sims))),
                    metrics=out.metrics.astype(np.float64), bad=bad,
                    stats=dict(self.runner.last_stats))
