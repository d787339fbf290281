"""Instance placement strategies (paper §II-A.4).

A placement maps operator instances to machines; it fixes the communication
pattern (which flows are internal vs external, and which links they share).
The paper's motivation (Fig. 3) shows that placement alone is insufficient —
bandwidth allocation matters for *every* placement.
"""
from __future__ import annotations

import numpy as np

from repro_torch.streams.app import InstanceGraph


def round_robin(graph: InstanceGraph, n_machines: int) -> np.ndarray:
    """Storm's default EvenScheduler-like assignment."""
    return np.arange(graph.n_instances) % n_machines


def packed(graph: InstanceGraph, n_machines: int) -> np.ndarray:
    """Fill machines one by one (minimizes machines used, maximizes
    co-location — and uplink contention)."""
    per = -(-graph.n_instances // n_machines)
    return np.arange(graph.n_instances) // per


def random_placement(graph: InstanceGraph, n_machines: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_machines, graph.n_instances)


def traffic_aware(graph: InstanceGraph, n_machines: int,
                  cap_per_machine: int | None = None) -> np.ndarray:
    """Greedy T-Storm-like heuristic [11]: repeatedly co-locate the endpoints
    of the heaviest flow, subject to a per-machine instance cap. Minimizes
    external traffic; the paper argues this is orthogonal to (and still
    needs) bandwidth allocation.

    The cap binds on *every* placement: each fallback picks the
    least-loaded machine **under cap** (a bare ``argmin(load)`` silently
    exceeded a user-supplied ``cap_per_machine`` once every machine it
    preferred was full). An infeasible cap (``cap · n_machines <
    n_instances``) raises instead of over-packing quietly.
    """
    I = graph.n_instances
    cap = -(-I // n_machines) if cap_per_machine is None else cap_per_machine
    if cap * n_machines < I:
        raise ValueError(
            f"cap_per_machine={cap} cannot place {I} instances on "
            f"{n_machines} machines")
    # estimated flow volumes: propagate generation through selectivities
    vol = _steady_state_flow_volume(graph)
    order = np.argsort(-vol, kind="stable")
    machine = -np.ones(I, dtype=np.int64)
    load = np.zeros(n_machines, dtype=np.int64)

    def place(i: int, m: int):
        machine[i] = m
        load[m] += 1

    def least_loaded_under_cap() -> int:
        open_m = np.flatnonzero(load < cap)
        return int(open_m[np.argmin(load[open_m])])

    for f in order:
        s, d = int(graph.src_of_flow[f]), int(graph.dst_of_flow[f])
        ms, md = machine[s], machine[d]
        if ms < 0 and md < 0:
            m = least_loaded_under_cap()
            place(s, m)
            if load[m] < cap:
                place(d, m)
            else:
                place(d, least_loaded_under_cap())
        elif ms < 0:
            place(s, md if load[md] < cap else least_loaded_under_cap())
        elif md < 0:
            place(d, ms if load[ms] < cap else least_loaded_under_cap())
    for i in range(I):
        if machine[i] < 0:
            place(i, least_loaded_under_cap())
    return machine


def _steady_state_flow_volume(graph: InstanceGraph, iters: int = 32) -> np.ndarray:
    """Fixed point of out = (gen + selectivity·in)·W_out ignoring capacity —
    the open-loop steady-state MB/s per flow."""
    I, F = graph.w_out.shape
    M_in = graph.in_matrix()
    inflow = np.zeros(I)
    for _ in range(iters):
        out = graph.gen_rate + graph.selectivity * inflow
        flow = graph.w_out.T @ out
        inflow = M_in @ flow
    return graph.w_out.T @ (graph.gen_rate + graph.selectivity * inflow)


STRATEGIES = {
    "round_robin": round_robin,
    "packed": packed,
    "random": random_placement,
    "traffic_aware": traffic_aware,
}
