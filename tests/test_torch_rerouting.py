"""The rerouting path at datacenter sizes. The routes and route banks are
built for all flows at once (``Topology.path_links``), and equal the
per-flow ``route`` and ``route_avoiding`` they replace, with ends, cores
or nothing left to route around. The campaign's counters, on a tiny
NEXmark Q4 pod whose aggregation links fail and are routed around:
``route_bank_bytes``
is the bytes of every route bank packed for the card, padding included,
and ``route_gather_bytes`` is rows × flows × links × 4 for every tick of a
chunk that carries a bank; a static chunk gathers nothing. The staging
records a ``pack_routes`` span inside each ``stage``. On a card the counts
are the same whether a chunk runs eager or replays its graph."""
import functools
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.net.topology import (
    RouteSchedule,
    big_switch,
    fat_tree,
    link_failure_schedule,
)
from repro_torch.streams import (
    FleetRunner,
    compile_sim,
    nexmark_q4,
    parallelize,
    round_robin,
)

SECONDS, DT = 10.0, 0.5
N_TICKS = int(SECONDS / DT)
KW = dict(seconds=SECONDS, dt=DT, solver="waterfill", chunk_rows=4,
          t_event=3.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _sims():
    """Five rerouting scenarios on a 4 × 4 pod with 4 cores, then two
    static ones on the same pod."""
    topo = fat_tree(4, 4, 4, up=125.0, internal=125.0)
    internal = np.arange(32, topo.n_links)
    rng = np.random.default_rng(5)
    sims = []
    for k in range(7):
        graph = parallelize(nexmark_q4(2, 6, 8, 5, 307.4, 942.6), seed=k)
        sched = None
        if k < 5:
            sched = link_failure_schedule(
                topo, sorted(rng.choice(internal, 2, replace=False)), 2.5,
                2.5 + 4.0, 0.1)
        sims.append(compile_sim(graph, topo, round_robin(graph, topo.n_machines),
                                schedule=sched, reroute=k < 5, device="cpu"))
    return sims


@pytest.mark.parametrize("topo", [fat_tree(4, 4, 4), fat_tree(6, 3, 5),
                                  big_switch(7, 1.0)], ids=("pod", "odd", "switch"))
@pytest.mark.parametrize("p_down", [0.0, 0.1, 0.4, 1.0])
def test_routes_of_all_flows_are_the_per_flow_routes(topo, p_down):
    rng = np.random.default_rng(int(100 * p_down) + topo.n_links)
    flows = [(int(s), int(d)) for s, d in
             rng.integers(0, topo.n_machines, (300, 2))]
    want = np.zeros((len(flows), topo.n_links))
    for f, (s, d) in enumerate(flows):
        want[f, topo.route(s, d)] = 1.0
    np.testing.assert_array_equal(topo.routing_matrix(flows), want)
    down = rng.random(topo.n_links) < p_down
    links, used, ok = topo.path_links(*np.array(flows).T, down)
    for f, (s, d) in enumerate(flows):
        p = topo.route_avoiding(s, d, down)
        assert ok[f] == (p is not None)
        if p is not None:
            assert list(links[f][used[f]]) == p


def test_route_bank_is_the_per_flow_reroute():
    topo = fat_tree(4, 4, 4)
    rng = np.random.default_rng(3)
    flows = [(int(s), int(d)) for s, d in rng.integers(0, 16, (200, 2))]
    sched = (link_failure_schedule(topo, [33, 40, 50], 5.0, 9.0, 0.1)
             .with_event([0, 60], 7.0, 12.0, 0.0))
    rs = RouteSchedule.from_events(topo, flows, sched)
    assert rs.n_states == 4
    for k, dwn in enumerate(rs.down):
        want = topo.routing_matrix(flows).astype(np.float32)
        for f, (s, d) in enumerate(flows):
            p = topo.route_avoiding(s, d, dwn)
            if p is not None:
                want[f] = 0.0
                want[f, p] = 1.0
        np.testing.assert_array_equal(rs.routes[k], want)


def _banks(monkeypatch):
    """Every route bank the runner packs, as (shape, bytes)."""
    seen = []
    fill = FleetRunner._fill_bucket

    def recorded(*a, **kw):
        leaves = fill(*a, **kw)
        seen.append((leaves["route_bank"].shape, leaves["route_bank"].nbytes))
        return leaves
    monkeypatch.setattr(FleetRunner, "_fill_bucket", staticmethod(recorded))
    return seen


def _expected(seen):
    bank = sum(n for _, n in seen)
    gather = sum(N_TICKS * rows * F * L * 4
                 for (rows, sr, F, L), _ in seen if sr)
    return bank, gather


def test_counters_are_the_packed_banks_and_their_gathers(monkeypatch):
    seen = _banks(monkeypatch)
    runner = FleetRunner(device="cpu", tick_overhead=15e3)
    with tracing.recording() as rec:
        runner.run_campaign(_sims(), "appaware", **KW)
    st = runner.last_stats
    assert st["n_buckets"] == 2 and st["n_chunks"] == len(seen) == 3
    assert any(sr for (_, sr, _, _), _ in seen)
    assert any(not sr for (_, sr, _, _), _ in seen)
    assert (st["route_bank_bytes"], st["route_gather_bytes"]) == _expected(seen)
    assert st["route_bank_bytes"] > 0 and st["route_gather_bytes"] > 0
    by_id = {s.id: s for s in rec.spans}
    packs = [s for s in rec.spans if s.name == "pack_routes"]
    assert len(packs) == 3
    assert all(by_id[s.parent].name == "stage" for s in packs)


def test_a_static_campaign_gathers_nothing(monkeypatch):
    seen = _banks(monkeypatch)
    runner = FleetRunner(device="cpu", tick_overhead=15e3)
    runner.run_campaign(_sims()[5:], "appaware", **KW)
    st = runner.last_stats
    assert (st["route_bank_bytes"], st["route_gather_bytes"]) == (0, 0)
    assert all(sr == 0 for (_, sr, _, _), _ in seen)


def test_a_dropped_runner_frees_its_slots_without_the_cycle_collector():
    """A campaign leaves no reference cycle through the runner: its pinned
    slots (13 GB in the pod cell) and graphs go with its last reference,
    not when the cyclic collector next runs."""
    runner = FleetRunner(device="cpu", tick_overhead=15e3)
    gc.collect()
    gc.disable()
    try:
        runner.run_campaign(_sims(), "appaware", **KW)
        slots = weakref.ref(next(iter(runner._campaign_bufs.values()))["route_bank"])
        gone = weakref.ref(runner)
        del runner
        assert gone() is None and slots() is None
    finally:
        gc.enable()


@pytest.mark.gpu
def test_replayed_chunks_count_as_eager_ones(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seen = _banks(monkeypatch)
    runner = FleetRunner(device="cuda", tick_overhead=15e3)
    runner.run_campaign(_sims(), "appaware", **KW)
    first = dict(runner.last_stats)
    assert (first["route_bank_bytes"], first["route_gather_bytes"]) == _expected(seen)
    seen.clear()
    runner.run_campaign(_sims(), "appaware", **KW)
    st = runner.last_stats
    assert st["graph_tick_share"] == 1.0 and st["n_graph_fallbacks"] == 0
    assert (st["route_bank_bytes"], st["route_gather_bytes"]) == _expected(seen)
    assert (st["route_bank_bytes"], st["route_gather_bytes"]) == (
        first["route_bank_bytes"], first["route_gather_bytes"])
