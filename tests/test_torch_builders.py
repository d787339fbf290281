"""The port's numpy builders (topology, schedules, route banks, apps,
workloads, placements, scenarios) and its ``compile_sim`` against the JAX
package's, held to exact array equality."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro.net.topology as jt
import repro.streams.app as japp
import repro.streams.placement as jpl
import repro.streams.scenarios as jsc
import repro.streams.workloads as jwl
import repro_torch.net.topology as pt
import repro_torch.streams.app as papp
import repro_torch.streams.placement as ppl
import repro_torch.streams.scenarios as psc
import repro_torch.streams.workloads as pwl
from _torch_parity import CPU, port_sim
from repro.streams.simulator import compile_sim as j_compile
from repro_torch.streams.simulator import DATA_FIELDS, sim_from_numpy
from repro_torch.streams.simulator import compile_sim as p_compile


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_topology(a, b):
    _eq(a.capacities, b.capacities)
    _eq(a.link_kinds, b.link_kinds)
    for f in ("uplink_idx", "downlink_idx", "rack_of", "rack_to_core_idx",
              "core_to_rack_idx"):
        _eq(getattr(a, f), getattr(b, f))
    assert a.n_cores == b.n_cores and a.n_machines == b.n_machines
    assert [l.name for l in a.links] == [l.name for l in b.links]


TOPOS = {
    "big_switch": lambda m: m.big_switch(8, 1.25),
    "big_switch_asym": lambda m: m.big_switch(5, 2.0, 3.0),
    "fat_tree": lambda m: m.fat_tree(),
    "fat_tree_dc": lambda m: m.fat_tree(n_racks=4, machines_per_rack=4,
                                        n_cores=3, up=1.875, internal=7.5),
    # the JAX package's default TPU rates, given to both
    "tpu_pod": lambda m: m.tpu_pod_fabric(3, 4, ici_gbps=50.0,
                                          dcn_gbps=6.25),
    "throttled": lambda m: m.fat_tree(up=12.5).set_capacity(
        m.LinkKind.INTERNAL, 1.875),
}


class TestTopology:
    @pytest.mark.parametrize("name", sorted(TOPOS))
    def test_topology_and_routing(self, name):
        a, b = TOPOS[name](jt), TOPOS[name](pt)
        _same_topology(a, b)
        rng = np.random.default_rng(len(name))
        flows = [(int(s), int(d)) for s, d in
                 rng.integers(0, a.n_machines, (40, 2))]
        _eq(a.routing_matrix(flows), b.routing_matrix(flows))
        down = rng.random(a.n_links) < 0.2
        for s, d in flows:
            assert a.route_avoiding(s, d, down) == b.route_avoiding(s, d,
                                                                    down)

    def test_link_schedule_caps_at(self):
        a_topo, b_topo = jt.fat_tree(), pt.fat_tree()
        sa = (jt.link_failure_schedule(a_topo, [0, 3, 3], 0.1, 30.0, 0.5)
              .with_diurnal(60.0, 0.3, phase=0.4)
              .with_event([5], 10.0, np.inf, 0.0))
        sb = (pt.link_failure_schedule(b_topo, [0, 3, 3], 0.1, 30.0, 0.5)
              .with_diurnal(60.0, 0.3, phase=0.4)
              .with_event([5], 10.0, np.inf, 0.0))
        for f in dataclasses.fields(sa):
            _eq(getattr(sa, f.name), getattr(sb, f.name))
        ts = np.arange(0, 100, 0.05)
        _eq(sa.caps_at(a_topo.capacities, ts),
            sb.caps_at(b_topo.capacities, ts))
        _eq(sa.caps_at(a_topo.capacities, 0.1),
            sb.caps_at(b_topo.capacities, 0.1))
        da = jt.diurnal_schedule(a_topo, 120.0, 0.4, kind=jt.LinkKind.UPLINK)
        db = pt.diurnal_schedule(b_topo, 120.0, 0.4, kind=pt.LinkKind.UPLINK)
        _eq(da.caps_at(a_topo.capacities, ts),
            db.caps_at(b_topo.capacities, ts))
        for mk in ("constant", "empty"):
            for f in dataclasses.fields(sa):
                _eq(getattr(getattr(jt.LinkSchedule, mk)(4), f.name),
                    getattr(getattr(pt.LinkSchedule, mk)(4), f.name))

    def test_route_schedule_from_events(self):
        a_topo, b_topo = jt.fat_tree(), pt.fat_tree()
        rng = np.random.default_rng(1)
        flows = [(int(s), int(d)) for s, d in rng.integers(0, 8, (24, 2))]
        internal = np.flatnonzero(a_topo.link_kinds == 2)
        ev = [int(internal[0]), int(internal[5])]
        ra = jt.RouteSchedule.from_events(
            a_topo, flows, jt.link_failure_schedule(a_topo, ev, 20.0, 50.0))
        rb = pt.RouteSchedule.from_events(
            b_topo, flows, pt.link_failure_schedule(b_topo, ev, 20.0, 50.0))
        for f in ("t0", "state", "routes", "down"):
            _eq(getattr(ra, f), getattr(rb, f))
        assert ra.n_states > 1
        for t in (0.0, 19.9, 20.0, 49.9, 50.0, 99.0):
            assert ra.state_at(t) == rb.state_at(t)


def _same_graph(a, b):
    for f in ("op_of_inst", "src_of_flow", "dst_of_flow", "edge_of_flow",
              "w_out", "proc_rate", "selectivity", "gen_rate", "is_join",
              "is_sink"):
        _eq(getattr(a, f), getattr(b, f))
    assert a.inst_names == b.inst_names
    _eq(a.in_matrix(), b.in_matrix())


def _same_app(a, b):
    assert a.name == b.name and a.tuples_per_mb == b.tuples_per_mb
    assert ([dataclasses.astuple(o) for o in a.operators]
            == [dataclasses.astuple(o) for o in b.operators])
    assert len(a.edges) == len(b.edges)
    for ea, eb in zip(a.edges, b.edges):
        assert (ea.src, ea.dst, ea.grouping.value, ea.weight, ea.key_skew,
                ea.join_share, ea.droppable) == (
                    eb.src, eb.dst, eb.grouping.value, eb.weight,
                    eb.key_skew, eb.join_share, eb.droppable)


class TestAppsAndPlacement:
    def test_workload_catalog(self):
        assert jwl.PAPER_CAPS_MBPS == pwl.PAPER_CAPS_MBPS
        assert sorted(jwl.WORKLOADS) == sorted(pwl.WORKLOADS)

    @pytest.mark.parametrize("name", ["TT", "TI", "tags", "motivation",
                                      "TT_dc", "rand"])
    def test_parallelize_and_paths(self, name):
        if name == "TT_dc":
            mk = lambda m: m.trending_topics(parallelism=8, n_wct=16,
                                             tweets_per_sec=4800.0)
            ja, pa = mk(jwl), mk(pwl)
        elif name == "rand":
            ja, pa = jsc.random_app(123), psc.random_app(123)
        else:
            ja, pa = jwl.WORKLOADS[name](), pwl.WORKLOADS[name]()
        _same_app(ja, pa)
        for seed in (0, 7):
            ga, gb = japp.parallelize(ja, seed=seed), papp.parallelize(
                pa, seed=seed)
            _same_graph(ga, gb)
            _eq(japp.source_sink_paths(ga), papp.source_sink_paths(gb))
            _eq(jpl._steady_state_flow_volume(ga),
                ppl._steady_state_flow_volume(gb))
            for m in (3, 8):
                _eq(ga.flow_pairs(jpl.round_robin(ga, m)),
                    gb.flow_pairs(ppl.round_robin(gb, m)))
                for strat in ("round_robin", "packed", "traffic_aware"):
                    _eq(jpl.STRATEGIES[strat](ga, m),
                        ppl.STRATEGIES[strat](gb, m))
                _eq(jpl.random_placement(ga, m, seed=seed),
                    ppl.random_placement(gb, m, seed=seed))

    def test_traffic_aware_cap(self):
        ga = japp.parallelize(jwl.trending_topics(), seed=0)
        gb = papp.parallelize(pwl.trending_topics(), seed=0)
        _eq(jpl.traffic_aware(ga, 8, cap_per_machine=2),
            ppl.traffic_aware(gb, 8, cap_per_machine=2))
        with pytest.raises(ValueError, match="cap_per_machine"):
            ppl.traffic_aware(gb, 2, cap_per_machine=1)


@functools.lru_cache(maxsize=None)
def _fleets():
    ja = jsc.seed_fleet() + jsc.link_failure_sweep(n=1, in_run=True,
                                                  reroute=True)
    pb = psc.seed_fleet() + psc.link_failure_sweep(n=1, in_run=True,
                                                  reroute=True)
    return ja, pb


N_SCENARIOS = 28 + 1


class TestCompileSim:
    @pytest.mark.parametrize("k", range(N_SCENARIOS))
    def test_compile_fields_match(self, k):
        ja, pb = _fleets()
        assert len(ja) == len(pb) == N_SCENARIOS
        assert ja[k].name == pb[k].name
        js, ps = ja[k].compile(), pb[k].compile(device=CPU)
        for f in DATA_FIELDS:
            _eq(getattr(ps, f).numpy(), np.asarray(getattr(js, f)))
        assert (ps.tuples_per_mb, ps.n_apps) == (js.tuples_per_mb,
                                                 js.n_apps)
        assert (ps.is_dynamic, ps.is_rerouting) == (js.is_dynamic,
                                                    js.is_rerouting)

    def test_reroute_case_has_a_bank(self):
        _, pb = _fleets()
        assert pb[-1].compile(device=CPU).is_rerouting

    def test_sim_from_numpy_matches_compile(self):
        g = papp.parallelize(pwl.trucking_iot(), seed=0)
        topo = pt.big_switch(8, 1.875)
        sched = pt.link_failure_schedule(topo, [0, 1], 50.0, 70.0, 0.1)
        ps = p_compile(g, topo, ppl.round_robin(g, 8), schedule=sched,
                       device=CPU)
        back = sim_from_numpy({f: getattr(ps, f).numpy()
                               for f in DATA_FIELDS},
                              tuples_per_mb=ps.tuples_per_mb,
                              n_apps=ps.n_apps, device=CPU)
        for f in DATA_FIELDS:
            a, b = getattr(ps, f), getattr(back, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
        # and from the reference's own compiled state
        gj = japp.parallelize(jwl.trucking_iot(), seed=0)
        tj = jt.big_switch(8, 1.875)
        js = j_compile(gj, tj, jpl.round_robin(gj, 8),
                       schedule=jt.link_failure_schedule(tj, [0, 1], 50.0,
                                                         70.0, 0.1))
        via = port_sim(js)
        for f in DATA_FIELDS:
            _eq(getattr(via, f).numpy(), getattr(ps, f).numpy())

    def test_compile_rejects_poison(self):
        g = papp.parallelize(pwl.trending_topics(), seed=0)
        topo = pt.big_switch(8, float("nan"))
        with pytest.raises(ValueError, match="capacities"):
            p_compile(g, topo, ppl.round_robin(g, 8), device=CPU)

    def test_cuda_default_without_card_raises(self):
        # the entry points default to the card and never fall back to the
        # CPU silently
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        g = papp.parallelize(pwl.trending_topics(), seed=0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            p_compile(g, pt.big_switch(8, 1.25), ppl.round_robin(g, 8))
