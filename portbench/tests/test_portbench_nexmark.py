"""The NEXmark Q4 pod cell: its configuration's written app against the
port's builder, edge by edge; the cell cut to a 4 × 4-machine pod with 4
aggregation switches run whole on the CPU under the paper's allocator with
its failed aggregation links routed around, held to the reference; the
control and a planted fault that must fail it; and the readers of its two
per-layer metrics."""
import copy

import pytest

from portbench import control, program, run, scenario
from portbench.tests import tiny

CELL = "pod256-q4-fail-reroute"
SEED = 2**31 + 4242
# the pod's parallelism cut to a 16-machine pod: sources fill its first two
# racks, the join its last two, as 128 + 128 instances fill 256 machines
TINY = {"auction_src": 2, "bid_src": 6, "winning_bids": 8, "category_avg": 5,
        "sink": 1}
# at this size the port lies within 1.4e-6 of the float64 reference on
# every number (seeds 1, 2, 3, 99: CPU), the TF32 control 4.8e-5 to 4e-4
# off, so each limit sits between the two with room on both sides; a
# scenario that the float32 reference moves by a tenth of a limit is
# rounding's to decide
LIMITS = {"final_tput_mb_s": 1e-5, "avg_latency_s": 2e-5, "dip_depth": 3e-5,
          "recovery_time_s": 1e-3, "total_sink_mb": 1e-5}


def files() -> dict:
    return run.cell_files(tiny.bench(), CELL)


def tiny_files() -> dict:
    """The cell at a 4 × 4 pod (4 cores), 8 scenarios in chunks of 4, 30
    simulated seconds with the failure inside, the offered load 1.25× a
    link's as in the cell."""
    f = copy.deepcopy(files())
    cfg, tr = f["config"], f["traffic"]
    tiny.shorten(tr, cfg)
    cfg["fabric"] = dict(kind="fat_tree", n_racks=4, machines_per_rack=4,
                         n_cores=4)
    app = cfg["apps"]["q4"]
    joined = TINY["winning_bids"] * 1.25 * cfg["uplink_mb_s"][0]
    rates = {"auction_src": joined * 1500 / 6100, "bid_src": joined * 4600 / 6100}
    for o in app["operators"]:
        o["parallelism"] = TINY[o["name"]]
        o["gen_rate"] = rates.get(o["name"], 0.0)
    app["args"].update(auction_src=TINY["auction_src"], bid_src=TINY["bid_src"],
                       winning_bids=TINY["winning_bids"],
                       categories=TINY["category_avg"],
                       auction_mb_s=rates["auction_src"], bid_mb_s=rates["bid_src"])
    tr.update(scenarios=8, chunk_rows=4)
    f["checks"] = {"excuse": "float32", "limits": LIMITS,
                   "excuse_over": {n: 0.1 * v for n, v in LIMITS.items()}}
    return f


def test_builder_is_the_written_app():
    cfg = files()["config"]
    spec = cfg["apps"]["q4"]
    app = program.build_app(cfg, "q4")
    assert app.tuples_per_mb == spec["tuples_per_mb"]
    assert len(app.operators) == len(spec["operators"])
    for o, w in zip(app.operators, spec["operators"]):
        assert (o.name, o.parallelism, o.proc_rate, o.selectivity, o.gen_rate,
                o.join) == (w["name"], w["parallelism"], w["proc_rate"],
                            w["selectivity"], w["gen_rate"], w["join"])
    assert len(app.edges) == len(spec["edges"])
    for e, w in zip(app.edges, spec["edges"]):
        assert (e.src, e.dst, e.grouping.value, e.weight, e.key_skew,
                e.join_share, e.droppable) == (
                    w["src"], w["dst"], w["grouping"], w["weight"],
                    w["key_skew"], w["join_share"], w["droppable"])


def test_the_pod_has_the_sizes_it_states():
    from repro_torch.streams import parallelize, round_robin

    cfg = files()["config"]
    sc = scenario.draw(cfg, files()["traffic"], SEED)[0]
    fab = scenario.fabric_of(sc.fabric)
    graph = parallelize(program.build_app(cfg, "q4"), seed=sc.skew_seed)
    sizes = cfg["sizes"]
    assert (fab.n_machines, fab.n_links) == (sizes["machines"], sizes["links"])
    assert int((fab.kinds == scenario.INTERNAL).sum()) == sizes["internal_links"]
    assert graph.n_flows == sizes["flows"]["q4"]
    assert graph.n_instances == sizes["instances"]
    # sources on the pod's first half, the join on its second: the shuffle
    # crosses between edge switches, and no downlink takes it all
    m = round_robin(graph, fab.n_machines)
    dst = m[graph.dst_of_flow[:sizes["flows"]["shuffle"]]]
    assert (fab.rack_of[dst] >= 8).all() and len(set(dst)) == 128
    # the failed links are aggregation links
    assert len(sc.failed) == 2 and all(fab.kinds[f] == scenario.INTERNAL
                                       for f in sc.failed)


def test_tiny_cell_is_correct():
    r = tiny.run_tiny(tiny_files(), seed=SEED)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 8
    assert set(r["metrics"]) == {"scenarios_per_s", "setup_s"}


def run_with(broken):
    f = tiny_files()
    with broken(f):
        return tiny.run_tiny(f, seed=SEED)


def test_control_is_not_correct():
    r = run_with(lambda f: control.reference_in_place(
        f["config"], f["traffic"], scenario.draw(f["config"], f["traffic"], SEED)))
    assert r["correct"] is False


def test_delivered_megabytes_one_percent_high_are_not_correct():
    assert run_with(lambda f: control.altered_sink())["correct"] is False


@pytest.mark.parametrize("name, key, scale", [("route_bank_mb", "route_bank_bytes", 1e6),
                                              ("route_gather_gb", "route_gather_bytes", 1e9)])
def test_readers(name, key, scale):
    read = run.load_module(run.reader_path(name)).read
    stats = [{key: 3 * scale, "n_ticks": 4}, {key: 5 * scale}]
    assert read(dict(stats=stats)) == pytest.approx(4.0)
    assert read(dict(stats=[{"n_ticks": 4}])) is None
    assert read(dict(stats=[])) is None
