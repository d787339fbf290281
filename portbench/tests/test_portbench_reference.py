"""The plain reference and the frozen scenario description: hand-worked
solves, seeded draws, and agreement of the description with what the
port's own builders make of it."""
import numpy as np
import pytest
import torch

from portbench import program, scenario
from portbench.reference import sim
from portbench.tests import tiny


def one_link_batch(n_links: int, kinds):
    """A bare batch of one scenario with two flows, both on every link."""
    b = object.__new__(sim.Batch)
    b.S, b.F, b.L, b.I = 1, 2, n_links, 0
    b.dt_, b.dev, b.control = torch.float64, torch.device("cpu"), False
    b.offL = torch.zeros((1, 1), dtype=torch.int64)
    b.on_net = torch.ones((1, 2), dtype=torch.bool)
    b.kinds = torch.tensor([kinds])
    route = list(range(n_links)) + [n_links] * (4 - n_links)
    b.up = torch.zeros((1, 2), dtype=torch.int64)
    b.down = torch.full((1, 2), n_links - 1, dtype=torch.int64)
    b.decided = torch.zeros(1, dtype=torch.bool)
    return b, torch.tensor([[route, route]])


@pytest.mark.parametrize("demand, expect", [
    ((0.3, 5.0), (0.3, 0.7)),      # the small demand is met, the rest fills
    ((5.0, 5.0), (0.5, 0.5)),      # equal split
    ((0.2, 0.3), (0.2, 0.3)),      # the link does not saturate
])
def test_two_flows_one_link_maxmin(demand, expect):
    b, r = one_link_batch(1, [scenario.UPLINK])
    x = b.maxmin(r, torch.tensor([[1.0]], dtype=torch.float64),
                 torch.tensor([demand], dtype=torch.float64))
    assert x[0].tolist() == pytest.approx(expect, abs=1e-12)


def test_one_link_allocator_split(monkeypatch):
    """Eq. (3): an uplink of capacity 2 splits by demand 1 : 3. Eq. (4): a
    downlink of capacity 2 with backlogs 0 and 1 at drain 1 a second over
    an interval of 1 s fills to the level θ = 1.5: rates 1.5 and 0.5."""
    monkeypatch.setattr(sim, "BACKFILL_ITERS", 0)
    b, r = one_link_batch(2, [scenario.UPLINK, scenario.DOWNLINK])
    f = lambda *v: torch.tensor([v], dtype=torch.float64)
    args = dict(Qs=f(0.0, 0.0), B=f(0.0, 1.0), v=f(2.0, 4.0), ls=f(1.0, 1.0),
                lr=f(-1.0, -2.0), dta=1.0)
    assert b.allocate(r, f(2.0, 100.0), **args)[0].tolist() == pytest.approx(
        [0.5, 1.5], abs=1e-12)
    assert b.allocate(r, f(100.0, 2.0), **args)[0].tolist() == pytest.approx(
        [1.5, 0.5], abs=1e-12)
    assert not b.decided.any()


@pytest.mark.parametrize("v, B, lr, decided", [
    ((2.0, 4.0), (0.0, 1.0), (-1.0, -2.0), False),
    ((2.0, 3.0), (0.0, 1.0), (-1.0, -2.0), True),          # 3 - 1 - 2 = 0
    ((2.0, 3.0), (0.0, 1.0), (-1.0, -2.0 + 1e-9), True),   # a hair from it
    ((2.0, 3.0), (0.0, 1.0), (-1.0, -1.9), False),
])
def test_a_drain_estimate_of_equal_numbers_marks_its_scenario(v, B, lr, decided):
    """A drain estimate v − B + Lʳ that cancels to within ``TIE_SHARE`` of
    its operands leaves eq. (4)'s split to rounding: the scenario is marked
    as decided, and stays so."""
    b, r = one_link_batch(2, [scenario.UPLINK, scenario.DOWNLINK])
    f = lambda *x: torch.tensor([x], dtype=torch.float64)
    b.allocate(r, f(2.0, 2.0), Qs=f(0.0, 0.0), B=f(*B), v=f(*v), ls=f(1.0, 1.0),
               lr=f(*lr), dta=1.0)
    assert b.decided.tolist() == [decided]


def test_a_link_at_the_busy_threshold_is_a_utilization_tie():
    caps = np.ones((8, 3))
    load = np.full((8, 3), 0.25)
    assert not sim.utilization_tie(load, caps)
    load[:, 1] = 0.5 * (1 + 1e-6)
    assert sim.utilization_tie(load, caps)
    load[:, 1] = 0.8      # above the threshold, no link at it
    assert not sim.utilization_tie(load, caps)
    load[:] = 0.3          # none busy: the set is the links at 0.999 of the top
    load[:, 2] = 0.3 * 0.999
    assert sim.utilization_tie(load, caps)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_draws_follow_the_seed_and_keep_their_sizes(cell):
    f = tiny.tiny_files(cell)
    cfg, tr = f["config"], f["traffic"]
    a = scenario.draw(cfg, tr, 2**31 + 11)
    assert a == scenario.draw(cfg, tr, 2**31 + 11)
    b = scenario.draw(cfg, tr, 5)
    assert a != b and len(a) == len(b) == tr["scenarios"]
    assert [(s.app, s.kind, s.fabric) for s in a] == [
        (s.app, s.kind, s.fabric) for s in b]
    n_apps, ups = len(tr["apps"]), cfg["uplink_mb_s"]
    assert [s.fabric["up"] for s in a] == [
        ups[(k // n_apps) % len(ups)] for k in range(len(a))]
    fail = tr["fail"]
    for s in a:
        if s.kind != "fail":
            continue
        assert len(s.failed) == fail["count"]
        assert fail["t_fail"][0] <= s.t_fail <= fail["t_fail"][1]
        assert fail["duration"][0] <= s.t_recover - s.t_fail <= fail["duration"][1]
        assert fail["scale"][0] <= s.scale <= fail["scale"][1]
        if fail["links"] == "internal":
            kinds = scenario.fabric_of(s.fabric).kinds
            assert (kinds[list(s.failed)] == scenario.INTERNAL).all()
    if tr.get("shared_skew"):
        assert len({s.skew_seed for s in a}) == 1


@pytest.mark.parametrize("cell", tiny.CELLS[:2])
def test_description_agrees_with_the_ports_builders(cell):
    """The configuration's apps are what the port's builders make, and the
    frozen fabric, placement, routes (the rerouted ones too) and capacity
    schedule are the port's routing matrix, route bank and schedule."""
    f = tiny.tiny_files(cell)
    cfg = f["config"]
    for name, desc in cfg["apps"].items():
        app = program.build_app(cfg, name)
        assert [(o.name, o.parallelism, o.proc_rate, o.selectivity, o.gen_rate,
                 o.join) for o in app.operators] == [
            (o["name"], o["parallelism"], o["proc_rate"], o["selectivity"],
             o["gen_rate"], o["join"]) for o in desc["operators"]]
        assert [(e.src, e.dst, e.grouping.value, e.weight, e.key_skew,
                 e.join_share, e.droppable) for e in app.edges] == [
            (e["src"], e["dst"], e["grouping"], e["weight"], e["key_skew"],
             e["join_share"], e["droppable"]) for e in desc["edges"]]
        assert app.tuples_per_mb == desc["tuples_per_mb"]
    for sc in scenario.draw(cfg, f["traffic"], 77):
        got = program.compile_scenario(cfg, sc)
        fab = scenario.fabric_of(sc.fabric)
        assert np.array_equal(got.caps.numpy(), fab.caps.astype(np.float32))
        assert np.array_equal(got.kinds.numpy(), fab.kinds)
        built = sim.build(sc, cfg["apps"][sc.app], 240, 0.5)
        K = built["routes"].shape[0]
        dense = np.zeros((K, built["F"], fab.n_links + 1))
        for k in range(K):
            np.put_along_axis(dense[k], built["routes"][k], 1.0, axis=1)
        assert np.array_equal(dense[0, :, :-1], got.R.numpy())
        if got.is_rerouting:
            assert np.array_equal(dense[:, :, :-1], got.route_bank.numpy()[:K])
        else:
            assert K == 1
        assert np.allclose(built["p_in"], got.p_in.numpy(), rtol=1e-6)
        assert np.allclose(built["path_w"], got.path_w.numpy(), rtol=1e-6)
        if sc.kind != "static":
            from repro_torch.streams.simulator import _caps_over
            ts = torch.arange(240, dtype=torch.float32) * 0.5
            assert np.allclose(built["caps_t"], _caps_over(got, ts).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_every_scenario_is_held_unless_rounding_decides_it():
    """Each scenario is held to the limit, excused from every number only
    where the float32 reference departs on some number by more than its
    ``excuse_over`` or the float64 reference marks the run as decided, and
    from one entry where the epilogue sits at that entry's threshold."""
    from portbench.reference import compare
    checks = {"excuse": "float32",
              "excuse_over": {"avg_latency_s": 1e-5, "utilization": 1e-5},
              "limits": {"avg_latency_s": 1e-3, "utilization": 1e-3}}
    ref = {"metrics": np.ones((5, 7)), "decided": np.zeros(5, bool),
           "tie": np.zeros((5, 7), bool)}
    ref["decided"][4] = True
    ref["tie"][3, compare.METRICS.index("utilization")] = True
    prog = {"metrics": np.ones((5, 7)) + 0.5}
    prog["metrics"][0] = 1.0
    rounding = {"avg_latency_s": np.array([0.0, 0.0, 2e-5, 0.0, 0.0]),
                "utilization": np.zeros(5)}
    g = compare.gaps(prog, ref, checks, 120.0)
    assert g["avg_latency_s"].tolist() == pytest.approx([0.0, 0.5, 0.5, 0.5, 0.5])
    ex = compare.excused(ref, rounding, checks)
    assert ex["avg_latency_s"].tolist() == [False, False, True, False, True]
    assert ex["utilization"].tolist() == [False, False, True, True, True]
    over = compare.over(g, checks, ex)
    assert over["avg_latency_s"].tolist() == [False, True, False, True, False]
    assert over["utilization"].tolist() == [False, True, False, False, False]
    prog["metrics"][1, 2] = np.nan      # a gap that is not a number is over
    assert compare.over(compare.gaps(prog, ref, checks, 120.0), checks)[
        "avg_latency_s"][1]
