"""The port's fleet runner against the JAX package's, on the CPU.

The planner and the padding are numpy and shape logic: held to exact
equality with the reference's functions (given the same ``tick_overhead``
or calibration). Fleet rows are held to the port's own per-scenario
``simulate`` and to the reference's ``simulate_many`` at
``tests/test_fleet.py``'s tolerances (sink atol 1e-4, latency rtol 1e-4 atol
1e-3, link load atol 1e-4), for every policy; ``solver="waterfill"`` (its
plain version here) against ``"sort"`` at 2e-4 relative. The batched step
runs under ``torch.func.vmap`` with the "performance drop … batching rule"
warning raised as an error, so an op without a batching rule fails here."""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

import repro.streams as J
import repro.streams.fleet as jf
import repro_torch.streams.fleet as pf
from _torch_parity import CPU, port_sim
from repro_torch.core.allocator import LinkProgram, allocate
from repro_torch.core.flowstate import FlowState
from repro_torch.core.tcp import maxmin_fused_step, maxmin_order_init
from repro_torch.kernels.waterfill import ops
from repro_torch.net import big_switch, link_failure_schedule
from repro_torch.streams import (
    FleetRunner,
    FleetShape,
    compile_sim,
    pad_sim,
    parallelize,
    round_robin,
    simulate,
    simulate_many,
    stack_sims,
    trending_topics,
)
from repro_torch.streams import simulator as ps

DT = 0.5
SECONDS = 20.0
POLICIES = ("tcp", "appaware", "appfair", "fixed")


@pytest.fixture(autouse=True)
def _no_batching_fallback():
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield


@functools.lru_cache(maxsize=None)
def _fleets():
    """The seed fleet compiled by the reference, and the port's copies."""
    jsims = J.compile_fleet(J.seed_fleet(seed=0))
    return jsims, [port_sim(s) for s in jsims]


def _astuple(plan):
    return [(list(idxs), dataclasses.astuple(shape)) for idxs, shape in plan]


def _runner(**kw):
    return FleetRunner(device=CPU, tick_overhead=15e3, **kw)


def _x_fixed(sims, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.2, 3.0, s.R.shape[0]).astype(np.float32)
            for s in sims]


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.sink_mb, want.sink_mb, atol=atol)
    np.testing.assert_allclose(got.latency, want.latency, rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got.link_load, want.link_load, atol=atol)


class TestPlannerExact:
    @pytest.mark.parametrize("policy", POLICIES)
    @pytest.mark.parametrize("max_buckets", [1, 2, 4, 8])
    @pytest.mark.parametrize("tick_overhead", [0.0, 15e3, 1e6])
    def test_plan_buckets(self, policy, max_buckets, tick_overhead):
        jsims, psims = _fleets()
        kw = dict(exact_apps=policy == "appfair", policy=policy,
                  tick_overhead=tick_overhead)
        assert _astuple(pf._plan_buckets(psims, max_buckets, **kw)) == \
            _astuple(jf._plan_buckets(jsims, max_buckets, **kw))

    def test_shapes_and_flop_cost(self):
        jsims, psims = _fleets()
        for j, p in zip(jsims, psims):
            assert dataclasses.astuple(pf._sim_shape(p)) == \
                dataclasses.astuple(jf._sim_shape(j))
            for policy in POLICIES:
                assert pf._flop_cost(pf._sim_shape(p), policy) == \
                    jf._flop_cost(jf._sim_shape(j), policy)
        assert dataclasses.astuple(pf.FleetShape.cover(psims)) == \
            dataclasses.astuple(jf.FleetShape.cover(jsims))
        a, b = pf._sim_shape(psims[0]), pf._sim_shape(psims[-1])
        assert dataclasses.astuple(a.merge(b)) == dataclasses.astuple(
            jf._sim_shape(jsims[0]).merge(jf._sim_shape(jsims[-1])))

    @pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
    def test_round_rows(self, n_dev):
        for n in range(1, 140):
            assert pf._round_rows(n, n_dev) == jf._round_rows(n, n_dev)

    @pytest.mark.parametrize("policy", POLICIES)
    def test_auto_chunk_rows(self, policy):
        _, psims = _fleets()
        for vals in ((10.0, 20.0, 4.0, 3700.0), (38.0, 27.0, 75.0, 1371.0),
                     (1e4, 1e4, 1.0, 1.0)):
            jc = jf.BackendCalibration("cpu", *vals, 15e3, False, True)
            pc = pf.BackendCalibration("cpu", *vals, 15e3, False, True)
            assert pc.chunk_overhead_s == jc.chunk_overhead_s
            for s in psims[::5]:
                shape = pf._sim_shape(s)
                jshape = jf.FleetShape(*dataclasses.astuple(shape))
                for n_ticks in (12, 240, 1200):
                    assert pf._auto_chunk_rows(shape, policy, n_ticks, pc) \
                        == jf._auto_chunk_rows(jshape, policy, n_ticks, jc)

    def test_runner_plan_cached_per_policy(self):
        _, psims = _fleets()
        r = _runner()
        plan = r.plan(psims, "tcp")
        assert r.plan(list(psims), "tcp") is plan
        assert r.plan(psims, "fixed") is not plan
        # fixed ticks are cheap: overhead dominates and buckets collapse
        assert len(r.plan(psims, "fixed")) < len(plan) <= r.max_buckets


class TestPaddingExact:
    @pytest.mark.parametrize("k", [0, 3, 14, 20, 24, 26])
    def test_pad_sim(self, k):
        jsims, psims = _fleets()
        jshape = jf.FleetShape.cover(jsims)
        want = jf.pad_sim(jsims[k], jshape)
        got = pad_sim(psims[k], FleetShape(*dataclasses.astuple(jshape)))
        for f in ps.DATA_FIELDS:
            np.testing.assert_array_equal(got.__dict__[f].numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        assert got.n_apps == want.n_apps
        assert got.tuples_per_mb == want.tuples_per_mb

    def test_pad_route_fields_rerouting_bucket(self):
        # a static-routing sim entering a rerouting shape: base R in slot 0
        j = J.link_failure_sweep(n=1, in_run=True, reroute=True)[0].compile()
        jsims, psims = _fleets()
        for js, p in ((jsims[0], psims[0]), (j, port_sim(j))):
            F, L = 40, 40
            SR = max(j.route_bank.shape[0], 1) + 2
            for a, b in zip(pf._pad_route_fields(p, F, L, SR),
                            jf._pad_route_fields(js, F, L, SR)):
                np.testing.assert_array_equal(a, np.asarray(b))

    def test_pad1_pad2(self):
        a = np.arange(5, dtype=np.float32)
        for n, v in ((7, 0.0), (9, np.inf), (3, 1.0)):
            np.testing.assert_array_equal(pf._pad1(torch.tensor(a), n, v),
                                          jf._pad1(a, n, v))
        m = np.arange(12, dtype=np.float32).reshape(3, 4)
        for n0, n1 in ((5, 6), (3, 4), (2, 9)):
            np.testing.assert_array_equal(pf._pad2(torch.tensor(m), n0, n1),
                                          jf._pad2(m, n0, n1))

    def test_stack_sims(self):
        jsims, psims = _fleets()
        want, jshape = jf.stack_sims(jsims[:9])
        got, shape = stack_sims(psims[:9])
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshape)
        assert got.R.shape == (9, shape.n_flows, shape.n_links)
        for f in ps.DATA_FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)

    def test_fill_bucket_matches_stack(self):
        # the staging buffers hold exactly the padded stack; spare rows keep
        # the pad values (inert scenarios)
        _, psims = _fleets()
        shape = FleetShape.cover(psims[:5])
        bufs = pf.FleetRunner._fill_bucket({}, psims[:5], shape, 8)
        stacked, _ = stack_sims(psims[:5], shape)
        for f, (_, pad) in pf._FIELD_SPECS.items():
            np.testing.assert_array_equal(bufs[f][:5],
                                          getattr(stacked, f).numpy())
            assert (bufs[f][5:] == pad).all(), f

    def test_pad_rejects_shrinking_apps_and_poison(self):
        _, psims = _fleets()
        shape = FleetShape.cover(psims)
        with pytest.raises(ValueError, match="n_apps"):
            pad_sim(psims[0], dataclasses.replace(shape, n_apps=0))
        bad = psims[0].caps.clone()
        bad[0] = float("nan")
        with pytest.raises(ValueError, match="caps"):
            pad_sim(dataclasses.replace(psims[0], caps=bad), shape)
        dyn = next(s for s in psims if s.ev_t0.shape[0])
        ev = dyn.ev_t0.clone()
        ev[0] = -2.0
        with pytest.raises(ValueError, match="ev_t0"):
            pad_sim(dataclasses.replace(dyn, ev_t0=ev), FleetShape.cover([dyn]))

    @pytest.mark.parametrize("k", [0, 3])
    def test_pad_is_neutral(self, k):
        _, psims = _fleets()
        shape = FleetShape.cover(psims)
        raw = simulate(psims[k], "tcp", seconds=SECONDS, device=CPU)
        pad = simulate(pad_sim(psims[k], shape), "tcp", seconds=SECONDS,
                       device=CPU)
        np.testing.assert_allclose(pad.sink_mb, raw.sink_mb, atol=1e-5)
        L = raw.link_load.shape[1]
        np.testing.assert_allclose(pad.link_load[:, :L], raw.link_load,
                                   atol=1e-5)
        assert np.abs(pad.link_load[:, L:]).max() == 0.0


class TestBatchedSteps:
    """The pieces of a bucket tick under vmap against a loop over rows."""

    def test_maxmin_step_and_allocate_under_vmap(self):
        rng = np.random.default_rng(0)
        B, F, L = 5, 17, 16
        R = torch.tensor((rng.random((B, F, L)) < 0.25).astype(np.float32))
        caps = torch.tensor(rng.uniform(0.5, 3.0, (B, L)).astype(np.float32))
        d = torch.tensor(rng.uniform(0, 4, (B, F)).astype(np.float32))
        d[:, 3] = d[:, 5]                                    # demand ties
        carry = tuple(t.expand(B, *t.shape).contiguous()
                      for t in maxmin_order_init(F))
        x, c2, reb = torch.func.vmap(maxmin_fused_step)(R, caps, d, carry)
        for b in range(B):
            xb, cb, rb = maxmin_fused_step(
                R[b], caps[b], d[b], tuple(t[b] for t in carry))
            torch.testing.assert_close(x[b], xb, rtol=1e-6, atol=1e-6)
            assert torch.equal(c2[1][b], cb[1]) and bool(reb[b]) == bool(rb)
        kind = torch.tensor(rng.integers(0, 3, (B, L)))
        st = [torch.tensor(rng.uniform(0, 4, (B, F)).astype(np.float32))
              for _ in range(5)]
        for solver in ("sort", "waterfill"):
            got = torch.func.vmap(
                lambda r, c, k, *s: allocate(LinkProgram(r, c, k),
                                             FlowState(*s), dt=5.0,
                                             solver=solver))(R, caps, kind,
                                                             *st)
            for b in range(B):
                want = allocate(LinkProgram(R[b], caps[b], kind[b]),
                                FlowState(*(s[b] for s in st)), dt=5.0,
                                solver=solver if solver == "sort" else "sort")
                torch.testing.assert_close(got[b], want, rtol=2e-4,
                                           atol=2e-4)

    def test_caps_over_and_enforced_tick_batched(self):
        topo = big_switch(4, 2.0)
        sched = (link_failure_schedule(topo, [1], 10.0, 40.0, 0.5)
                 .with_event([1], 20.0, 30.0, 0.1).with_diurnal(50.0, 0.2))
        g = parallelize(trending_topics(), seed=0)
        sims = [compile_sim(g, topo, round_robin(g, 4), schedule=sched,
                            device=CPU),
                compile_sim(g, big_switch(4, 1.0), round_robin(g, 4),
                            schedule=link_failure_schedule(
                                big_switch(4, 1.0), [0, 2], 5.0, 25.0, 0.0),
                            device=CPU)]
        shape = FleetShape.cover(sims)
        stacked, _ = stack_sims(sims, shape)
        ts = torch.arange(0, 60, 0.5)
        got = torch.func.vmap(lambda *a: ps._caps_over(
            dataclasses.replace(stacked, **dict(zip(ps.DATA_FIELDS, a))),
            ts))(*(getattr(stacked, f) for f in ps.DATA_FIELDS))
        for b, s in enumerate(sims):
            want = ps._caps_over(pad_sim(s, shape), ts)
            assert torch.equal(got[b], want)
        assert abs(float(got[0, 50, 1]) - 2.0 * 0.05 * (
            1 + 0.2 * np.sin(2 * np.pi * 25.0 / 50.0))) < 1e-5
        # enforced tick, the gate per row: an un-enforced row is bitwise
        # the static transfer
        F = shape.n_flows
        rng = np.random.default_rng(1)
        Qs, Qr, x = (torch.tensor(rng.uniform(0, 6, (2, F)).astype(
            np.float32)) for _ in range(3))
        x = x * 10.0                                   # infeasible rates
        caps_t = got[:, 50]
        for gate in ([True, True], [False, True]):
            en = torch.tensor(gate)
            out = torch.func.vmap(lambda *a: ps._tick(
                dataclasses.replace(stacked, **dict(zip(ps.SIM_FIELDS,
                                                        a[5:]))),
                a[0], a[1], a[2], DT, 8.0, caps_t=a[3], enforce=a[4]))(
                Qs, Qr, x, caps_t, en,
                *(getattr(stacked, f) for f in ps.SIM_FIELDS))
            for b, s in enumerate(sims):
                ref = ps._tick(pad_sim(s, shape), Qs[b], Qr[b], x[b], DT, 8.0,
                               caps_t=caps_t[b] if gate[b] else None)
                for o, r in zip((out[0], out[2]), (ref[0], ref[2])):
                    torch.testing.assert_close(o[b], r, rtol=1e-6,
                                               atol=1e-6)


class TestFleetParity:
    @pytest.mark.parametrize("policy", POLICIES)
    def test_matches_simulate_and_reference(self, policy):
        jsims, psims = _fleets()
        idx = [0, 3, 7, 12, 16, 20, 24, 26]         # every kind of scenario
        js, pss = [jsims[i] for i in idx], [psims[i] for i in idx]
        if policy == "appfair":                     # mixed app counts
            js = js + [_two_app(2, 1.25), _two_app(3, 1.875)]
            pss = pss + [port_sim(s) for s in js[-2:]]
        xf = _x_fixed(pss) if policy == "fixed" else None
        runner = _runner()
        got = runner.run(pss, policy, seconds=SECONDS, x_fixed=xf)
        want = jf.FleetRunner(tick_overhead=15e3).run(
            js, policy, seconds=SECONDS, x_fixed=xf)
        for k, (g, w, s) in enumerate(zip(got, want, pss)):
            _close(g, w)
            np.testing.assert_allclose(g.sink_mb_app, w.sink_mb_app,
                                       atol=1e-4)
            ref = simulate(s, policy, seconds=SECONDS, device=CPU,
                           x_fixed=None if xf is None else xf[k])
            _close(g, ref)
            assert g.throughput_tps == pytest.approx(ref.throughput_tps,
                                                     rel=1e-5, abs=1e-4)
            assert (g.caps_t is None) == (not s.is_dynamic)
        if policy == "appfair":
            # one bucket per app count at least
            assert {sh[3] for sh in runner.last_stats["bucket_shapes"]} == \
                {1, 2, 3}
        assert runner.last_stats["n_dispatches"] == 1

    def test_waterfill_fleet_matches_sort(self):
        _, psims = _fleets()
        sims = psims[:12]
        r = _runner()
        before = ops.LAUNCHES
        wf = r.run(sims, "appaware", seconds=SECONDS, solver="waterfill")
        assert ops.LAUNCHES == before      # the plain version never counts
        srt = r.run(sims, "appaware", seconds=SECONDS, solver="sort")
        for a, b in zip(wf, srt):
            np.testing.assert_allclose(a.metrics[:5], b.metrics[:5],
                                       rtol=2e-4, atol=2e-4)

    def test_fused_and_per_bucket_bitwise(self):
        _, psims = _fleets()
        xf = _x_fixed(psims)
        for policy in ("tcp", "fixed"):
            kw = dict(x_fixed=xf) if policy == "fixed" else {}
            a = _runner(fused=True)
            b = _runner(fused=False)
            ra = a.run(psims, policy, seconds=10.0, **kw)
            rb = b.run(psims, policy, seconds=10.0, **kw)
            assert a.last_stats["n_dispatches"] == 1
            assert b.last_stats["n_dispatches"] == b.last_stats["n_buckets"]
            for x, y in zip(ra, rb):
                for u, v in ((x.sink_mb, y.sink_mb), (x.latency, y.latency),
                             (x.link_load, y.link_load),
                             (x.metrics, y.metrics)):
                    np.testing.assert_array_equal(u, v)

    def test_infeasible_fixed_static_exact_in_scheduled_bucket(self):
        g = parallelize(trending_topics(), seed=0)
        topo = big_switch(8, 1.25)
        static = compile_sim(g, topo, round_robin(g, 8), device=CPU)
        dyn = compile_sim(g, topo, round_robin(g, 8), device=CPU,
                          schedule=link_failure_schedule(topo, [0, 1], 5.0,
                                                         10.0, degrade=0.1))
        x = np.full(g.n_flows, 12.5, np.float32)
        runner = _runner()
        out = runner.run([static, dyn], "fixed", seconds=20.0, x_fixed=[x, x])
        assert runner.last_stats["n_buckets"] == 1
        for sim, r in zip((static, dyn), out):
            ref = simulate(sim, "fixed", seconds=20.0, x_fixed=x, device=CPU)
            np.testing.assert_allclose(r.sink_mb, ref.sink_mb, atol=1e-5)
            np.testing.assert_allclose(r.link_load, ref.link_load, atol=1e-5)
        np.testing.assert_allclose(out[1].caps_t, ref.caps_t, atol=1e-6)

    def test_x_fixed_length_mismatch_rejected(self):
        _, psims = _fleets()
        with pytest.raises(ValueError, match="x_fixed"):
            _runner().run(psims[:2], "fixed", seconds=5.0,
                          x_fixed=[np.ones(4, np.float32)])
        with pytest.raises(ValueError, match="empty"):
            _runner().run([], "tcp")

    def test_appaware_beats_tcp_batched(self):
        g = parallelize(trending_topics(), seed=0)
        sim = compile_sim(g, big_switch(8, 1.25), round_robin(g, 8),
                          device=CPU)
        tcp, aa = (simulate_many([sim], pol, seconds=300.0, device=CPU)[0]
                   for pol in ("tcp", "appaware"))
        assert aa.throughput_tps > tcp.throughput_tps * 1.10


def _cons_sims():
    """A 4-instance app that mints and loses nothing, static and with its
    links failing outright between 10 and 20 s."""
    from repro_torch.streams import Edge, Grouping, Operator, StreamApp
    app = StreamApp(
        "cons",
        [Operator("src", 1, gen_rate=0.8, proc_rate=100.0),
         Operator("mid", 2, proc_rate=100.0, selectivity=1.0),
         Operator("sink", 1, proc_rate=100.0, selectivity=0.0)],
        [Edge("src", "mid", Grouping.SHUFFLE),
         Edge("mid", "sink", Grouping.GLOBAL)])
    g = parallelize(app, seed=0)
    topo = big_switch(4, 5.0)
    sched = link_failure_schedule(topo, [0, 1], 10.0, 20.0, degrade=0.0)
    static = compile_sim(g, topo, round_robin(g, 4), device=CPU)
    dyn = compile_sim(g, topo, round_robin(g, 4), schedule=sched, device=CPU)
    return [static, dyn, static, dyn]


def test_mixed_fleet_shares_a_bucket_and_conserves():
    # static and failing scenarios in one bucket through the batched fused
    # max-min solve: each row matches its own simulate, and cumulative
    # delivery never exceeds cumulative generation
    sims = _cons_sims()
    assert len(pf._plan_buckets(sims, 1)) == 1
    runner = FleetRunner(device=CPU, max_buckets=1)
    out = runner.run(sims, "tcp", seconds=30.0)
    again = runner.run(sims, "tcp", seconds=30.0)
    assert runner.last_stats["n_buckets"] == 1
    for sim, r, r2 in zip(sims, out, again):
        np.testing.assert_array_equal(r.sink_mb, r2.sink_mb)
        ref = simulate(sim, "tcp", seconds=30.0, device=CPU)
        np.testing.assert_allclose(r.sink_mb, ref.sink_mb, atol=1e-4)
        ticks = np.arange(1, r.sink_mb.shape[0] + 1)
        assert np.all(np.cumsum(r.sink_mb)
                      <= 0.8 * DT * ticks * (1 + 1e-3) + 1e-4)
    assert out[0].caps_t is None and out[1].caps_t is not None


def _two_app(n_apps, cap):
    g = J.parallelize(J.trending_topics(), seed=0)
    app = (np.arange(g.n_instances) % n_apps).astype(np.int32)
    from repro.net import big_switch as jbig
    return J.compile_sim(g, jbig(8, cap), J.round_robin(g, 8),
                         app_of_inst=app, n_apps=n_apps)


class TestStagingAndPacks:
    """Staging buffers and device packs are this runner's caches: a warm
    call re-passes the same pack tensors; a scenario changed in place is
    restaged; the fingerprint knob selects what a warm call checks."""

    def _sims(self, n=3):
        g = parallelize(trending_topics(), seed=0)
        return [compile_sim(g, big_switch(8, 1.0 + 0.1 * i),
                            round_robin(g, 8), device=CPU)
                for i in range(n)]

    def test_warm_call_reuses_packs(self):
        sims = self._sims()
        r = _runner()
        a = r.run(sims, "tcp", seconds=10.0)
        packs = {k: v["R"] for k, v in r._device.items()}
        b = r.run(sims, "tcp", seconds=10.0)
        assert {k: v["R"] for k, v in r._device.items()} == packs
        assert all(r._device[k]["R"] is t for k, t in packs.items())
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.sink_mb, y.sink_mb)

    def test_inplace_mutation_restages(self):
        sims = self._sims()
        r = _runner()
        out1 = r.run(sims, "tcp", seconds=10.0)
        old = dict(r._device)
        sims[1].gen_rate.mul_(0.05)                  # in place: same object
        out2 = r.run(sims, "tcp", seconds=10.0)
        assert all(r._device[k] is not old[k] for k in old)
        ref = simulate(sims[1], "tcp", seconds=10.0, device=CPU)
        np.testing.assert_allclose(out2[1].sink_mb, ref.sink_mb, atol=1e-4)
        assert not np.allclose(out1[1].sink_mb, out2[1].sink_mb)
        np.testing.assert_array_equal(out1[0].sink_mb, out2[0].sink_mb)

    def test_fingerprint_modes(self, monkeypatch):
        calls = {"n": 0}
        orig = pf._sim_content_sig

        def counting(sim):
            calls["n"] += 1
            return orig(sim)
        monkeypatch.setattr(pf, "_sim_content_sig", counting)
        sims = self._sims()
        ident = _runner(fingerprint="identity")
        a = ident.run(sims, "tcp", seconds=10.0)
        b = ident.run(sims, "tcp", seconds=10.0)
        assert calls["n"] == 0
        off = _runner(fingerprint="off")
        c = off.run(sims, "tcp", seconds=10.0)
        packs = dict(off._device)
        d = off.run(sims, "tcp", seconds=10.0)
        assert all(off._device[k] is not packs[k] for k in packs)
        e = _runner().run(sims, "tcp", seconds=10.0)
        assert calls["n"] > 0
        for rs in zip(a, b, c, d, e):
            for r in rs[1:]:
                np.testing.assert_array_equal(rs[0].sink_mb, r.sink_mb)
        with pytest.raises(ValueError):
            FleetRunner(device=CPU, fingerprint="sha")

    def test_growth_within_capacity_and_inert_rows(self):
        g = parallelize(trending_topics(), seed=0)
        sims = [compile_sim(g, big_switch(8, 1.0 + 0.05 * i),
                            round_robin(g, 8), device=CPU)
                for i in range(20)]
        r = _runner()
        out = r.run(sims[:17], "appaware", seconds=10.0)
        assert r.last_stats["rows"] == [20]           # 3 inert spare rows
        out2 = r.run(sims, "appaware", seconds=10.0)
        assert r.last_stats["rows"] == [20]
        for a, b in zip(out, out2[:17]):
            np.testing.assert_array_equal(a.sink_mb, b.sink_mb)
        ref = simulate(sims[-1], "appaware", seconds=10.0, device=CPU)
        np.testing.assert_allclose(out2[-1].sink_mb, ref.sink_mb, atol=1e-4)
        for x in out2:
            assert np.isfinite(x.sink_mb).all() and np.isfinite(
                x.latency).all()


class TestNoHiddenDevice:
    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        _, psims = _fleets()
        with pytest.raises(RuntimeError, match="CUDA"):
            FleetRunner().run(psims[:2], "tcp", seconds=5.0)
        with pytest.raises(RuntimeError, match="CUDA"):
            simulate_many(psims[:2], "tcp", seconds=5.0)
        with pytest.raises(RuntimeError, match="CUDA"):
            pf.calibrate_backend()

    def test_waterfill_fleet_checks_its_inputs(self):
        B, L, F = 2, 3, 4
        w = torch.ones(B, F)
        m = torch.ones(B, L, F)
        cap = torch.ones(B, L)
        kind = torch.zeros(B, L, dtype=torch.int32)
        with pytest.raises(ValueError, match="B, L, F"):
            ops.waterfill_fleet(w, w, w, m[0], cap, kind)
        with pytest.raises(ValueError, match="capacity"):
            ops.waterfill_fleet(w, w, w, m, cap[:, :2], kind)
        with pytest.raises(ValueError, match="contiguous"):
            ops.waterfill_fleet(w, w, w, m.transpose(1, 2).contiguous()
                                .transpose(1, 2), cap, kind)
        with pytest.raises(TypeError, match="kind"):
            ops.waterfill_fleet(w, w, w, m, cap, kind.float())
        # meta tensors are a shape function's input, checked all the same
        with pytest.raises(ValueError, match="is on"):
            ops.waterfill_fleet(*(t.to("meta") for t in (w, w, w)), m, cap,
                                kind)
