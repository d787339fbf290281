"""The port's simulator against the JAX package's: one teacher-forced tick
and one policy solve from the same state on every ``seed_fleet()``
scenario (1e-5), the capacity schedule and the metric epilogue on the same
inputs, and whole runs of every policy compared on their metrics.

Whole runs compound float32 rounding differences (sums in another order)
over hundreds of ticks, through max-min decisions and join stalls, so they
are held at 1e-4 relative (and 1e-4 absolute on metrics near zero, such as
a dip depth of 0) — a per-tick error of ~1e-6 relative leaves two orders of
magnitude of room."""
import functools

import numpy as np
import pytest

import jax.numpy as jnp
import repro.streams.scenarios as jsc
import repro.streams.simulator as js
from _torch_parity import CPU, assert_close, port_sim, port_state, t32
from repro.core.flowstate import FlowState as JFlowState
from repro.core.multiapp import group_by_throughput as j_group
from repro.core.multiapp import strict_priority_alloc as j_priority
from repro.core.tcp import maxmin_order_init as j_order_init
from repro.net.topology import big_switch, link_failure_schedule
from repro_torch.core.multiapp import group_by_throughput as p_group
from repro_torch.core.multiapp import strict_priority_alloc as p_priority
from repro_torch.core.tcp import maxmin_order_init as p_order_init
from repro_torch.streams import simulator as ps

TOL = 1e-5
RUN_RTOL = 1e-4
DT, QCAP = 0.5, 8.0


@functools.lru_cache(maxsize=None)
def _fleet():
    return [(s.name, s.compile()) for s in jsc.seed_fleet()]


def _state(rng, F, scale=4.0):
    return [rng.uniform(0, scale, F).astype(np.float32) for _ in range(5)]


def _caps_t(jsim, t):
    """Scheduled capacities at time t (both packages' own evaluation)."""
    ts = np.array([t], np.float32)
    want = np.asarray(js._caps_over(jsim, jnp.asarray(ts)))[0]
    return want


class TestTeacherForced:
    @pytest.mark.parametrize("k", range(28))
    def test_tick(self, k):
        name, jsim = _fleet()[k]
        psim = port_sim(jsim)
        F = jsim.R.shape[0]
        rng = np.random.default_rng(k)
        Qs, Qr = (rng.uniform(0, 6, F).astype(np.float32) for _ in range(2))
        x = rng.uniform(0, 3, F).astype(np.float32)
        caps_t = _caps_t(jsim, 60.0) if jsim.is_dynamic else None
        want = js._tick(jsim, jnp.asarray(Qs), jnp.asarray(Qr),
                        jnp.asarray(x), DT, QCAP,
                        caps_t=None if caps_t is None else jnp.asarray(caps_t))
        got = ps._tick(psim, t32(Qs), t32(Qr), t32(x), DT, QCAP,
                       caps_t=None if caps_t is None else t32(caps_t))
        (wQs, wQr, wtr, wdr, wys), (gQs, gQr, gtr, gdr, gys) = want, got
        for g, w in zip((gQs, gQr, gtr, gdr, *gys), (wQs, wQr, wtr, wdr, *wys)):
            assert_close(g, np.asarray(w), TOL, TOL)

    @pytest.mark.parametrize("k", range(0, 28, 3))
    def test_policy_rates(self, k):
        name, jsim = _fleet()[k]
        psim = port_sim(jsim)
        F = jsim.R.shape[0]
        rng = np.random.default_rng(100 + k)
        caps = (_caps_t(jsim, 60.0) if jsim.is_dynamic
                else np.asarray(jsim.caps))
        Qs, Qr, prod, drain = (rng.uniform(0, 4, F).astype(np.float32)
                               for _ in range(4))
        # tcp: demand-capped max-min from a cold order cache
        jx, _, jreb = js._tcp_rates(
            jsim, jsim.R, jnp.asarray(caps), jnp.asarray(Qs),
            jnp.asarray(Qr), jnp.asarray(prod), jnp.asarray(drain), DT, QCAP,
            j_order_init(F))
        px, _, preb = ps._tcp_rates(
            psim, psim.R, t32(caps), t32(Qs), t32(Qr), t32(prod), t32(drain),
            DT, QCAP, p_order_init(F))
        assert_close(px, np.asarray(jx), TOL, TOL)
        assert bool(preb) == bool(jreb)
        # appaware: both solvers
        st = _state(rng, F)
        for jsolver, psolver in (("sort", "sort"), ("pallas", "waterfill")):
            jx = js._appaware_rates(jsim, jsim.R, jnp.asarray(caps),
                                    JFlowState(*map(jnp.asarray, st)), 5.0,
                                    solver=jsolver)
            px = ps._appaware_rates(psim, psim.R, t32(caps), port_state(st),
                                    5.0, solver=psolver)
            assert_close(px, np.asarray(jx), TOL, TOL)
        # appfair: priority groups from a throughput vector, then the
        # strict-priority fill
        mu = rng.uniform(0, 1, jsim.n_apps).astype(np.float32)
        jx = j_priority(jsim.R, jnp.asarray(caps), jsim.app_of_flow,
                        j_group(jnp.asarray(mu), 8), n_groups=8)
        px = p_priority(psim.R, t32(caps), psim.app_of_flow,
                        p_group(t32(mu), 8), n_groups=8)
        assert_close(px, np.asarray(jx), TOL, TOL)


class TestSchedulesAndMetrics:
    def test_caps_over_two_events_on_one_link(self):
        # events on the same link compose as a product (0.5 · 0.1 = 0.05)
        topo = big_switch(4, 2.0)
        sched = (link_failure_schedule(topo, [1], 10.0, 40.0, 0.5)
                 .with_event([1], 20.0, 30.0, 0.1)
                 .with_diurnal(50.0, 0.2))
        from repro.streams.app import parallelize
        from repro.streams.placement import round_robin
        from repro.streams.workloads import motivation_chain
        g = parallelize(motivation_chain(), seed=0)
        jsim = js.compile_sim(g, topo, round_robin(g, 4), schedule=sched)
        psim = port_sim(jsim)
        ts = np.arange(0, 60, 0.5, dtype=np.float32)
        got = ps._caps_over(psim, t32(ts))
        assert_close(got, np.asarray(js._caps_over(jsim, jnp.asarray(ts))),
                     1e-6, 1e-6)
        assert_close(got, sched.caps_at(topo.capacities, ts), 1e-5, 1e-6)
        assert abs(float(got[50, 1]) - 2.0 * 0.05 *
                   (1 + 0.2 * np.sin(2 * np.pi * 25.0 / 50.0))) < 1e-5

    def test_route_states_over(self):
        jsim = jsc.link_failure_sweep(n=1, in_run=True,
                                      reroute=True)[0].compile()
        psim = port_sim(jsim)
        ts = np.arange(0, 120, 0.5, dtype=np.float32)
        np.testing.assert_array_equal(
            ps._route_states_over(psim, t32(ts)).numpy(),
            np.asarray(js._route_states_over(jsim, jnp.asarray(ts))))

    @pytest.mark.parametrize("t_event", [0.0, 50.0, 300.0])
    def test_metrics_epilogue(self, t_event):
        rng = np.random.default_rng(int(t_event))
        T, F, L = 400, 9, 6
        sink = np.abs(np.cumsum(rng.normal(0, 0.02, T))).astype(np.float32)
        sink[int(t_event / DT) + 5:int(t_event / DT) + 30] *= 0.2
        wait = rng.uniform(0, 50, (T, F)).astype(np.float32)
        load = rng.uniform(0, 3, (T, L)).astype(np.float32)
        caps = rng.uniform(1, 3, (T, L)).astype(np.float32)
        path_w = rng.uniform(0, 1, F).astype(np.float32)
        want = np.asarray(js._metrics_epilogue(
            jnp.asarray(sink), jnp.asarray(wait), jnp.asarray(load),
            jnp.asarray(caps), jnp.asarray(path_w), DT, t_event))
        got = ps._metrics_epilogue(t32(sink), t32(wait), t32(load),
                                   t32(caps), t32(path_w), DT, t_event)
        assert_close(got, want, TOL, TOL)


def _runs():
    static = jsc.seed_fleet()[0]                        # TT, 10 Mbps
    failing = jsc.link_failure_sweep(n=1, in_run=True)[0]
    rerouting = jsc.link_failure_sweep(n=1, in_run=True, reroute=True)[0]
    return {"static": static, "failure": failing, "reroute": rerouting}


@pytest.mark.parametrize("policy", ["tcp", "appaware", "appfair", "fixed"])
@pytest.mark.parametrize("which", ["static", "failure", "reroute"])
def test_run_metrics_match(which, policy):
    jsim = _runs()[which].compile()
    psim = port_sim(jsim)
    F = jsim.R.shape[0]
    kw = dict(seconds=120.0, dt=DT, t_event=60.0)
    x_fixed = None
    if policy == "fixed":
        x_fixed = np.random.default_rng(F).uniform(0, 1, F).astype(
            np.float32)
    want = js.simulate(jsim, policy, x_fixed=x_fixed, **kw)
    got = ps.simulate(psim, policy, x_fixed=x_fixed, device=CPU, **kw)
    np.testing.assert_allclose(got.metrics, want.metrics, rtol=RUN_RTOL,
                               atol=RUN_RTOL)
    np.testing.assert_allclose(got.sink_mb, want.sink_mb, rtol=RUN_RTOL,
                               atol=RUN_RTOL * want.sink_mb.max())
    assert got.n_order_rebuilds == want.n_order_rebuilds
    assert abs(got.throughput_tps - want.throughput_tps) <= (
        RUN_RTOL * want.throughput_tps)
    if jsim.is_dynamic:
        assert_close(got.caps_t, want.caps_t, 1e-6, 1e-6)
