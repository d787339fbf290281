"""The port's progressive-filling oracles, the §VII App-Fair scheduler, the
Fig. 13 baseline and the paper's testbed config against the JAX package,
on the same seeded numpy instances as tests/test_maxmin_fused.py
(zero-capacity links, zero demands, off-net flows, ties).

Tolerances are the JAX tests' own: the oracles at atol 1e-4, rtol 1e-5
(tests/test_maxmin_fused.py), the scheduler and the per-app sums at 1e-5
(tests/test_torch_tcp.py). The numpy reference is a copy, so it must agree
bit for bit."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, t32, tint
from test_maxmin_fused import _assert_maxmin_invariant, _instance

import repro.core.multiapp as jm
import repro.core.tcp as jtcp
from repro.configs import paper_stream as jps
from repro_torch import core as pcore
from repro_torch.configs import paper_stream as pps
from repro_torch.core import multiapp as pm
from repro_torch.core import tcp as ptcp

ATOL, RTOL = 1e-4, 1e-5
TOL = 1e-5
SEEDS = range(12)


def _family(seed):
    """One random instance of tests/test_maxmin_fused.py's families: the
    shape, the degeneracies and the routing density drawn from ``seed``."""
    rng = np.random.default_rng(10_000 + seed)
    F, L = int(rng.integers(1, 29)), int(rng.integers(1, 13))
    return _instance(seed, F, L, int(rng.integers(1, 5)), bool(seed % 2),
                     bool(seed % 3 == 0), bool(seed % 4 < 2))


def _tied(seed, F=12, L=4):
    """Equal capacities on every link and duplicated demands: water levels
    and demand caps tie."""
    R, _, d = _instance(seed, F, L, 2, False, False, True)
    d[: F // 2] = d[0]
    return R, np.full(L, 6.0, np.float32), d


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


class TestMaxminRates:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_matches_jax(self, seed):
        R, cap, _ = _family(seed)
        want = np.asarray(jtcp.maxmin_rates(*_j(R, cap)))
        got = ptcp.maxmin_rates(t32(R), t32(cap))
        assert_close(got, want, RTOL, ATOL)

    @pytest.mark.parametrize("seed", range(3))
    def test_ties_and_active_mask_match_jax(self, seed):
        R, cap, _ = _tied(seed)
        active = (np.arange(R.shape[0]) % 3 != 0).astype(np.float32)
        for act in (None, active):
            want = np.asarray(jtcp.maxmin_rates(
                *_j(R, cap), None if act is None else jnp.asarray(act)))
            got = ptcp.maxmin_rates(t32(R), t32(cap),
                                    None if act is None else t32(act))
            assert_close(got, want, RTOL, ATOL)

    def test_unconstrained_and_inactive_flows(self):
        R = np.array([[1.0, 0.0], [0.0, 0.0], [0.0, 0.0]], np.float32)
        got = ptcp.maxmin_rates(t32(R), t32([4.0, 2.0]),
                                t32([1.0, 1.0, 0.0])).numpy()
        assert got[0] == 4.0 and np.isposinf(got[1]) and got[2] == 0.0


class TestDemandLimitedMaxmin:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_matches_jax_and_numpy_reference(self, seed):
        R, cap, d = _family(seed)
        want = np.asarray(jtcp.demand_limited_maxmin(*_j(R, cap, d)))
        got = ptcp.demand_limited_maxmin(t32(R), t32(cap), t32(d)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(
            got, ptcp.demand_limited_maxmin_np(R, cap, d), atol=ATOL,
            rtol=RTOL)
        _assert_maxmin_invariant(R, cap, d, got)

    @pytest.mark.parametrize("iters", [1, 2, 3])
    def test_capped_rounds_match_jax(self, iters):
        R, cap, d = _instance(5041, 16, 6, 3, False, False, True)
        want = np.asarray(jtcp.demand_limited_maxmin(*_j(R, cap, d),
                                                     iters=iters))
        got = ptcp.demand_limited_maxmin(t32(R), t32(cap), t32(d),
                                         iters=iters)
        assert_close(got, want, RTOL, ATOL)

    @pytest.mark.parametrize("seed", range(3))
    def test_ties_match_jax(self, seed):
        R, cap, d = _tied(seed)
        want = np.asarray(jtcp.demand_limited_maxmin(*_j(R, cap, d)))
        got = ptcp.demand_limited_maxmin(t32(R), t32(cap), t32(d))
        assert_close(got, want, RTOL, ATOL)

    def test_seed_5041_is_maxmin(self):
        R, cap, d = _instance(5041, 16, 6, 3, False, False, True)
        got = ptcp.demand_limited_maxmin(t32(R), t32(cap), t32(d)).numpy()
        np.testing.assert_allclose(
            got, ptcp.demand_limited_maxmin_np(R, cap, d), atol=ATOL,
            rtol=RTOL)
        _assert_maxmin_invariant(R, cap, d, got)


@pytest.mark.parametrize("seed", list(SEEDS) + [5041])
def test_numpy_reference_is_a_bitwise_copy(seed):
    R, cap, d = (_instance(seed, 16, 6, 3, False, False, True)
                 if seed == 5041 else _family(seed))
    got = ptcp.demand_limited_maxmin_np(R, cap, d)
    want = jtcp.demand_limited_maxmin_np(R, cap, d)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _multiapp_scenario():
    """examples/multiapp_fairness.py: 5 apps with 1..5 flows on one link."""
    app = np.concatenate([[a] * (a + 1) for a in range(5)])
    return np.ones((len(app), 1), np.float32), np.array([100.0], np.float32), \
        app, 5


def _multilink_scenario():
    rng = np.random.default_rng(7)
    F, L, A = 30, 8, 6
    R = (rng.random((F, L)) < 0.3).astype(np.float32)
    R[np.arange(F), rng.integers(0, L, F)] = 1.0        # every flow on-net
    return R, rng.uniform(2.0, 20.0, L).astype(np.float32), \
        rng.integers(0, A, F), A


class TestAppFair:
    @pytest.mark.parametrize("scenario", ["multiapp_fairness", "multilink"])
    @pytest.mark.parametrize("alpha", [0.25, 1.0])
    def test_sixty_steps_match_jax(self, scenario, alpha):
        """Both schedulers see the same interval throughputs each step (the
        JAX run's per-app sums): equal priorities, rates within 1e-5."""
        R, cap, app, A = (_multiapp_scenario() if scenario ==
                          "multiapp_fairness" else _multilink_scenario())
        n_groups = 5 if scenario == "multiapp_fairness" else 3
        js = jm.AppFairScheduler(A, alpha=alpha, n_groups=n_groups)
        ps = pm.AppFairScheduler(A, alpha=alpha, n_groups=n_groups,
                                 device="cpu")
        jstate, pstate = js.init(), ps.init()
        prev = np.zeros(A, np.float32)
        for step in range(60):
            jstate, jx = js.step(jstate, jnp.asarray(prev), *_j(R, cap),
                                 jnp.asarray(app, jnp.int32))
            pstate, px = ps.step(pstate, t32(prev), t32(R), t32(cap),
                                 tint(app))
            np.testing.assert_array_equal(pstate.priority.numpy(),
                                          np.asarray(jstate.priority),
                                          err_msg=f"step {step}")
            assert_close(px, np.asarray(jx), TOL, TOL)
            assert_close(pstate.total, np.asarray(jstate.total), TOL, TOL)
            assert float(pstate.n) == float(jstate.n)
            jx = np.asarray(jx)
            prev = np.array([jx[app == a].sum() for a in range(A)],
                            np.float32)

    def test_state_lives_on_the_scheduler_device(self):
        st = pm.AppFairScheduler(4, device="cpu").init()
        assert isinstance(st, pm.AppFairState)
        assert st.total.shape == (4,) and st.n.shape == ()
        assert all(t.device.type == "cpu" for t in st)

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pm.AppFairScheduler(5)


@pytest.mark.parametrize("scenario", ["multiapp_fairness", "multilink",
                                      "family"])
def test_tcp_app_throughput_matches_jax(scenario):
    if scenario == "family":
        R, cap, _ = _family(4)
        A = 3
        app = np.arange(R.shape[0]) % A
    else:
        R, cap, app, A = (_multiapp_scenario() if scenario ==
                          "multiapp_fairness" else _multilink_scenario())
    want = np.asarray(jm.tcp_app_throughput(*_j(R, cap),
                                            jnp.asarray(app, jnp.int32), A))
    got = pm.tcp_app_throughput(t32(R), t32(cap), tint(app), A)
    assert got.shape == (A,)
    assert_close(got, want, TOL, TOL)


def test_testbed_config_equals_jax():
    got, want = pps.config(), jps.config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]


def test_core_exports_every_reference_name():
    import types

    import repro.core as jcore

    # submodules appear in dir() once anything imports them, so only the
    # names the package exports count
    ref = {n for n in dir(jcore) if not n.startswith("_")
           and not isinstance(getattr(jcore, n), types.ModuleType)}
    assert "AppFairScheduler" in ref and "maxmin_rates" in ref
    assert not {n for n in ref if not hasattr(pcore, n)}
