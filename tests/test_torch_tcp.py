"""The port's max-min solvers (tcp / appfair hot path) against the JAX
package's, on the same numpy instances.

Tolerance 1e-5: the same fixed-trip fill in float32, with the prefix sums
(GEMM or cumsum) taken in another order. The numpy sequential reference
(`demand_limited_maxmin_np`) is held at the JAX tests' own 1e-4 absolute /
1e-5 relative (tests/test_maxmin_fused.py)."""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import jax.numpy as jnp
import repro.core.multiapp as jm
import repro.core.tcp as jtcp
from _torch_parity import assert_close, t32, tint
from repro.core.tcp import demand_limited_maxmin_np
from repro_torch.core import multiapp as pm
from repro_torch.core import tcp as ptcp
from test_maxmin_fused import _assert_maxmin_invariant, _instance

TOL = 1e-5


def _both(R, cap, d, **kw):
    want = np.asarray(jtcp.maxmin_fused(jnp.asarray(R), jnp.asarray(cap),
                                        jnp.asarray(d), **kw))
    got = ptcp.maxmin_fused(t32(R), t32(cap), t32(d), **kw)
    return got, want


def _sparse(seed, F, L, k=3):
    rng = np.random.default_rng(seed)
    R = np.zeros((F, L), np.float32)
    for f in range(F):
        R[f, rng.choice(L, size=min(k, L), replace=False)] = 1.0
    cap = rng.uniform(1.0, 20.0, L).astype(np.float32)
    d = rng.uniform(0.0, 10.0, F).astype(np.float32)
    d[rng.integers(0, F, 4)] = d[0]          # demand ties
    return R, cap, d


class TestMaxminFused:
    @pytest.mark.parametrize("F", [255, 256, 257])
    def test_crossover_matches_jax(self, F):
        R, cap, d = _sparse(F, F, 32)
        got, want = _both(R, cap, d)
        assert_close(got, want, TOL, TOL)

    @pytest.mark.parametrize("form", ["gemm", "sorted"])
    @pytest.mark.parametrize("block_flows", [None, 0, 32])
    def test_forms_match_jax(self, form, block_flows):
        R, cap, d = _sparse(1, 150, 20)
        got, want = _both(R, cap, d, form=form, block_flows=block_flows)
        assert_close(got, want, TOL, TOL)

    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(0, 10_000))
    def test_exact_rounds_match_numpy_reference(self, seed):
        R, cap, d = _instance(seed, 16, 6, 3, False, False, True)
        got = ptcp.maxmin_fused(t32(R), t32(cap), t32(d), rounds=None)
        np.testing.assert_allclose(got.numpy(),
                                   demand_limited_maxmin_np(R, cap, d),
                                   atol=TOL * 10, rtol=1e-5)
        _assert_maxmin_invariant(R, cap, d, got.numpy())

    def test_seed_5041(self):
        # the instance that broke the reference's old clamp-and-resolve
        # oracle: progressive filling must get flow 15 below its demand
        R, cap, d = _instance(5041, 16, 6, 3, False, False, True)
        got = ptcp.maxmin_fused(t32(R), t32(cap), t32(d), rounds=None)
        np.testing.assert_allclose(got.numpy(),
                                   demand_limited_maxmin_np(R, cap, d),
                                   atol=TOL * 10, rtol=1e-5)
        _assert_maxmin_invariant(R, cap, d, got.numpy())
        # its bottleneck chain is deeper than the default rounds cover: the
        # truncated fill must still agree with the reference's
        got, want = _both(R, cap, d)
        assert_close(got, want, TOL, TOL)

    @pytest.mark.parametrize("case", ["zero_demand", "off_net",
                                      "zero_capacity", "single_flow"])
    def test_edge_cases_match_jax(self, case):
        R, cap, d = _instance(3, 12, 5, 3, case == "zero_capacity",
                              case == "zero_demand", case == "off_net")
        if case == "zero_demand":
            d[:] = 0.0
        if case == "single_flow":
            R, d = R[:1], d[:1]
        got, want = _both(R, cap, d)
        assert_close(got, want, TOL, TOL)


class TestOrderCache:
    @pytest.mark.parametrize("F", [40, 300])   # GEMM and sorted forms
    def test_steps_match_jax_and_rebuild_flags(self, F):
        R, cap, _ = _sparse(7, F, 24)
        rng = np.random.default_rng(F)
        base = rng.uniform(0, 10, F).astype(np.float32)
        jc = jtcp.maxmin_order_init(F)
        pc = ptcp.maxmin_order_init(F)
        for step in range(6):
            # keep the order for two steps at a time, then reshuffle
            d = base * (1.0 + 0.01 * (step % 2)) if step % 3 else (
                rng.uniform(0, 10, F).astype(np.float32))
            jx, jc, jreb = jtcp.maxmin_fused_step(
                jnp.asarray(R), jnp.asarray(cap), jnp.asarray(d), jc)
            px, pc, preb = ptcp.maxmin_fused_step(t32(R), t32(cap), t32(d),
                                                  pc)
            assert_close(px, np.asarray(jx), TOL, TOL)
            assert bool(preb) == bool(jreb), step
            assert_close(px, ptcp.maxmin_fused(t32(R), t32(cap), t32(d)),
                         0.0, 0.0)
            if step % 3 == 0:
                base = d

    def test_static_demand_rebuilds_once(self):
        R, cap, d = _sparse(2, 30, 10)
        carry = ptcp.maxmin_order_init(30)
        rebuilds = 0
        for _ in range(8):
            _, carry, reb = ptcp.maxmin_fused_step(t32(R), t32(cap), t32(d),
                                                   carry)
            rebuilds += int(reb)
        assert rebuilds == 1


class TestMultiApp:
    def test_group_by_throughput_ties(self):
        mu = np.array([3.0, 1.0, 3.0, 0.5, 1.0, 7.0, 3.0], np.float32)
        for n_groups in (1, 2, 3, 8):
            want = np.asarray(jm.group_by_throughput(jnp.asarray(mu),
                                                     n_groups))
            got = pm.group_by_throughput(t32(mu), n_groups)
            np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("seed", range(3))
    def test_strict_priority_alloc_matches_jax(self, seed):
        rng = np.random.default_rng(seed)
        F, L, A = 24, 9, 5
        R = (rng.random((F, L)) < 0.3).astype(np.float32)
        cap = rng.uniform(1, 10, L).astype(np.float32)
        app = rng.integers(0, A, F)
        mu = rng.integers(0, 3, A).astype(np.float32)   # tied throughputs
        prio_j = jm.group_by_throughput(jnp.asarray(mu), 3)
        want = np.asarray(jm.strict_priority_alloc(
            jnp.asarray(R), jnp.asarray(cap), jnp.asarray(app, jnp.int32),
            prio_j, n_groups=3))
        prio_p = pm.group_by_throughput(t32(mu), 3)
        got = pm.strict_priority_alloc(t32(R), t32(cap), tint(app), prio_p,
                                       n_groups=3)
        assert_close(got, want, TOL, TOL)

    def test_ewma_and_jain(self):
        x = np.array([1.0, 2.0, 3.0, 0.0], np.float32)
        assert_close(pm.jain_index(t32(x)), jm.jain_index(jnp.asarray(x)),
                     1e-6, 0.0)
        assert_close(pm.ewma_throughput(t32(x), t32(x[::-1]), 0.3),
                     jm.ewma_throughput(jnp.asarray(x),
                                        jnp.asarray(x[::-1]), 0.3),
                     1e-6, 0.0)
