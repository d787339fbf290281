"""The port's allocator (Alg. 1) against the JAX package's on the same
numpy inputs.

Tolerances: 1e-5 for the exact sort solver and for ``"waterfill"`` against
the JAX ``"pallas"`` path (the same algorithms in float32, summed in
another order); 2e-3 between the bisection and the sort solver, the JAX
test's own tolerance (tests/test_core_allocator.py)."""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import jax.numpy as jnp
import repro.core.allocator as ja
from _torch_parity import assert_close, port_state, t32, tint
from repro.core.flowstate import FlowState as JFlowState
from repro.net.topology import big_switch, fat_tree
from repro_torch.core import allocator as pa
from repro_torch.core.allocator import (LinkProgram, OnlineAllocator,
                                        allocate, solve_downlink)

TOL = 1e-5


def _problem(seed, F, L, p=0.4, zero_cap_frac=0.0, links_per_flow=None):
    rng = np.random.default_rng(seed)
    if links_per_flow is None:
        R = (rng.random((F, L)) < p).astype(np.float32)
    else:   # the allocator benchmark's sparse recipe
        R = np.zeros((F, L), np.float32)
        for f in range(F):
            R[f, rng.choice(L, size=min(links_per_flow, L),
                            replace=False)] = 1.0
    caps = rng.uniform(0.0, 50.0, L).astype(np.float32)
    if zero_cap_frac:
        caps[rng.random(L) < zero_cap_frac] = 0.0
    kind = rng.integers(0, 3, L).astype(np.int32)
    state = [rng.uniform(0, 10, F).astype(np.float32) for _ in range(5)]
    jprog = ja.LinkProgram(R=jnp.asarray(R), capacity=jnp.asarray(caps),
                           kind=jnp.asarray(kind))
    pprog = LinkProgram(R=t32(R), capacity=t32(caps), kind=tint(kind))
    jst = JFlowState(*[jnp.asarray(a) for a in state])
    return jprog, pprog, jst, port_state(state)


class TestSolvers:
    @pytest.mark.parametrize("seed", range(4))
    def test_solve_up_down_match(self, seed):
        rng = np.random.default_rng(seed)
        n = 24
        w, bl, rho = (rng.uniform(0, 10, n).astype(np.float32)
                      for _ in range(3))
        mask = (rng.random(n) < 0.7).astype(np.float32)
        assert_close(pa.solve_uplink(t32(w), t32(mask), 7.5),
                     ja.solve_uplink(w, mask, 7.5), TOL, TOL)
        assert_close(solve_downlink(t32(bl), t32(rho), t32(mask), 7.5, 0.5),
                     ja.solve_downlink(bl, rho, mask, 7.5, 0.5), TOL, TOL)

    @settings(max_examples=50, deadline=None)
    @given(n=st.integers(2, 24), cap=st.floats(0.1, 1e3),
           seed=st.integers(0, 2**31 - 1))
    def test_property_waterfill_kkt(self, n, cap, seed):
        # the KKT property of tests/test_core_allocator.py on the port
        rng = np.random.default_rng(seed)
        L = rng.uniform(0, 50, n).astype(np.float32)
        rho = rng.uniform(0.1, 20, n).astype(np.float32)
        xn = solve_downlink(t32(L), t32(rho), torch.ones(n), cap,
                            1.0).numpy()
        assert xn.min() >= 0.0
        np.testing.assert_allclose(xn.sum(), cap, rtol=1e-3)
        drain = (L + xn) / rho
        pos = xn > cap * 1e-5
        if pos.sum() >= 1:
            theta = np.median(drain[pos])
            np.testing.assert_allclose(drain[pos], theta, rtol=5e-3)
            if (~pos).sum():
                assert np.all(drain[~pos] >= theta * (1 - 5e-3))


class TestPerLinkRates:
    @pytest.mark.parametrize("seed", range(3))
    def test_fused_and_vmap_match_jax(self, seed):
        jprog, pprog, jst, pst = _problem(seed, 40, 12)
        want = np.asarray(ja._per_link_rates_vmap(jprog, jst, 5.0))
        assert_close(pa._per_link_rates_vmap(pprog, pst, 5.0), want, TOL, TOL)
        assert_close(pa._per_link_rates(pprog, pst, 5.0), want, TOL, TOL)

    def test_chunked_equals_fused(self):
        _, pprog, _, pst = _problem(5, 60, 37)
        a = pa._per_link_rates(pprog, pst, 1.0)
        b = pa._per_link_rates_chunked(pprog, pst, 1.0, 8)
        # the same per-row math; CPU reductions may vectorize differently
        # for other row-block sizes, so only float32 rounding may differ
        assert_close(a, b, 1e-6, 1e-6)


class TestAllocate:
    @pytest.mark.parametrize("seed,F,L", [(0, 30, 10), (1, 64, 24),
                                          (2, 17, 16), (3, 50, 7)])
    def test_sort_matches_jax(self, seed, F, L):
        jprog, pprog, jst, pst = _problem(seed, F, L, zero_cap_frac=0.1)
        want = np.asarray(ja.allocate(jprog, jst, dt=5.0, solver="sort"))
        assert_close(allocate(pprog, pst, dt=5.0, solver="sort"), want,
                     TOL, TOL)

    def test_sort_chunked_path_matches_jax(self):
        # L > 2 * ALLOC_BLOCK_LINKS: both packages auto-chunk the link axis
        jprog, pprog, jst, pst = _problem(9, 200, 600, links_per_flow=4)
        assert pprog.R.shape[1] > 2 * pa.ALLOC_BLOCK_LINKS
        want = np.asarray(ja.allocate(jprog, jst, dt=5.0, solver="sort"))
        got = allocate(pprog, pst, dt=5.0, solver="sort")
        assert_close(got, want, TOL, TOL)
        assert_close(got, allocate(pprog, pst, dt=5.0, solver="sort",
                                   block_links=0), 1e-6, 1e-6)

    @pytest.mark.parametrize("seed,F,L", [(0, 30, 10), (4, 90, 33)])
    def test_waterfill_matches_jax_pallas_and_sort(self, seed, F, L):
        jprog, pprog, jst, pst = _problem(seed, F, L)
        want = np.asarray(ja.allocate(jprog, jst, dt=5.0, solver="pallas"))
        got = allocate(pprog, pst, dt=5.0, solver="waterfill")
        assert_close(got, want, TOL, TOL)
        assert_close(got, allocate(pprog, pst, dt=5.0, solver="sort"),
                     2e-3, 2e-3)

    @pytest.mark.parametrize("topo_fn", [lambda: big_switch(4, 100.0),
                                         fat_tree])
    def test_online_allocator_solvers_feasible(self, topo_fn):
        topo = topo_fn()
        rng = np.random.default_rng(3)
        m = topo.n_machines
        flows = [(int(a), int(b)) for a, b in rng.integers(0, m, (14, 2))]
        a_sort = OnlineAllocator.from_topology(topo, flows, solver="sort",
                                               device="cpu")
        a_wf = OnlineAllocator.from_topology(topo, flows, solver="waterfill",
                                             device="cpu")
        R = topo.routing_matrix(flows)
        for _ in range(3):
            st_ = port_state([rng.uniform(0, 10, len(flows))
                              for _ in range(5)])
            xs, xw = a_sort(st_).numpy(), a_wf(st_).numpy()
            np.testing.assert_allclose(xs, xw, rtol=2e-3, atol=2e-3)
            assert np.all(xw @ R <= topo.capacities * (1 + 1e-3))

    def test_unknown_solver_rejected(self):
        _, pprog, _, pst = _problem(0, 4, 3)
        with pytest.raises(ValueError, match="solver"):
            allocate(pprog, pst, solver="pallas")
