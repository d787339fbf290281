"""The port's waterfill wrapper and plain version against the JAX package's
Pallas kernel (interpret mode on the CPU) and its sort-based oracle.

Tolerances: 1e-5 against the JAX kernel, which runs the same 48-round
bisection in float32 (only the summation order differs); 2e-4 / 5e-4
against the exact sort-based oracle, the JAX tests' own tolerances for the
bisection (tests/test_kernels.py). The CUDA kernel itself is tested on the
card by tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import jax.numpy as jnp
from _torch_parity import assert_close, t32
from repro.kernels.waterfill.ops import waterfill as j_waterfill
from repro.kernels.waterfill.ops import waterfill_flows as j_waterfill_flows
from repro.kernels.waterfill.ops import waterfill_reference as j_reference
from repro_torch.kernels.waterfill import ops
from repro_torch.kernels.waterfill.ref import waterfill_plain, waterfill_ref

TOL_KERNEL = 1e-5


def _case(rng, L, F, p=0.7, rho_lo=0.1):
    w = rng.uniform(0, 20, (L, F)).astype(np.float32)
    bl = rng.uniform(0, 30, (L, F)).astype(np.float32)
    rho = rng.uniform(rho_lo, 10, (L, F)).astype(np.float32)
    mask = (rng.random((L, F)) < p).astype(np.float32)
    cap = rng.uniform(1, 50, L).astype(np.float32)
    kind = rng.integers(0, 2, L).astype(np.int32)
    return w, bl, rho, mask, cap, kind


def _port_dense(w, bl, rho, mask, cap, kind, dt):
    return ops.waterfill(t32(w), t32(bl), t32(rho), t32(mask), t32(cap),
                         torch.as_tensor(kind), dt=dt)


class TestWaterfillPlain:
    @pytest.mark.parametrize("L,F", [(4, 16), (10, 37), (32, 128), (7, 200)])
    @pytest.mark.parametrize("dt", [0.5, 1.0, 5.0])
    def test_matches_jax_kernel(self, L, F, dt):
        rng = np.random.default_rng(L * F)
        w, bl, rho, mask, cap, kind = _case(rng, L, F)
        # dense layout
        want = np.asarray(j_waterfill(w, bl, rho, mask, cap, kind, dt=dt))
        assert_close(_port_dense(w, bl, rho, mask, cap, kind, dt), want,
                     TOL_KERNEL, TOL_KERNEL)
        # shared [F] rows
        want = np.asarray(j_waterfill_flows(w[0], bl[0], rho[0], mask, cap,
                                            kind, dt=dt))
        got = ops.waterfill_flows(t32(w[0]), t32(bl[0]), t32(rho[0]),
                                  t32(mask), t32(cap), torch.as_tensor(kind),
                                  dt=dt)
        assert_close(got, want, TOL_KERNEL, TOL_KERNEL)

    @pytest.mark.parametrize("L,F", [(4, 16), (10, 37), (32, 128), (7, 200)])
    def test_matches_sort_oracle(self, L, F):
        rng = np.random.default_rng(L + F)
        args = _case(rng, L, F)
        want = np.asarray(j_reference(*(jnp.asarray(a) for a in args), 1.0))
        assert_close(_port_dense(*args, 1.0), want, 2e-4, 2e-4)
        # the port's own sort-based oracle equals the reference's
        got = waterfill_ref(*(t32(a) for a in args[:5]),
                            torch.as_tensor(args[5]), 1.0)
        assert_close(got, want, TOL_KERNEL, TOL_KERNEL)

    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(0, 10_000))
    def test_property_parity_random(self, seed):
        rng = np.random.default_rng(seed)
        L, F = int(rng.integers(1, 10)), int(rng.integers(1, 80))
        args = _case(rng, L, F, p=0.6, rho_lo=0.05)
        dt = float(rng.choice([0.5, 1.0, 5.0]))
        # the oracle runs on a fixed padded shape (one compile per dt):
        # padded flows and links carry mask 0, which both solvers ignore
        padded = [np.pad(a, [(0, 10 - L)] + [(0, 80 - F)] * (a.ndim - 1),
                         constant_values=1.0 if i == 2 else 0.0)
                  for i, a in enumerate(args)]
        want = np.asarray(j_reference(*(jnp.asarray(a) for a in padded),
                                      dt))[:L, :F]
        assert_close(_port_dense(*args, dt), want, 5e-4, 5e-4)

    def test_all_zero_demand(self):
        L, F = 6, 32
        z = np.zeros((L, F), np.float32)
        rho = np.full((L, F), 2.0, np.float32)
        mask = np.ones((L, F), np.float32)
        cap = np.full(L, 12.0, np.float32)
        kind = np.arange(L, dtype=np.int32) % 2
        out = _port_dense(z, z, rho, mask, cap, kind, 1.0)
        want = np.asarray(j_waterfill(z, z, rho, mask, cap, kind, dt=1.0))
        assert_close(out, want, TOL_KERNEL, TOL_KERNEL)
        assert_close(out.sum(1), cap, 1e-3, 0.0)

    def test_single_flow_takes_link(self):
        L, F = 4, 16
        rng = np.random.default_rng(7)
        w = rng.uniform(0.1, 5, (L, F)).astype(np.float32)
        bl = rng.uniform(0, 10, (L, F)).astype(np.float32)
        rho = rng.uniform(0.5, 4, (L, F)).astype(np.float32)
        mask = np.zeros((L, F), np.float32)
        keep = rng.integers(0, F, L)
        mask[np.arange(L), keep] = 1.0
        cap = rng.uniform(1, 20, L).astype(np.float32)
        kind = np.array([0, 1, 0, 1], np.int32)
        out = _port_dense(w, bl, rho, mask, cap, kind, 0.5)
        want = np.asarray(j_waterfill(w, bl, rho, mask, cap, kind, dt=0.5))
        assert_close(out, want, TOL_KERNEL, TOL_KERNEL)
        assert_close(out[np.arange(L), keep], cap, 1e-3, 0.0)

    def test_shared_rows_equal_dense_broadcast(self):
        rng = np.random.default_rng(3)
        L, F = 10, 150
        w, bl, rho = (t32(rng.uniform(lo, hi, F))
                      for lo, hi in ((0, 20), (0, 30), (0.1, 10)))
        mask = t32(rng.random((L, F)) < 0.6)
        cap = t32(rng.uniform(1, 50, L))
        kind = torch.as_tensor(rng.integers(0, 2, L).astype(np.int32))
        a = ops.waterfill_flows(w, bl, rho, mask, cap, kind, dt=0.5)
        b = ops.waterfill(*(v.expand(L, F).contiguous() for v in (w, bl, rho)),
                          mask, cap, kind, dt=0.5)
        assert torch.equal(a, b)


class TestWrapper:
    def _args(self, L=3, F=5):
        rng = np.random.default_rng(0)
        return [t32(rng.uniform(0, 1, F)) for _ in range(3)] + [
            torch.ones((L, F)), torch.ones(L), torch.zeros(L, dtype=torch.int32)]

    def test_cpu_tensors_never_launch(self):
        before = ops.LAUNCHES
        ops.waterfill_flows(*self._args(), dt=1.0)
        w, b, r, m, c, k = self._args()
        ops.waterfill(*(v.expand(3, 5).contiguous() for v in (w, b, r)),
                      m, c, k)
        assert ops.LAUNCHES == before

    def test_rejects_bad_inputs(self):
        w, b, r, m, c, k = self._args()
        with pytest.raises(TypeError, match="kind"):
            ops.waterfill_flows(w, b, r, m, c, k.to(torch.int64))
        with pytest.raises(TypeError, match="weights"):
            ops.waterfill_flows(w.double(), b, r, m, c, k)
        with pytest.raises(ValueError, match="weights"):
            ops.waterfill(w, b, r, m, c, k)   # dense entry, [F] rows
        with pytest.raises(ValueError, match="contiguous"):
            ops.waterfill_flows(w, b, r, torch.ones((5, 3)).T, c, k)
        with pytest.raises(ValueError, match="capacity"):
            ops.waterfill_flows(w, b, r, m, torch.ones(4), k)

    def test_plain_is_what_cpu_runs(self):
        args = self._args(4, 9)
        assert torch.equal(ops.waterfill_flows(*args, dt=2.0),
                           waterfill_plain(*args, 2.0))

