"""Tests of the port that need a CUDA device: the waterfill kernel against
its plain version, and the simulator's main path on the card against the
same run on the CPU. They import no JAX, so they run on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each test decides inside itself whether a card is present and skips where
none is."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.waterfill import ops
from repro_torch.kernels.waterfill.ref import waterfill_plain

pytestmark = pytest.mark.gpu


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("L,F,p", [(300, 1037, 0.05), (7, 200, 0.7),
                                   (1, 1, 1.0)])
def test_cuda_kernel_matches_plain(L, F, p):
    """The CUDA kernel against its plain version on the card, both layouts,
    at max|Δ| ≤ 1e-4·max(cap) (float32 sums in another order)."""
    dev = _cuda()
    rng = np.random.default_rng(L + F)
    w, bl, rho = (torch.tensor(rng.uniform(lo, hi, F), dtype=torch.float32,
                               device=dev)
                  for lo, hi in ((0, 20), (0, 30), (0.1, 10)))
    mask = torch.tensor(rng.random((L, F)) < p, dtype=torch.float32,
                        device=dev)
    cap = torch.tensor(rng.uniform(1, 50, L), dtype=torch.float32, device=dev)
    kind = torch.tensor(rng.integers(0, 2, L), dtype=torch.int32, device=dev)
    before = ops.LAUNCHES
    out = ops.waterfill_flows(w, bl, rho, mask, cap, kind, dt=5.0)
    dense = ops.waterfill(*(v.expand(L, F).contiguous() for v in (w, bl, rho)),
                          mask, cap, kind, dt=5.0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 2
    plain = waterfill_plain(w, bl, rho, mask, cap, kind, 5.0)
    tol = 1e-4 * float(cap.max())
    assert float((out - plain).abs().max()) <= tol
    assert float((dense - plain).abs().max()) <= tol


def test_wrong_device_or_dtype_raises_on_card():
    dev = _cuda()
    w = torch.ones(4, device=dev)
    mask = torch.ones((2, 4), device=dev)
    cap = torch.ones(2, device=dev)
    kind = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="mask on"):
        ops.waterfill_flows(w.cpu(), w, w, mask, cap, kind)
    with pytest.raises(TypeError, match="weights"):
        ops.waterfill_flows(w.half(), w, w, mask, cap, kind)


def test_simulate_on_card_matches_cpu():
    """The main path on the card (default device, appaware through the
    kernel) against the same run on the CPU, at the run tolerance of the
    CPU parity tests (1e-4 relative)."""
    _cuda()
    from repro_torch.net import big_switch
    from repro_torch.streams import (compile_sim, parallelize, round_robin,
                                     simulate, trucking_iot)

    g = parallelize(trucking_iot(), seed=0)
    topo = big_switch(8, 1.875)
    sim = compile_sim(g, topo, round_robin(g, 8))        # default: the card
    assert sim.device.type == "cuda"
    before = ops.LAUNCHES
    on_card = simulate(sim, "appaware", seconds=120.0, solver="waterfill")
    assert ops.LAUNCHES - before == 24                   # every 5 s
    on_cpu = simulate(sim, "appaware", seconds=120.0, solver="waterfill",
                      device="cpu")
    np.testing.assert_allclose(on_card.metrics, on_cpu.metrics, rtol=1e-4,
                               atol=1e-4)
    tcp_card = simulate(sim, "tcp", seconds=120.0)
    tcp_cpu = simulate(sim, "tcp", seconds=120.0, device="cpu")
    np.testing.assert_allclose(tcp_card.metrics, tcp_cpu.metrics, rtol=1e-4,
                               atol=1e-4)
