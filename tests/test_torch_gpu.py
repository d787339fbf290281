"""Tests of the port that need a CUDA device: the waterfill, flash-attention
and SSD chunk kernels against their plain versions, the simulator's main
path and a reduced zamba2 serve on the card against the same runs on the
CPU. They import no JAX, so they run on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each test decides inside itself whether a card is present and skips where
none is."""
import copy

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


@pytest.mark.parametrize("L,F,p,streamed", [
    (12, 12_417, 0.004, False),   # ~50 flows a row: one warp solves each
    (9, 4_001, 0.1, False),       # ~400: the block solves the list
    (6, 5_001, 0.6, True),        # ~3,000 > LIST_BUDGET: device memory
])
@pytest.mark.parametrize("offset", [0, 1])
def test_waterfill_list_and_streamed_rows(L, F, p, streamed, offset):
    """Both branches of the kernel against its plain version: odd F, a mask
    whose rows start off the 16-byte grid (``offset`` floats into its
    storage), rows with no masked flow, and all three link kinds (0 up,
    1 down, 2 internal, which the kernel treats as an uplink). Max |Δ| ≤
    1e-4·max(cap); every masked row sums to its capacity (rtol 1e-3)."""
    dev = _cuda()
    rng = np.random.default_rng(F + offset)
    w, bl, rho = (torch.tensor(rng.uniform(lo, hi, F), dtype=torch.float32,
                               device=dev)
                  for lo, hi in ((0, 20), (0, 30), (0.1, 10)))
    m = rng.random((L, F)) < p
    m[1] = False                                     # a row with no flow
    store = torch.zeros(L * F + offset, dtype=torch.float32, device=dev)
    mask = store[offset:].view(L, F)
    mask.copy_(torch.tensor(m, dtype=torch.float32))
    assert mask.is_contiguous() and mask.data_ptr() % 16 == 4 * offset
    cap = torch.tensor(rng.uniform(1, 50, L), dtype=torch.float32, device=dev)
    kind = torch.tensor(np.arange(L) % 3, dtype=torch.int32, device=dev)
    has = torch.tensor(m.any(1), device=dev)
    assert bool(ops.streamed_rows(mask)[has].all()) == streamed
    assert not bool(ops.streamed_rows(mask)[~has].any())
    tol = 1e-4 * float(cap.max())
    for out in (ops.waterfill_flows(w, bl, rho, mask, cap, kind, dt=5.0),
                ops.waterfill(*(v.expand(L, F).contiguous()
                                for v in (w, bl, rho)),
                              mask, cap, kind, dt=5.0)):
        torch.cuda.synchronize()
        plain = waterfill_plain(w, bl, rho, mask, cap, kind, 5.0)
        assert float((out - plain).abs().max()) <= tol
        rows = out.sum(1)
        assert float(((rows - cap).abs() / cap)[has].max()) <= 1e-3
        assert float(out[~has].abs().max()) == 0.0


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


# ---- the LM serving path's kernels ----------------------------------------
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,T,H,K,hd", [(2, 128, 128, 4, 2, 64),
                                          (1, 300, 300, 8, 2, 64),
                                          (2, 64, 64, 4, 1, 128),
                                          (1, 37, 100, 6, 3, 32),
                                          (2, 20, 20, 4, 4, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(B, S, T, H, K, hd, causal,
                                              dtype, tol):
    """The CUDA kernel against its plain version on the card, at the JAX
    tests' tolerances (2e-5 float32, 2e-2 bfloat16); ragged S and T."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_plain

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(S * H + hd)
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, T, K, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, T, K, hd, generator=g, device=dev).to(dtype)
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    plain = attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal).transpose(1, 2)
    err = float((out.float() - plain.float()).abs().max())
    assert err <= tol, err


@pytest.mark.parametrize("B,S,T,H,K,hd,causal,amp", [
    (3, 100, 100, 4, 2, 64, False, 1.0),   # ragged tile, last batch's end
    (3, 100, 100, 4, 4, 128, True, 1.0),
    (2, 64, 200, 4, 2, 64, False, 1.0),    # T > S
    (2, 70, 200, 8, 2, 128, True, 1.0),
    (1, 130, 130, 4, 1, 16, True, 1.0),
    (2, 128, 160, 4, 2, 64, True, 12.0),   # scores in the thousands
    (2, 96, 96, 2, 2, 32, False, 12.0),
])
def test_flash_bf16_kernel_edges(B, S, T, H, K, hd, causal, amp):
    """The bf16 kernel (tensor cores, TMA) where its tiles meet the edges:
    a ragged last tile that TMA must zero-fill rather than read from the
    next batch, more keys than queries, and scores large enough that an
    unshifted exp would overflow; against the plain version at 2e-2."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_plain

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(B * S + T + hd)
    q = (amp * torch.randn(B, S, H, hd, generator=g, device=dev)).bfloat16()
    k = (amp * torch.randn(B, T, K, hd, generator=g, device=dev)).bfloat16()
    v = torch.randn(B, T, K, hd, generator=g, device=dev).bfloat16()
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    plain = attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal).transpose(1, 2)
    assert bool(torch.isfinite(out).all())
    err = float((out.float() - plain.float()).abs().max())
    assert err <= 2e-2, err


def test_flash_bf16_rejects_misaligned_operand_on_card():
    """TMA needs a 16-byte aligned base: a contiguous view two bytes into
    its storage raises before any launch."""
    from repro_torch.kernels.flash_attention import ops as fa

    dev = _cuda()
    q = torch.randn(1, 8, 2, 16, device=dev).bfloat16()
    store = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = store[1:].view(q.shape)
    before = fa.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(shifted, q, q)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("Bsz,H,nc,Q,P,N", [(2, 3, 2, 128, 64, 64),
                                             (1, 4, 3, 128, 64, 128),
                                             (2, 2, 4, 32, 16, 8),
                                             (1, 2, 1, 12, 64, 16),
                                             (1, 3, 2, 100, 64, 64),
                                             (2, 2, 1, 100, 64, 128),
                                             (1, 2, 3, 1, 64, 64),
                                             (1, 3, 1, 1, 64, 128),
                                             (1, 2, 1, 64, 50, 72)])
def test_ssd_chunk_kernel_matches_plain(Bsz, H, nc, Q, P, N):
    """The CUDA chunk kernel against its plain version at 1e-4 (the JAX
    tests' tolerance for the chunked scan), and the whole ssd_scan on the
    card against the sequential oracle. Q 100 and 1 are the chunks of
    prompts shorter than 128 tokens (rows past Q must not move cum_end or
    the state); P 50 and N 72 leave ragged edges in the kernel's tiles."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_plain, ssd_ref_plain

    dev = _cuda()
    rng = np.random.default_rng(Q * N + H)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    BH = Bsz * H
    x = t(rng.standard_normal((BH, nc, Q, P)) * 0.5)
    dt = t(rng.uniform(0.01, 0.2, (BH, nc, Q, 1)))
    Bm = t(rng.standard_normal((Bsz, nc, Q, N)) * 0.5)
    Cm = t(rng.standard_normal((Bsz, nc, Q, N)) * 0.5)
    A = t(-rng.uniform(0.5, 2.0, (BH, 1)))
    before = ssd.LAUNCHES
    got = ssd.ssd_chunk(x, dt, Bm, Cm, A)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES == before + 1
    for g_, w_ in zip(got, ssd_chunk_plain(x, dt, Bm, Cm, A)):
        assert float((g_ - w_).abs().max()) <= 1e-4

    S = nc * Q
    xs = t(rng.standard_normal((Bsz, S, H, P)) * 0.5)
    dts = t(rng.uniform(0.01, 0.2, (Bsz, S, H)))
    As = t(-rng.uniform(0.5, 2.0, (H,)))
    Bs = t(rng.standard_normal((Bsz, S, N)) * 0.5)
    Cs = t(rng.standard_normal((Bsz, S, N)) * 0.5)
    y, h = ssd.ssd_scan(xs, dts, As, Bs, Cs, chunk=Q)
    yr, hr = ssd_ref_plain(xs, dts, As, Bs, Cs)
    assert float((y - yr).abs().max()) <= 1e-4
    assert float((h - hr).abs().max()) <= 1e-4


def test_ssd_chunk_head_groups_on_card():
    """Heads cut into groups that do not divide H (the last block takes
    fewer heads), at the serving chunk; the launch plan's shared memory is
    the kernel's own."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_plain

    dev = _cuda()
    Bsz, H, nc, Q, P, N = 4, 10, 8, 128, 64, 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ssd.ssd_plan(Bsz, H, nc, Q, P, N, sms=sms)
    assert plan.group > 1 and H % plan.group, plan
    lib = ssd._lib()
    for n in (8, 64, 72, 128):
        assert lib.ssd_chunk_smem_bytes(n) == ssd.smem_bytes(n)
    rng = np.random.default_rng(7)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    BH = Bsz * H
    args = (t(rng.standard_normal((BH, nc, Q, P)) * 0.5),
            t(rng.uniform(0.01, 0.2, (BH, nc, Q, 1))),
            t(rng.standard_normal((Bsz, nc, Q, N)) * 0.5),
            t(rng.standard_normal((Bsz, nc, Q, N)) * 0.5),
            t(-rng.uniform(0.5, 2.0, (BH, 1))))
    got = ssd.ssd_chunk(*args)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, ssd_chunk_plain(*args)):
        assert float((g_ - w_).abs().max()) <= 1e-4


@pytest.mark.parametrize("B,S,T,H,K,hd,causal", [
    (3, 100, 100, 4, 2, 64, False),    # ragged tile, last batch's end
    (3, 100, 100, 4, 4, 128, True),
    (2, 64, 200, 4, 2, 64, False),     # T > S
    (2, 70, 200, 8, 2, 128, True),
    (1, 130, 130, 4, 1, 16, True),
    (2, 96, 96, 2, 2, 32, False),
])
def test_flash_f32_kernel_edges(B, S, T, H, K, hd, causal):
    """The float32 kernel (split-TF32 on the tensor cores, TMA) where its
    tiles meet the edges: a ragged last tile that TMA must zero-fill rather
    than read from the next batch, and more keys than queries; against the
    plain version at 2e-5."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_plain

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(B * S + T + hd)
    q = torch.randn(B, S, H, hd, generator=g, device=dev)
    k = torch.randn(B, T, K, hd, generator=g, device=dev)
    v = torch.randn(B, T, K, hd, generator=g, device=dev)
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    plain = attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal).transpose(1, 2)
    assert bool(torch.isfinite(out).all())
    err = float((out - plain).abs().max())
    assert err <= 2e-5, err


def test_lm_kernels_raise_on_wrong_device_or_dtype():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd

    dev = _cuda()
    q = torch.randn(1, 8, 4, 16, device=dev)
    with pytest.raises(ValueError, match="is on"):
        fa.flash_attention(q, q.cpu(), q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    x = torch.randn(2, 1, 16, 8, device=dev)
    dt = torch.rand(2, 1, 16, 1, device=dev)
    Bm = torch.randn(1, 1, 16, 4, device=dev)
    A = -torch.rand(2, 1, device=dev)
    with pytest.raises(ValueError, match="is on"):
        ssd.ssd_chunk(x, dt.cpu(), Bm, Bm, A)
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_chunk(x.double(), dt, Bm, Bm, A)


def test_serve_on_card_matches_cpu():
    """A reduced zamba2 (with a tail layer) served on the card, through
    both kernels, against the same serve on the CPU: identical tokens, and
    prefill logits within 1e-4 (float32 on both sides, fp32 matmuls)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.models import lm
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.serve import Request, ServeEngine

    _cuda()
    cfg = get_config("zamba2-1.2b").reduced(n_layers=7)
    api = get_model(cfg)                                  # default: the card
    assert api.device.type == "cuda"
    model = api.init(torch.Generator(device="cuda").manual_seed(0))
    cpu_api = get_model(cfg, device="cpu")
    cpu_model = copy.deepcopy(model).cpu()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 64).astype(np.int32)
               for _ in range(4)]
    outs = {}
    for name, a, m in (("card", api, model), ("cpu", cpu_api, cpu_model)):
        eng = ServeEngine(a, max_len=96, batch_slots=2)
        eng.load(m)
        reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts]
        f0, s0 = fa.LAUNCHES, ssd.LAUNCHES
        eng.run(reqs)
        outs[name] = [r.out for r in reqs]
        if name == "card":
            # 2 waves x (2 shared-block applications; 7 Mamba2 layers)
            assert fa.LAUNCHES - f0 == 4 and ssd.LAUNCHES - s0 == 14
        else:
            assert fa.LAUNCHES == f0 and ssd.LAUNCHES == s0
    assert outs["card"] == outs["cpu"]
    toks = torch.tensor(np.stack(prompts[:2]), dtype=torch.long)
    lc, _ = lm.prefill(cfg, model, toks.cuda(), 96)
    lp, _ = lm.prefill(cfg, cpu_model, toks, 96)
    assert float((lc.cpu() - lp).abs().max()) <= 1e-4
