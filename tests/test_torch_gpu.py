"""Tests of the port that need a CUDA device: the waterfill, flash-attention
and SSD chunk kernels against their plain versions (waterfill also in its
fleet layout; flash also at the moe, vlm and encdec models' launch shapes),
the simulator's main path, a fleet run, ``moe_ffn`` and reduced zamba2,
qwen3-moe, internvl2 and whisper serves on the card against the same runs
on the CPU, two bitwise-equal card runs of ``moe_ffn``, a faulted and
resumed campaign on the card, a campaign on four streams of the one card
bit for bit one stream's, campaigns replayed from CUDA graphs bit for bit
the eager loop (and a capture that raises, counted as a fallback), and a
meshed train state saved, restored and
replayed on a one-rank CUDA mesh. They import no JAX, so they run on a machine
that has only PyTorch:

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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,T,H,K,hd,causal", [
    (1, 512, 512, 64, 4, 128, True),      # qwen3-moe: G 16 at hd 128
    (1, 512, 512, 48, 8, 128, True),      # dbrx: G 6
    (1, 768, 768, 14, 2, 64, True),       # internvl2: G 7, 256 + 512 rows
    (1, 1500, 1500, 6, 6, 64, False),     # whisper's encoder
    (2, 4, 1500, 6, 6, 64, False),        # whisper's cross-attention
])
def test_flash_kernel_at_the_new_serving_launches(B, S, T, H, K, hd, causal,
                                                  dtype, tol):
    """The flash kernels at the launch shapes the moe, vlm and encdec
    models give them (batch cut to 1-2), against the plain version at the
    JAX tests' tolerances; 1,500 is not a multiple of the 64-row tile."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_plain

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(S + H + K)
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, T, K, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, T, K, hd, generator=g, device=dev).to(dtype)
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    plain = attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal).transpose(1, 2)
    assert bool(torch.isfinite(out).all())
    err = float((out.float() - plain.float()).abs().max())
    assert err <= tol, err


def _moe_inputs(dev, dtype, T=256, D=256, F=128, E=16, seed=0):
    from repro_torch.models import blocks as B

    g = torch.Generator(device=dev).manual_seed(seed)
    p = {k: (0.3 * torch.randn(s.shape, generator=g, device=dev)).to(dtype)
         for k, s in B.moe_specs(D, F, E).items()}
    x = torch.randn(2, T // 2, D, generator=g, device=dev).to(dtype)
    return p, x


def test_moe_ffn_on_card_matches_cpu():
    """``moe_ffn`` in float32 on the card against the CPU, same inputs:
    the same routing and dropped slots, output and aux within 1e-5
    relative to max|out|."""
    from repro_torch.models import blocks as B

    dev = _cuda()
    p, x = _moe_inputs(dev, torch.float32)
    runs = {}
    for name, pp, xx in (("card", p, x),
                         ("cpu", {k: v.cpu() for k, v in p.items()}, x.cpu())):
        with B.record_routes() as routes:
            out, aux = B.moe_ffn(pp, xx, 16, 4, 1.0)
        (route,) = routes
        runs[name] = (out.cpu(), aux.cpu(), route["top_idx"].cpu(),
                      int(route["dropped"]))
    (oc, ac, ic, dc), (op, ap, ip, dp) = runs["card"], runs["cpu"]
    assert torch.equal(ic, ip) and dc == dp and dc > 0
    scale = float(op.abs().max())
    assert float((oc - op).abs().max()) <= 1e-5 * scale
    assert abs(float(ac) - float(ap)) <= 1e-5 * abs(float(ap))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_on_card_is_bitwise_repeatable(dtype):
    """Two card runs of ``moe_ffn`` on the same inputs give the same bits:
    the combine gathers and sums in a fixed order, with no atomics."""
    from repro_torch.models import blocks as B

    dev = _cuda()
    p, x = _moe_inputs(dev, dtype, T=2048, D=512, F=256, E=32, seed=1)
    a, aux_a = B.moe_ffn(p, x, 32, 8, 1.25)
    b, aux_b = B.moe_ffn(p, x, 32, 8, 1.25)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "internvl2-1b",
                                  "whisper-tiny"])
def test_new_families_serve_on_card_as_on_cpu(arch):
    """A reduced moe, vlm and encdec model served on the card (flash in
    every prefill attention) and on the CPU from the same weights and the
    same patch or frame prefix: identical tokens, and the flash launches
    the family's prefill makes (per wave: one per layer; whisper one per
    encoder layer and two per decoder layer)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.serve import Request, ServeEngine

    _cuda()
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    model = api.init(torch.Generator(device="cuda").manual_seed(0))
    cpu_model = copy.deepcopy(model).cpu()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 16).astype(np.int32)
               for _ in range(4)]
    extra = {}
    if cfg.family == "vlm":
        extra["vis_embeds"] = rng.standard_normal(
            (2, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal(
            (2, 100, cfg.d_model)).astype(np.float32)
    per_wave = (cfg.n_enc_layers + 2 * cfg.n_layers
                if cfg.family == "encdec" else cfg.n_layers)
    outs = {}
    for name, a, m in (("card", api, model),
                       ("cpu", get_model(cfg, device="cpu"), cpu_model)):
        eng = ServeEngine(a, max_len=48, batch_slots=2)
        eng.load(m)
        reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts]
        before = fa.LAUNCHES
        eng.run(reqs, extra_batch=extra)
        outs[name] = [r.out for r in reqs]
        assert fa.LAUNCHES - before == (2 * per_wave if name == "card"
                                        else 0)
    assert outs["card"] == outs["cpu"]


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


@pytest.mark.parametrize("B,L,F,p", [
    (3, 16, 17, 0.3),         # a paper-grid bucket
    (256, 16, 17, 0.2),       # a campaign chunk
    (4_100, 16, 40, 0.1),     # B·L = 65,600 blocks, past 65,535
])
def test_waterfill_fleet_matches_plain(B, L, F, p):
    """One launch of B·L blocks against the plain version at max|Δ| ≤
    1e-4·max(cap), and each scenario's slice bit for bit equal to
    ``waterfill_flows`` on that scenario alone (the group stride reads the
    right flow row)."""
    dev = _cuda()
    rng = np.random.default_rng(B + L + F)

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=dev)
    w, bl, rho = (t(rng.uniform(lo, hi, (B, F)).astype(np.float32))
                  for lo, hi in ((0, 20), (0, 30), (0.1, 10)))
    mask = t((rng.random((B, L, F)) < p).astype(np.float32))
    cap = t(rng.uniform(1, 50, (B, L)).astype(np.float32))
    kind = t(rng.integers(0, 2, (B, L)), torch.int32)
    before = ops.LAUNCHES
    out = ops.waterfill_fleet(w, bl, rho, mask, cap, kind, dt=5.0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    plain = ops.waterfill_fleet(*(a.cpu() for a in (w, bl, rho, mask, cap,
                                                     kind)), dt=5.0)
    assert float((out.cpu() - plain).abs().max()) <= 1e-4 * float(cap.max())
    for b in {0, B // 2, B - 1}:
        one = ops.waterfill_flows(w[b], bl[b], rho[b], mask[b], cap[b],
                                  kind[b], dt=5.0)
        assert torch.equal(out[b], one)


def test_fleet_bucket_on_card_matches_cpu():
    """A fleet run on the card against the same run on the CPU (plain
    waterfill there): tcp and appaware through the kernel, 20 s, at the
    fleet tests' tolerances; appaware makes one waterfill launch per bucket
    update."""
    from repro_torch.streams import FleetRunner, compile_fleet, seed_fleet

    dev = _cuda()
    sims = compile_fleet(seed_fleet(seed=0)[:8], device="cpu")
    card = FleetRunner(device=dev, tick_overhead=15e3)
    host = FleetRunner(device="cpu", tick_overhead=15e3)
    for policy, solver in (("tcp", "sort"), ("appaware", "waterfill")):
        before = ops.LAUNCHES
        got = card.run(sims, policy, seconds=20.0, solver=solver)
        launched = ops.LAUNCHES - before
        want = host.run(sims, policy, seconds=20.0, solver=solver)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.sink_mb, w.sink_mb, atol=1e-4)
            np.testing.assert_allclose(g.latency, w.latency, rtol=1e-4,
                                       atol=1e-3)
            np.testing.assert_allclose(g.link_load, w.link_load, atol=1e-4)
        if solver == "waterfill":
            assert launched == card.last_stats["n_buckets"] * 4  # 40 ticks
        else:
            assert launched == 0


def test_faulted_campaign_on_card(tmp_path):
    """The campaign on the card: a transient transfer fault and a poisoned
    scenario leave every other row bit for bit equal to the fault-free
    campaign, exactly the poisoned scenario is quarantined, and a killed
    campaign resumes from its checkpoint running only what was not done."""
    from repro_torch.streams import (FaultAbort, FaultPlan, FaultSpec,
                                     FleetRunner, campaign_fleet,
                                     compile_fleet)

    dev = _cuda()
    sims = compile_fleet(campaign_fleet(48, seed=0), device="cpu")
    runner = FleetRunner(device=dev)
    kw = dict(seconds=6.0, chunk_rows=8, retry_backoff_s=0.001,
              retry_backoff_cap_s=0.01)
    clean = runner.run_campaign(sims, "appaware", solver="waterfill",
                                **kw).metrics.copy()
    n_chunks = runner.last_stats["n_chunks"]
    fp = FaultPlan([FaultSpec("transfer", chunk=1, times=1)], poison={9})
    cr = runner.run_campaign(sims, "appaware", solver="waterfill", faults=fp,
                             **kw)
    assert runner.last_stats["status"] == "ok"
    assert cr.quarantined.tolist() == [9]
    ok = np.arange(len(sims)) != 9
    np.testing.assert_array_equal(cr.metrics[ok], clean[ok])
    ck = str(tmp_path / "ck")
    with pytest.raises(FaultAbort):
        runner.run_campaign(sims, "appaware", solver="waterfill",
                            checkpoint=ck,
                            faults=FaultPlan([FaultSpec("abort",
                                                        chunk=n_chunks - 1)]),
                            **kw)
    done = runner.last_stats["n_chunks_done"]
    assert 0 < done < n_chunks
    cr = runner.run_campaign(sims, "appaware", solver="waterfill",
                             checkpoint=ck, **kw)
    assert runner.last_stats["n_dispatches"] == n_chunks - done
    np.testing.assert_array_equal(cr.metrics, clean)


@pytest.mark.parametrize("policy", ["tcp", "appaware", "appfair", "fixed"])
def test_campaign_on_four_streams_of_one_card(policy):
    """``run_campaign(shard=["cuda:0"] * 4)``: four streams on the one card,
    each with its own copy and compute stream, give the one-stream
    campaign's metrics bit for bit; appaware launches the waterfill kernel
    on every stream, as many launches in all as one stream. ``run`` over
    the four keeps every trajectory bit for bit."""
    from repro_torch.streams import FleetRunner, campaign_fleet, compile_fleet

    dev = _cuda()
    sims = compile_fleet(campaign_fleet(54, seed=0), device="cpu")
    kw = dict(seconds=8.0, chunk_rows=16)
    if policy == "fixed":
        kw["x_fixed"] = [np.full(s.R.shape[0], 0.25, np.float32)
                         for s in sims]
    if policy == "appaware":
        kw["solver"] = "waterfill"
    runner = FleetRunner(device=dev)
    ops.LAUNCHES = 0
    one = runner.run_campaign(sims, policy, shard=False, **kw)
    n_one = ops.LAUNCHES
    ops.LAUNCHES = 0
    ops.STREAM_LAUNCHES.clear()
    four = runner.run_campaign(sims, policy, shard=["cuda:0"] * 4, **kw)
    st = runner.last_stats
    assert st["n_streams"] == 4 and st["n_chunks"] >= 4
    assert st["peak_staged_rows"] <= 3 * st["chunk_rows"] * 4
    np.testing.assert_array_equal(four.metrics, one.metrics)
    if policy == "appaware":
        assert ops.LAUNCHES == n_one > 0
        per = list(ops.STREAM_LAUNCHES.values())
        assert len(per) == 4 and min(per) > 0, per
    else:
        assert ops.LAUNCHES == 0
    if policy in ("tcp", "appaware"):
        run_kw = {k: v for k, v in kw.items() if k != "chunk_rows"}
        a = runner.run(sims, policy, shard=["cuda:0"] * 4, **run_kw)
        b = runner.run(sims, policy, shard=False, **run_kw)
        for x, y in zip(a, b):
            for f in ("sink_mb", "link_load", "latency"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


# ---- the campaign's tick loops as CUDA graphs -------------------------------
def _eager_bucket(pack, *args, **kw):
    """``_run_bucket`` run to its end through its per-tick generator: the
    eager loop, which ``FleetRunner.run`` drives too."""
    from repro_torch.streams.simulator import _run_bucket

    loop = _run_bucket(pack, *args, stepwise=True, **kw)
    while True:
        try:
            next(loop)
        except StopIteration as stop:
            return stop.value


def _graph_campaign_case(policy, solver):
    from repro_torch.streams import campaign_fleet, compile_fleet

    sims = compile_fleet(campaign_fleet(54, seed=0), device="cpu")
    kw = dict(seconds=8.0, chunk_rows=8, solver=solver)
    if policy == "fixed":
        kw["x_fixed"] = [np.full(s.R.shape[0], 0.25, np.float32)
                         for s in sims]
    return sims, kw


def _eager_runner(dev):
    from repro_torch.streams import FleetRunner

    runner = FleetRunner(device=dev)
    runner._graphs.run = _eager_bucket
    return runner


@pytest.mark.parametrize("policy,solver", [
    ("appaware", "waterfill"), ("appaware", "sort"), ("tcp", "sort"),
    ("fixed", "sort"), ("appfair", "sort")])
def test_campaign_from_graphs_is_the_eager_loop(policy, solver):
    """On the card ``run_campaign`` replays each chunk's tick loop from a
    CUDA graph: its rows are the eager loop's bit for bit, in a first call
    (the first chunk eager, each new signature captured) and in a second
    (every chunk replayed, ``graph_tick_share`` 1.0). Chunks of 8 rows give
    several chunks of one signature, kept two in flight on the one stream:
    each keeps its own rows. The waterfill kernel's launches count as the
    eager run's."""
    from repro_torch.streams import FleetRunner

    dev = _cuda()
    sims, kw = _graph_campaign_case(policy, solver)
    ops.LAUNCHES = 0
    want = _eager_runner(dev).run_campaign(sims, policy, **kw).metrics
    n_eager = ops.LAUNCHES
    runner = FleetRunner(device=dev)
    for call in (1, 2):
        ops.LAUNCHES = 0
        got = runner.run_campaign(sims, policy, **kw)
        st = runner.last_stats
        np.testing.assert_array_equal(got.metrics, want)
        assert ops.LAUNCHES == n_eager
        assert st["n_graph_fallbacks"] == 0
        n_sigs = len(runner._graphs._entries)
        assert st["n_chunks"] > n_sigs > 0          # signatures repeat
        if call == 1:
            assert st["n_graph_captures"] == n_sigs
            assert st["n_graph_replays"] == st["n_chunks"] - 1
        else:
            assert st["n_graph_captures"] == 0
            assert st["n_graph_replays"] == st["n_chunks"]
            assert st["graph_tick_share"] == 1.0
    assert (n_eager > 0) == (solver == "waterfill")


def test_rerouting_campaign_from_graphs_is_the_eager_loop():
    """A small fat tree whose aggregation links fail and are routed around,
    beside static scenarios: each replayed chunk (its ticks on the route
    tables of their state, the dense bank gathered at controller updates)
    gives the eager loop's rows bit for bit, and each row is the
    scenario's own ``simulate`` on the card as the campaign tests hold
    them."""
    from repro_torch.net.topology import fat_tree, link_failure_schedule
    from repro_torch.streams import (FleetRunner, compile_sim, nexmark_q4,
                                     parallelize, round_robin, simulate)

    dev = _cuda()
    topo = fat_tree(4, 4, 4, up=125.0, internal=125.0)
    internal = np.arange(32, topo.n_links)
    rng = np.random.default_rng(5)
    sims = []
    for k in range(12):
        graph = parallelize(nexmark_q4(2, 6, 8, 5, 307.4, 942.6), seed=k)
        sched = None if k % 4 == 0 else link_failure_schedule(
            topo, sorted(rng.choice(internal, 2, replace=False)), 2.5, 6.5,
            0.1)
        sims.append(compile_sim(graph, topo,
                                round_robin(graph, topo.n_machines),
                                schedule=sched, reroute=sched is not None,
                                device="cpu"))
    kw = dict(seconds=10.0, dt=0.5, solver="waterfill", chunk_rows=4,
              t_event=3.0)
    want = _eager_runner(dev).run_campaign(sims, "appaware", **kw).metrics
    runner = FleetRunner(device=dev)
    for call in (1, 2):
        got = runner.run_campaign(sims, "appaware", **kw)
        np.testing.assert_array_equal(got.metrics, want)
        st = runner.last_stats
        assert st["n_graph_fallbacks"] == 0 and st["route_gather_bytes"] > 0
    assert st["graph_tick_share"] == 1.0
    for i, sim in enumerate(sims):
        one = simulate(sim, "appaware", seconds=10.0, dt=0.5,
                       solver="waterfill", t_event=3.0, device=dev)
        np.testing.assert_allclose(got.metrics[i], one.metrics, rtol=1e-5,
                                   atol=1e-6)


def test_graph_spans_take_the_place_of_the_tick_spans():
    """Recorded on the card: a first call's eager chunk records its tick
    spans, each signature one ``capture`` (with no tick span of its own:
    they would time the capture) and each other chunk one ``replay``, all
    inside ``dispatch``; a second call only replays."""
    from repro_torch import tracing
    from repro_torch.streams import FleetRunner

    dev = _cuda()
    sims, kw = _graph_campaign_case("appaware", "waterfill")
    runner = FleetRunner(device=dev)
    for call in (1, 2):
        with tracing.recording() as rec:
            runner.run_campaign(sims, "appaware", **kw)
        st = runner.last_stats
        names = [s.name for s in rec.spans]
        by_id = {s.id: s for s in rec.spans}
        for s in rec.spans:
            if s.name in ("capture", "replay"):
                assert by_id[s.parent].name == "dispatch"
        eager_ticks = 0 if call == 2 else st["n_ticks"] // st["n_chunks"]
        assert names.count("advance") == eager_ticks
        assert names.count("capture") == st["n_graph_captures"]
        assert names.count("replay") == st["n_graph_replays"]
        assert st["n_graph_captures"] == (len(runner._graphs._entries)
                                          if call == 1 else 0)


def test_a_capture_that_raises_falls_back_and_is_counted(monkeypatch):
    """A signature whose capture raises runs eager from then on: counted in
    ``n_graph_fallbacks``, nothing captured or replayed, the rows the eager
    loop's."""
    from repro_torch.streams import FleetRunner
    from repro_torch.streams import simulator

    dev = _cuda()
    sims, kw = _graph_campaign_case("appaware", "waterfill")
    want = _eager_runner(dev).run_campaign(sims, "appaware", **kw).metrics
    epilogue = simulator._metrics_epilogue

    def refuses_capture(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("not capturable")
        return epilogue(*a, **k)

    monkeypatch.setattr(simulator, "_metrics_epilogue", refuses_capture)
    runner = FleetRunner(device=dev)
    for call in (1, 2):
        got = runner.run_campaign(sims, "appaware", **kw)
        st = runner.last_stats
        np.testing.assert_array_equal(got.metrics, want)
        assert st["n_graph_captures"] == st["n_graph_replays"] == 0
        assert st["graph_tick_share"] == 0.0
        entries = runner._graphs._entries
        assert entries and all(e is None for e in entries.values())
        assert st["n_graph_fallbacks"] == (len(entries) if call == 1 else 0)


# ---- the training path ----------------------------------------------------
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,S,T,H,K,hd,causal", [
    (2, 200, 200, 8, 2, 64, True),
    (1, 64, 300, 6, 6, 32, False),
])
def test_flash_attention_backward_on_card_matches_cpu(B, S, T, H, K, hd,
                                                       causal, dtype, tol):
    """``FlashAttention`` on the card (the kernel forward, the plain vjp
    backward) against the same function on the CPU: outputs and the q, k, v
    gradients within ``tol`` of their largest magnitude (float32: fp32
    matmuls; bfloat16: the kernel's forward and the gradients' cast)."""
    from repro_torch.kernels.flash_attention import ops as fa

    dev = _cuda()
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(S + T)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]
    go = torch.tensor(rng.standard_normal((B, S, H, hd)), dtype=dtype)
    res = {}
    for side in ("cuda", "cpu"):
        ins = [torch.tensor(a, dtype=dtype, device=side).requires_grad_()
               for a in arrs]
        before = fa.LAUNCHES
        out = fa.flash_attention(*ins, causal=causal)
        grads = torch.autograd.grad(out, ins, go.to(side))
        assert fa.LAUNCHES - before == (1 if side == "cuda" else 0)
        res[side] = [t.detach().float().cpu() for t in (out, *grads)]
    for got, want in zip(res["cuda"], res["cpu"]):
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())


def test_ssd_chunk_backward_on_card_matches_cpu():
    """``SsdChunk`` on the card against the CPU: the three outputs and the
    five input gradients within 1e-4 of their largest magnitude."""
    from repro_torch.kernels.ssd_scan import ops as ssd

    _cuda()
    rng = np.random.default_rng(3)
    BH, nc, Q, P, N, Bsz = 2 * 8, 4, 128, 64, 64, 2
    arrs = [rng.standard_normal((BH, nc, Q, P)) * 0.5,
            rng.uniform(0.01, 0.2, (BH, nc, Q, 1)),
            rng.standard_normal((Bsz, nc, Q, N)) * 0.5,
            rng.standard_normal((Bsz, nc, Q, N)) * 0.5,
            -rng.uniform(0.5, 2.0, (BH, 1))]
    cots = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
            for s in ((BH, nc, Q, P), (BH, nc, P, N), (BH, nc, Q, 1))]
    res = {}
    for side in ("cuda", "cpu"):
        ins = [torch.tensor(a, dtype=torch.float32,
                            device=side).requires_grad_() for a in arrs]
        before = ssd.LAUNCHES
        outs = ssd.ssd_chunk(*ins)
        grads = torch.autograd.grad(outs, ins, [c.to(side) for c in cots])
        assert ssd.LAUNCHES - before == (1 if side == "cuda" else 0)
        res[side] = [t.detach().cpu() for t in (*outs, *grads)]
    for got, want in zip(res["cuda"], res["cpu"]):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_train_step_on_card_matches_cpu(name):
    """One float32 train step of a 2-layer reduced model (zamba2: one group
    of 2 Mamba2 layers and the shared block) on the card, through the
    kernels, against the CPU: the loss within 1e-5 relative, every gradient
    leaf within 1e-4·max|g_leaf|, and the kernels launched once in the
    forward and once in the recompute."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.models.lm import rebuild
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import make_train_step

    _cuda()
    over = {"n_layers": 2, "ssd_chunk": 32}
    if name == "zamba2-1.2b":
        over["hybrid_attn_every"] = 2
    cfg = get_config(name).reduced(**over)
    api, cpu_api = get_model(cfg), get_model(cfg, device="cpu")
    model = api.init(torch.Generator(device="cuda").manual_seed(0),
                     trainable=True)
    cpu_model = rebuild(model, {k: p.detach().cpu()
                                for k, p in model.named_parameters()})
    b = SyntheticLM(vocab=cfg.vocab, seq_len=128, global_batch=2).batch(0)
    res = {}
    for side, a, m in (("cuda", api, model), ("cpu", cpu_api, cpu_model)):
        batch = {k: torch.as_tensor(v, dtype=torch.long, device=side)
                 for k, v in b.items()}
        kept = {}
        opt = AdamW(lr=1e-3)
        f0, s0 = fa.LAUNCHES, ssd.LAUNCHES
        _, _, met = make_train_step(
            a, opt, grad_transform=lambda g: kept.update(g) or g)(
            m, opt.init(m), batch)
        res[side] = (float(met["loss"]), kept,
                     (fa.LAUNCHES - f0, ssd.LAUNCHES - s0))
    loss, grads, launched = res["cuda"]
    cpu_loss, cpu_grads, cpu_launched = res["cpu"]
    attn = {"qwen1.5-0.5b": 2, "mamba2-370m": 0, "zamba2-1.2b": 1}[name]
    mamba = 0 if name == "qwen1.5-0.5b" else 2
    assert launched == (2 * attn, 2 * mamba) and cpu_launched == (0, 0)
    assert abs(loss / cpu_loss - 1) <= 1e-5
    for k, g in cpu_grads.items():
        assert float((grads[k].cpu() - g).abs().max()) <= 1e-4 * float(
            g.abs().max()), k


def test_checkpoint_restores_onto_the_card(tmp_path):
    """A state saved from the CPU comes back on the card by default."""
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.optim import AdamW

    _cuda()
    api = get_model(get_config("qwen1.5-0.5b").reduced(n_layers=2),
                    device="cpu")
    params = api.init(torch.Generator().manual_seed(0), trainable=True)
    opt_state = AdamW().init(params)
    ck = Checkpointer(tmp_path)
    ck.save(3, {"params": params, "opt": opt_state})
    state, step = ck.restore({"params": params, "opt": opt_state})
    assert step == 3
    for (n, a), (_, b) in zip(params.named_parameters(),
                              state["params"].named_parameters()):
        assert b.device.type == "cuda" and b.requires_grad
        assert torch.equal(a, b.cpu()), n
    assert state["opt"].step.device.type == "cuda"
    assert all(t.device.type == "cuda" for t in state["opt"].m.values())


def test_kernel_wrappers_on_meta_launch_nothing():
    """On meta tensors each wrapper is a shape function, on a machine with
    a card too: the kernels' output shapes and dtypes, no launch."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd

    _cuda()
    before = (fa.LAUNCHES, ssd.LAUNCHES, ops.LAUNCHES)
    q = torch.empty(2, 4096, 32, 64, dtype=torch.bfloat16, device="meta")
    o = fa.flash_attention(q, q, q, causal=True)
    assert o.is_meta and o.shape == q.shape and o.dtype == q.dtype
    f32 = dict(dtype=torch.float32, device="meta")
    y, st, cum = ssd.ssd_chunk(
        torch.empty(128, 32, 128, 64, **f32), torch.empty(128, 32, 128, 1,
                                                          **f32),
        torch.empty(2, 32, 128, 64, **f32), torch.empty(2, 32, 128, 64, **f32),
        torch.empty(128, 1, **f32))
    assert [tuple(t.shape) for t in (y, st, cum)] == [
        (128, 32, 128, 64), (128, 32, 64, 64), (128, 32, 128, 1)]
    r = ops.waterfill_flows(*(torch.empty(9, **f32) for _ in range(3)),
                            torch.empty(3, 9, **f32), torch.empty(3, **f32),
                            torch.empty(3, dtype=torch.int32, device="meta"))
    assert r.is_meta and tuple(r.shape) == (3, 9)
    assert (fa.LAUNCHES, ssd.LAUNCHES, ops.LAUNCHES) == before


def test_local_map_on_one_rank_cuda_mesh_matches_plain_calls():
    """Flash (H 8 over K 2, bfloat16) and ``ssd_scan`` on replicated
    DTensors on a 1×1 CUDA mesh (NCCL, one rank) reach the kernels through
    ``local_map``: the same bits as the plain calls on the same tensors,
    one launch each."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch.mesh import local_world, make_mesh
    from repro_torch.sharding.policy import sharding_policy

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 256, 8, 64, device=dev, generator=g,
                    dtype=torch.bfloat16)
    k = torch.randn(2, 256, 2, 64, device=dev, generator=g,
                    dtype=torch.bfloat16)
    v = torch.randn(2, 256, 2, 64, device=dev, generator=g,
                    dtype=torch.bfloat16)
    x = torch.randn(2, 256, 4, 64, device=dev, generator=g) * 0.5
    dt = torch.rand(2, 256, 4, device=dev, generator=g) * 0.2 + 0.01
    A = -(torch.rand(4, device=dev, generator=g) + 0.5)
    Bm = torch.randn(2, 256, 32, device=dev, generator=g) * 0.5
    want_o = fa.flash_attention(q, k, v, causal=True)
    want_y, want_h = ssd.ssd_scan(x, dt, A, Bm, Bm, chunk=128)
    with local_world("cuda"):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")

        def rep(t):
            return DTensor.from_local(t, mesh, [Replicate()] * 2,
                                      run_check=False)
        with sharding_policy(mesh):
            f0, s0 = fa.LAUNCHES, ssd.LAUNCHES
            o = fa.flash_attention(rep(q), rep(k), rep(v), causal=True)
            y, h = ssd.ssd_scan(*(rep(t) for t in (x, dt, A, Bm, Bm)),
                                chunk=128)
            torch.cuda.synchronize()
            assert (fa.LAUNCHES - f0, ssd.LAUNCHES - s0) == (1, 1)
        assert torch.equal(o.to_local(), want_o)
        assert torch.equal(y.to_local(), want_y)
        assert torch.equal(h.to_local(), want_h)


def _rank_of_cuda_world(n: int, rank: int, shape):
    """Rank ``rank`` of a dry world of ``n`` ranks (the "fake" backend, in
    this process) and a "cuda" ("data", "model") mesh of ``shape`` on it."""
    import contextlib

    from repro_torch.launch.mesh import dry_world, make_mesh

    stack = contextlib.ExitStack()
    stack.enter_context(dry_world(n, rank=rank))
    return stack, make_mesh(shape, ("data", "model"), "cuda")


def _replicated_leaf(t, mesh):
    """A replicated DTensor leaf holding a copy of ``t``, whose gradient
    keeps the placements the backward gives it."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t.clone(), mesh, [Replicate()] * mesh.ndim,
                              run_check=False).requires_grad_()


@pytest.mark.parametrize("H,K,kv_split", [(8, 2, True), (8, 4, True),
                                          (8, 4, False)])
def test_flash_on_sharded_heads_of_a_cuda_mesh(H, K, kv_split):
    """Each rank of a dry (1, 4) world on a "cuda" mesh, inputs replicated
    and split at the call site as the model splits them (query heads on
    "heads"; KV heads on "kv_heads" where ``kv_split``, which replicates
    K 2, else whole): the kernel runs on the rank's query heads and
    exactly their KV heads (K < 4: a local G unlike the global one), one
    launch a rank; its output equals the rank's heads of the unsharded
    kernel call (1e-5), its q gradient theirs and the ranks' KV gradients
    sum to the unsharded ones (1e-4; the backward is the plain vjp, whose
    products run at other shapes), partial sums where the rank read some
    of the KV heads."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.sharding import policy as pol

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(2, 256, h, 64, device=dev, generator=g)
               for h in (H, K, K))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    full = fa.flash_attention(*leaves, causal=True)
    up = torch.randn(full.shape, device=dev, generator=g)
    (full * up).sum().backward()
    gk, gv = torch.zeros_like(k), torch.zeros_like(v)
    kv_axes = ("batch", "seq", "kv_heads" if kv_split else None, None)
    for rank in range(4):
        stack, mesh = _rank_of_cuda_world(4, rank, (1, 4))
        with stack, pol.sharding_policy(mesh):
            ql, kl, vl = (_replicated_leaf(t, mesh) for t in (q, k, v))
            qd = pol.shard_as(ql, "batch", "seq", "heads", None)
            kd, vd = (pol.shard_as(t, *kv_axes) for t in (kl, vl))
            f0 = fa.LAUNCHES
            out = fa.flash_attention(qd, kd, vd, causal=True)
            torch.cuda.synchronize()
            assert fa.LAUNCHES - f0 == 1
            hs = slice(rank * H // 4, (rank + 1) * H // 4)
            assert out.to_local().shape == full[:, :, hs].shape
            assert torch.allclose(out.to_local(), full[:, :, hs].detach(),
                                  rtol=1e-5, atol=1e-5)
            (out.to_local() * up[:, :, hs]).sum().backward()
        assert torch.allclose(ql.grad.to_local()[:, :, hs],
                              leaves[0].grad[:, :, hs], rtol=1e-4, atol=1e-4)
        partial = K % 4 or not kv_split
        for t in (kl, vl):
            assert tuple(t.grad.placements) == (
                Replicate(), Partial() if partial else Replicate())
        if partial:
            gk += kl.grad.to_local()
            gv += vl.grad.to_local()
        else:
            ks = slice(rank * K // 4, (rank + 1) * K // 4)
            gk[:, :, ks] += kl.grad.to_local()[:, :, ks]
            gv[:, :, ks] += vl.grad.to_local()[:, :, ks]
    assert torch.allclose(gk, leaves[1].grad, rtol=1e-4, atol=1e-4)
    assert torch.allclose(gv, leaves[2].grad, rtol=1e-4, atol=1e-4)


def test_ssd_scan_on_sharded_heads_of_a_cuda_mesh():
    """Each rank of a dry (1, 4) world on a "cuda" mesh: x split by heads
    at the call site ("inner", as ``mamba2_forward`` splits it), B and C
    whole, so the kernel infers the local head count H / 4 from its shard,
    one launch a rank; y and the final state equal the rank's heads of the
    unsharded call (1e-5), its x gradient theirs and the ranks' B and C
    gradients, partial sums, add up to the unsharded ones (1e-4)."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.sharding import policy as pol

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    Bsz, L, H, P, N = 2, 256, 8, 64, 64
    x = torch.randn(Bsz, L, H, P, device=dev, generator=g) * 0.5
    dt = torch.rand(Bsz, L, H, device=dev, generator=g) * 0.2 + 0.01
    A = -(torch.rand(H, device=dev, generator=g) * 1.5 + 0.5)
    Bm = torch.randn(Bsz, L, N, device=dev, generator=g) * 0.5
    Cm = torch.randn(Bsz, L, N, device=dev, generator=g) * 0.5
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, h = ssd.ssd_scan(*leaves, chunk=128)
    up = torch.randn(y.shape, device=dev, generator=g)
    (y * up).sum().backward()
    gb, gc = torch.zeros_like(Bm), torch.zeros_like(Cm)
    for rank in range(4):
        stack, mesh = _rank_of_cuda_world(4, rank, (1, 4))
        with stack, pol.sharding_policy(mesh):
            loc = [_replicated_leaf(t, mesh) for t in (x, dt, A, Bm, Cm)]
            xd = pol.shard_as(loc[0], "batch", "seq", "inner", None)
            s0 = ssd.LAUNCHES
            yl, hl = ssd.ssd_scan(xd, *loc[1:], chunk=128)
            torch.cuda.synchronize()
            assert ssd.LAUNCHES - s0 == 1
            hs = slice(rank * H // 4, (rank + 1) * H // 4)
            assert yl.to_local().shape == y[:, :, hs].shape
            assert torch.allclose(yl.to_local(), y[:, :, hs].detach(),
                                  rtol=1e-5, atol=1e-5)
            assert torch.allclose(hl.to_local(), h[:, hs].detach(),
                                  rtol=1e-5, atol=1e-5)
            (yl.to_local() * up[:, :, hs]).sum().backward()
        assert torch.allclose(loc[0].grad.to_local()[:, :, hs],
                              leaves[0].grad[:, :, hs], rtol=1e-4, atol=1e-4)
        for t in loc[3:]:
            assert tuple(t.grad.placements) == (Replicate(), Partial())
        gb += loc[3].grad.to_local()
        gc += loc[4].grad.to_local()
    assert torch.allclose(gb, leaves[3].grad, rtol=1e-4, atol=1e-4)
    assert torch.allclose(gc, leaves[4].grad, rtol=1e-4, atol=1e-4)


def test_meshed_zamba2_step_on_card_matches_unmeshed():
    """A reduced zamba2 train step (one group of 2 Mamba2 layers and the
    shared block, bfloat16 compute) on a 1×1 CUDA mesh, parameters placed
    by ``param_shardings``: the loss and the new weights equal the
    unmeshed step's on the card (1e-6 relative), with the same kernel
    launches."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch import shardings as S
    from repro_torch.launch.mesh import local_world, make_mesh
    from repro_torch.models import lm
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.sharding.policy import sharding_policy
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import make_train_step

    dev = _cuda()
    cfg = get_config("zamba2-1.2b").reduced(
        n_layers=2, hybrid_attn_every=2, ssd_chunk=64, dtype=torch.bfloat16,
        d_model=256, n_heads=4, n_kv_heads=4)
    api = get_model(cfg)
    model = api.init(torch.Generator(device=dev).manual_seed(0),
                     trainable=True)
    b = SyntheticLM(vocab=cfg.vocab, seq_len=256, global_batch=2).batch(0)
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in b.items()}
    opt = AdamW(lr=1e-3)
    step = make_train_step(api, opt)
    f0, s0 = fa.LAUNCHES, ssd.LAUNCHES
    new0, _, m0 = step(model, opt.init(model), batch)
    plain_launches = (fa.LAUNCHES - f0, ssd.LAUNCHES - s0)
    with local_world("cuda"):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        with sharding_policy(mesh, S.TRAIN_RULES):
            psh = S.param_shardings(mesh, api, S.TRAIN_RULES)
            tree = lm.nest({n: p.detach() for n, p in model.named_parameters()})
            meshed = api.build(S.place_tree(tree, psh), trainable=True)
            bsh = S.batch_shardings(mesh, batch)
            mb = {k: S.place(v, bsh[k]) for k, v in batch.items()}
            f0, s0 = fa.LAUNCHES, ssd.LAUNCHES
            new1, _, m1 = step(meshed, opt.init(meshed), mb)
            torch.cuda.synchronize()
            assert (fa.LAUNCHES - f0, ssd.LAUNCHES - s0) == plain_launches
        assert plain_launches == (2, 4)
        assert abs(float(m1["loss"].full_tensor()) / float(m0["loss"])
                   - 1) <= 1e-6
        for (n, p0), (_, p1) in zip(new0.named_parameters(),
                                    new1.named_parameters()):
            assert torch.allclose(p1.full_tensor(), p0, rtol=1e-6,
                                  atol=1e-7), n


def test_meshed_state_checkpoint_restores_and_replays_on_card(tmp_path):
    """The meshed checkpoint on a 1×1 CUDA mesh (NCCL, one rank), a reduced
    zamba2: the state after step 0 is saved (every DTensor gathered whole),
    restored onto ``param_shardings`` and ``opt_shardings``, and step 1
    replayed from it gives the first run's loss and new state bit for bit;
    ``TrainDriver.reshard_to`` onto the same shardings returns every leaf
    unchanged."""
    from torch.distributed.tensor import DTensor

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import shardings as S
    from repro_torch.launch.mesh import local_world, make_mesh
    from repro_torch.models import lm
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.sharding.policy import sharding_policy
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.driver import DriverConfig, TrainDriver
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import make_train_step

    dev = _cuda()
    cfg = get_config("zamba2-1.2b").reduced(
        n_layers=2, hybrid_attn_every=2, ssd_chunk=64, dtype=torch.bfloat16,
        d_model=256, n_heads=4, n_kv_heads=4)
    api = get_model(cfg)
    model = api.init(torch.Generator(device=dev).manual_seed(0),
                     trainable=True)
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=256, global_batch=2)
    opt = AdamW(lr=1e-3)
    step = make_train_step(api, opt)

    def leaves(params, state):
        out = {n: p for n, p in params.named_parameters()}
        out.update({f"m/{n}": t for n, t in state.m.items()})
        out.update({f"v/{n}": t for n, t in state.v.items()})
        out["step"] = state.step
        return {k: v.full_tensor() for k, v in out.items()}

    with local_world("cuda"):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        with sharding_policy(mesh, S.TRAIN_RULES):
            psh = S.param_shardings(mesh, api, S.TRAIN_RULES)
            osh = S.opt_shardings(mesh, psh)
            tree = lm.nest({n: p.detach() for n, p in model.named_parameters()})
            params = api.build(S.place_tree(tree, psh), trainable=True)
            state = opt.init(params)

            def batch(i):
                b = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                     for k, v in pipe.batch(i).items()}
                bsh = S.batch_shardings(mesh, b)
                return {k: S.place(v, bsh[k]) for k, v in b.items()}
            params, state, _ = step(params, state, batch(0))
            ck = Checkpointer(tmp_path / "ck")
            ck.save(1, {"params": params, "opt": state})
            p1, s1, m1 = step(params, state, batch(1))
            restored, at = ck.restore(
                {"params": params, "opt": state},
                shardings={"params": psh, "opt": osh})
            assert at == 1
            assert all(isinstance(p, DTensor) and p.device_mesh == mesh
                       for p in restored["params"].parameters())
            p1r, s1r, m1r = step(restored["params"], restored["opt"],
                                 batch(1))
            assert float(m1r["loss"].full_tensor()) == float(
                m1["loss"].full_tensor())
            want = leaves(p1, s1)
            for k, v in leaves(p1r, s1r).items():
                assert torch.equal(v, want[k]), k
            drv = TrainDriver(api, opt, pipe, DriverConfig(
                steps=0, ckpt_dir=str(tmp_path / "drv")))
            p2, s2 = drv.reshard_to(p1, s1, psh, osh)
            for k, v in leaves(p2, s2).items():
                assert torch.equal(v, want[k]), k


# ---- real worlds of several cards ------------------------------------------
def _n_cards(n_min: int) -> int:
    _cuda()
    n = torch.cuda.device_count()
    if n < n_min:
        pytest.skip(f"needs {n_min} cards, this machine has {n}")
    return n


def world_rank_against_unmeshed(rank: int) -> dict:
    """One rank of a ``spawn_world`` of one rank per card: a reduced zamba2
    (float32, the kernels on the card) on an (n, 1) mesh (a train step's
    loss and gradients) and a (1, n) mesh (a prefill and two decode
    steps), each against the unmeshed run on this rank's card. Returns the
    worst relative differences and the meshed runs' kernel launches."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.launch import shardings as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.sharding.policy import sharding_policy
    from repro_torch.train.step import make_loss_fn
    import torch.distributed as dist

    n = dist.get_world_size()
    dev = torch.device("cuda", rank)
    cfg = get_config("zamba2-1.2b").reduced(
        n_layers=2, hybrid_attn_every=2, ssd_chunk=64, d_model=256,
        n_heads=4, n_kv_heads=4)
    api = get_model(cfg, device=dev)
    model = api.init(torch.Generator(device=dev).manual_seed(0),
                     trainable=True)
    tree = lm.nest({k: p.detach() for k, p in model.named_parameters()})
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2 * n, 129)), dtype=torch.long, device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_fn = make_loss_fn(api)

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    def step(m, b):
        loss, _ = loss_fn(m, b)
        if isinstance(loss, DTensor):
            loss = loss.redistribute(placements=[Replicate()] * 2)
        return loss, torch.autograd.grad(loss, list(m.parameters()))

    def serve(m, place):
        # a prompt of one SSD chunk
        logits, cache = api.prefill(m, {"tokens": place(toks[:, :64])}, 68)
        out = [whole(logits)]
        for pos in (64, 65):
            logits, cache = api.decode(m, cache, place(torch.full(
                (2 * n, 1), pos, dtype=torch.long, device=dev)), pos)
            out.append(whole(logits))
        return out

    def placed(mesh, rules, trainable):
        return api.build(S.place_tree(tree, S.param_shardings(
            mesh, api, rules)), trainable=trainable)

    def place_on(mesh):
        return lambda t: S.place(t, S.batch_shardings(mesh, {"x": t})["x"])

    loss0, grads0 = step(model, batch)
    want = serve(model, lambda t: t)
    gmax = max(float(g.abs().max()) for g in grads0)
    floor = float(np.finfo(np.float32).eps) * gmax / 1e-4
    fa.LAUNCHES = ssd.LAUNCHES = 0
    mesh = make_mesh((n, 1), ("data", "model"), "cuda")
    with sharding_policy(mesh, S.TRAIN_RULES):
        loss1, grads1 = step(placed(mesh, S.TRAIN_RULES, True),
                             {k: place_on(mesh)(v) for k, v in batch.items()})
        out = {"loss": abs(float(whole(loss1)) / float(loss0.detach()) - 1),
               "grads": max(float((whole(g1) - g0).abs().max())
                            / max(float(g0.abs().max()), floor)
                            for g0, g1 in zip(grads0, grads1))}
    mesh = make_mesh((1, n), ("data", "model"), "cuda")
    with sharding_policy(mesh, S.SERVE_RULES):
        got = serve(placed(mesh, S.SERVE_RULES, False), place_on(mesh))
    out["logits"] = max(float((g - w).abs().max() / w.abs().max())
                        for g, w in zip(got, want))
    out["launches"] = (fa.LAUNCHES, ssd.LAUNCHES)
    return out


def test_spawn_world_on_every_card():
    """``spawn_world`` over NCCL, one rank per card: on every rank an
    (n, 1) train step (loss 1e-5 relative, gradients 1e-4·max|g_leaf|) and
    a (1, n) prefill and two decode steps (1e-5·max|logits|) of a reduced
    zamba2 equal the unmeshed runs on its card, the kernels reached
    through ``local_map``."""
    from repro_torch.launch.mesh import spawn_world

    n = _n_cards(2)
    for r, out in enumerate(spawn_world(n, world_rank_against_unmeshed,
                                        device_type="cuda", timeout_s=600)):
        assert out["loss"] <= 1e-5 and out["grads"] <= 1e-4, (r, out)
        assert out["logits"] <= 1e-5, (r, out)
        assert min(out["launches"]) > 0, (r, out)


@pytest.mark.parametrize("policy", ["tcp", "appaware", "appfair", "fixed"])
def test_all_devices_used(policy):
    """The mirror of ``tests/test_multidevice.py::test_all_devices_used``:
    ``run_campaign(shard=True)`` on four cards streams chunks through
    every card (four streams, at least four chunks, copies timed), and its
    metrics are the one-card campaign's bit for bit; appaware launches the
    waterfill kernel on every card."""
    from repro_torch.streams import FleetRunner, campaign_fleet, compile_fleet

    n = _n_cards(4)
    sims = compile_fleet(campaign_fleet(54, seed=0), device="cpu")
    kw = dict(seconds=8.0, chunk_rows=8)
    if policy == "fixed":
        kw["x_fixed"] = [np.full(s.R.shape[0], 0.25, np.float32)
                         for s in sims]
    if policy == "appaware":
        kw["solver"] = "waterfill"
    runner = FleetRunner(device="cuda")
    one = runner.run_campaign(sims, policy, shard=False, **kw)
    ops.STREAM_LAUNCHES.clear()
    every = runner.run_campaign(sims, policy, shard=True, **kw)
    st = runner.last_stats
    assert st["n_streams"] == n and st["n_chunks"] >= n, st
    assert sorted(st["devices"]) == [f"cuda:{i}" for i in range(n)], st
    assert st["transfer_s"] > 0.0
    np.testing.assert_array_equal(every.metrics, one.metrics)
    if policy == "appaware":
        cards = {key[0] for key in ops.STREAM_LAUNCHES}
        assert len(cards) == n, ops.STREAM_LAUNCHES
