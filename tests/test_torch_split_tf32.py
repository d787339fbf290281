"""The split-TF32 arithmetic of the port's float32 kernels (the SSD chunk
kernel and the float32 flash-attention kernel, ``kernels/wgmma.cuh``),
emulated on the CPU: no card needed.

Each float32 operand a is split into hi = tf32(a) and lo = tf32(a - hi),
tf32 being ``cvt.rna.tf32.f32`` (10 mantissa bits, round to nearest, ties
away from zero), and a product is taken as lo·hi + hi·lo + hi·hi in float32.
tf32 values have 11 significant bits, so every single product of two is
exact in float32 and a float32 matmul of tf32-valued tensors reproduces
what the tensor cores sum, up to summation order.
"""
import numpy as np
import pytest
import torch


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on finite float32 values: add half a tf32 ulp to the
    magnitude and clear the 13 low bits (the carry moves into the exponent
    where it must; the sign bit is never reached)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm_split(a, b):
    """The kernels' product: the two small terms first, one accumulator."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a, b):
    """One tf32 product, what a plain TF32 tensor-core kernel would do."""
    return rna_tf32(a) @ rna_tf32(b)


def mm_f64(a, b):
    return a @ b


def _rand(rng, shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale,
                        dtype=torch.float32)


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2**-11, 1.0 + 2**-10),            # a tie goes away from zero
    (1.0 + 3 * 2**-11, 1.0 + 2 * 2**-10),
    (-(1.0 + 2**-11), -(1.0 + 2**-10)),
    (1.0 + 2**-12, 1.0),                     # below half an ulp: down
    (2.0 - 2**-12, 2.0),                     # the carry reaches the exponent
    (3.0, 3.0),
])
def test_rna_tf32_rounds_to_nearest_ties_away(x, want):
    got = rna_tf32(torch.tensor([x], dtype=torch.float32))
    assert float(got) == want
    assert int(got.view(torch.int32)) & 0x1FFF == 0


def test_split_recovers_float32_to_2_pow_minus_22():
    """hi + lo is a within 2^-22·|a| (lo's own rounding), and lo is at most
    half a tf32 ulp of a: 2^-11·|a|."""
    a = _rand(np.random.default_rng(0), (4096,), 100.0)
    hi, lo = split(a)
    for t in (hi, lo):
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    rel = ((hi.double() + lo.double() - a.double()).abs() / a.double().abs())
    assert float(rel.max()) <= 2.0**-22
    assert float((lo.abs() / a.abs()).max()) <= 2.0**-11


# The shapes of the kernels' products, at the serving widths: SSD C·Bᵀ
# [Q, N]·[N, Q], M·x [Q, Q]·[Q, P], xᵀ·(B∘w) [P, Q]·[Q, N]; flash Q·Kᵀ
# [64, hd]·[hd, 64] and P·V [64, 64]·[64, hd].
PRODUCT_SHAPES = [(128, 64, 128), (128, 128, 128), (128, 128, 64),
                  (64, 128, 64), (64, 128, 128), (64, 16, 64), (64, 64, 16)]


@pytest.mark.parametrize("M,K,N", PRODUCT_SHAPES)
def test_split_product_is_float32_accurate(M, K, N):
    """Against a float64 product, relative to Σ|a||b|: the split is within
    1e-6 (it drops lo·lo and lo's rounding, ~3·2^-22 ≈ 7e-7 at worst, and
    sums in float32 like a float32 product; measured ~2e-7, as a float32
    matmul), while one tf32 product misses the 1e-5 relative mark the
    7-layer card-vs-CPU check holds a float32 model to (chip_smoke.py):
    its operands carry 2^-11 each."""
    rng = np.random.default_rng(M * K + N)
    a, b = _rand(rng, (M, K)), _rand(rng, (K, N))
    ref = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()

    def rel(c):
        return float(((c.double() - ref).abs() / scale).max())
    assert rel(mm_split(a, b)) <= 1e-6
    assert rel(mm_tf32(a, b)) > 1e-5


def _attention(q, k, v, mm, causal=True):
    S, T = q.shape[-2], k.shape[-2]
    s = mm(q, k.transpose(-1, -2)) / q.shape[-1] ** 0.5
    if causal:
        keep = torch.ones(S, T, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return mm(torch.softmax(s, -1), v)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_split_attention_meets_the_f32_tolerance(hd, causal):
    """Attention with both products split, against float64: within 2e-5,
    the float32 flash kernel's tolerance (measured ~1e-6, as float32
    products give); with one tf32 product each, outside it (~1e-3)."""
    rng = np.random.default_rng(hd)
    q, k, v = (_rand(rng, (4, 128, hd)) for _ in range(3))
    ref = _attention(q.double(), k.double(), v.double(), mm_f64, causal)
    err = float((_attention(q, k, v, mm_split, causal).double() - ref)
                .abs().max())
    assert err <= 2e-5
    err1 = float((_attention(q, k, v, mm_tf32, causal).double() - ref)
                 .abs().max())
    assert err1 > 2e-5


def _ssd_chunk(x, dt, B, C, A, mm):
    """ref.py::ssd_chunk_plain's arithmetic (one batch row per head), with
    its three products taken by ``mm``."""
    d = dt[..., 0]
    cum = torch.cumsum(d * A[:, :, None], -1)
    Q = x.shape[-2]
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    seg = cum[..., :, None] - cum[..., None, :]
    L = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    M = mm(C, B.transpose(-1, -2)) * L * d[..., None, :]
    w = d * torch.exp(cum[..., -1:] - cum)
    return mm(M, x), mm(x.transpose(-1, -2), B * w[..., None])


@pytest.mark.parametrize("Q,P,N", [(128, 64, 64), (128, 64, 128),
                                   (100, 64, 64), (128, 16, 8)])
def test_split_ssd_chunk_meets_its_tolerance(Q, P, N):
    """The SSD chunk with its three products split, against float64: within
    1e-4, the chunk kernel's tolerance (measured ~1e-6, as float32); with
    one tf32 product each, y misses it (~1e-3 on values up to ~2)."""
    rng = np.random.default_rng(Q + N)
    BH = 4
    x = _rand(rng, (BH, 1, Q, P), 0.5)
    dt = torch.tensor(rng.uniform(0.01, 0.2, (BH, 1, Q, 1)),
                      dtype=torch.float32)
    B, C = _rand(rng, (BH, 1, Q, N), 0.5), _rand(rng, (BH, 1, Q, N), 0.5)
    A = torch.tensor(-rng.uniform(0.5, 2.0, (BH, 1)), dtype=torch.float32)
    ref = _ssd_chunk(*(t.double() for t in (x, dt, B, C, A)), mm_f64)
    for got, want in zip(_ssd_chunk(x, dt, B, C, A, mm_split), ref):
        assert float((got.double() - want).abs().max()) <= 1e-4
    y1, _ = _ssd_chunk(x, dt, B, C, A, mm_tf32)
    assert float((y1.double() - ref[0]).abs().max()) > 1e-4


# ---- an accumulator becomes an A operand (wgmma.cuh) ------------------------
SLOT_COL = [0, 2, 4, 6, 1, 3, 5, 7]          # A slot s holds true column


def slot_of(k: int) -> int:
    """The slot of true row k of a k8 block in the B operand."""
    return (k >> 1) + 4 * (k & 1)


@pytest.mark.parametrize("j", [0, 3, 7])
def test_accumulator_columns_permuted_into_a_fragments(j):
    """One warp's 16 rows of an m64nN accumulator D. Thread (lane) holds
    d[4j + e] at (g, 8j + 2c + e) and d[4j + 2 + e] at (g + 8, ...), with
    g = lane / 4, c = lane % 4; the tf32 A fragment of k8 block j puts
    a[0..3] at (g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4). Passing
    a = {d[4j], d[4j+2], d[4j+1], d[4j+3]} gives A slot s the true column
    SLOT_COL[s], and a B operand that stores true row k at slot_of(k) makes
    A·B' equal D·B over the block."""
    rng = np.random.default_rng(j)
    D = rng.standard_normal((16, 64))
    A = np.zeros((16, 8))
    for lane in range(32):
        g, c = lane // 4, lane % 4
        d = {}
        for e in range(2):
            d[4 * j + e] = D[g, 8 * j + 2 * c + e]
            d[4 * j + 2 + e] = D[g + 8, 8 * j + 2 * c + e]
        a = [d[4 * j], d[4 * j + 2], d[4 * j + 1], d[4 * j + 3]]
        for (row, col), val in zip(((g, c), (g + 8, c), (g, c + 4),
                                    (g + 8, c + 4)), a):
            A[row, col] = val
    for s in range(8):
        np.testing.assert_array_equal(A[:, s], D[:, 8 * j + SLOT_COL[s]])
        assert slot_of(SLOT_COL[s]) == s
    Bm = rng.standard_normal((8, 5))          # the block's 8 rows of B
    Bp = np.zeros_like(Bm)
    for k in range(8):
        Bp[slot_of(k)] = Bm[k]
    np.testing.assert_allclose(A @ Bp, D[:, 8 * j:8 * j + 8] @ Bm,
                               rtol=1e-12, atol=1e-12)
