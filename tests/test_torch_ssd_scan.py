"""The port's SSD chunk function and ``ssd_scan`` against the JAX package:
its Pallas chunk kernel (interpret mode on the CPU), its ``ssd_scan`` and
its sequential oracle ``ssd_ref``.

Tolerance 1e-4, the JAX tests' own (tests/test_kernels.py) for the chunked
scan against the sequential recurrence; float32 sums in another order. The
CUDA kernel itself is tested on the card by tests/test_torch_gpu.py and
chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, t32

from repro.kernels.ssd_scan.kernel import ssd_chunk_pallas
from repro.kernels.ssd_scan.ops import ssd_reference, ssd_scan as jax_ssd_scan
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_plain, ssd_ref_plain

SHAPES = [
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 64, 32, 64),
    (2, 64, 3, 16, 8, 64),
    (1, 128, 8, 64, 128, 128),   # mamba2-370m-like head
]


def _inputs(rng, B, S, H, P, N):
    return (rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.5,
            rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32) * 0.5,
            rng.standard_normal((B, S, N)).astype(np.float32) * 0.5)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_chunk_plain_matches_pallas_kernel(B, S, H, P, N, chunk,
                                           monkeypatch):
    """The plain version against the Pallas kernel, and the wrapper's CPU
    dispatch: a spy on ``ssd_chunk_plain`` sees the wrapper call it once
    and return its result unchanged (two separate multi-threaded CPU runs
    need not agree bit for bit)."""
    rng = np.random.default_rng(S + H)
    nc = S // chunk
    x = rng.standard_normal((B * H, nc, chunk, P)).astype(np.float32) * 0.5
    dt = rng.uniform(0.01, 0.2, (B * H, nc, chunk, 1)).astype(np.float32)
    Bm = rng.standard_normal((B, nc, chunk, N)).astype(np.float32) * 0.5
    Cm = rng.standard_normal((B, nc, chunk, N)).astype(np.float32) * 0.5
    A = -rng.uniform(0.5, 2.0, (B * H, 1)).astype(np.float32)
    want = ssd_chunk_pallas(*(jnp.asarray(a) for a in (x, dt, Bm, Cm, A)),
                            interpret=True)
    got = ssd_chunk_plain(*(t32(a) for a in (x, dt, Bm, Cm, A)))
    spied = []

    def spy(*args):
        spied.append(ssd_chunk_plain(*args))
        return spied[-1]
    monkeypatch.setattr(ops, "ssd_chunk_plain", spy)
    wrapped = ops.ssd_chunk(*(t32(a) for a in (x, dt, Bm, Cm, A)))
    assert len(spied) == 1 and wrapped is spied[0]
    for g, w, o in zip(got, want, wrapped):
        assert g.shape == w.shape
        assert_close(g, np.asarray(w), rtol=1e-4, atol=1e-4)
        assert_close(o, np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_scan_matches_jax_scan_and_sequential_reference(B, S, H, P, N,
                                                         chunk):
    args = _inputs(np.random.default_rng(S + H), B, S, H, P, N)
    y, h = ops.ssd_scan(*(t32(a) for a in args), chunk=chunk)
    jy, jh = jax_ssd_scan(*(jnp.asarray(a) for a in args), chunk=chunk)
    ry, rh = ssd_reference(*(jnp.asarray(a) for a in args))
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    for got, want in ((y, jy), (h, jh), (y, ry), (h, rh)):
        assert_close(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    py, ph = ssd_ref_plain(*(t32(a) for a in args))
    assert_close(py, np.asarray(ry), rtol=1e-4, atol=1e-4)
    assert_close(ph, np.asarray(rh), rtol=1e-4, atol=1e-4)


def test_chunk_independence():
    args = [t32(a) for a in _inputs(np.random.default_rng(5), 1, 256, 2, 32,
                                    16)]
    y32, h32 = ops.ssd_scan(*args, chunk=32)
    y128, h128 = ops.ssd_scan(*args, chunk=128)
    assert_close(y32, y128.numpy(), rtol=1e-4, atol=1e-4)
    assert_close(h32, h128.numpy(), rtol=1e-4, atol=1e-4)


def test_large_decay_gives_no_nan():
    """exp(cum_i - cum_j) above the diagonal overflows for a fast decay;
    the masked entries must stay 0, not inf·0 = NaN."""
    x, dt, A, Bm, Cm = (t32(a) for a in _inputs(np.random.default_rng(9),
                                                 1, 128, 2, 16, 8))
    y, h = ops.ssd_scan(x, dt * 400.0, A * 4.0, Bm, Cm, chunk=128)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())


def test_cpu_path_never_counts_launches():
    args = [t32(a) for a in _inputs(np.random.default_rng(0), 1, 64, 2, 16,
                                    8)]
    before = ops.LAUNCHES
    ops.ssd_scan(*args, chunk=32)
    assert ops.LAUNCHES == before


def test_scan_rejects_indivisible_chunk():
    args = [t32(a) for a in _inputs(np.random.default_rng(0), 1, 96, 2, 16,
                                    8)]
    with pytest.raises(ValueError, match="not divisible"):
        ops.ssd_scan(*args, chunk=64)


@pytest.mark.parametrize("case,exc,match", [
    ("f64", TypeError, "float32"),
    ("dt", ValueError, "dt must be"),
    ("A", ValueError, "A must be"),
    ("bc", ValueError, "B and C"),
    ("bsz", ValueError, "multiple of Bsz"),
    ("big", ValueError, "exceed"),
    ("strided", ValueError, "contiguous"),
    ("meta", ValueError, "is on"),
])
def test_chunk_wrapper_rejects_bad_inputs(case, exc, match):
    BH, nc, Q, P, N = 4, 2, 16, 8, 4
    x = torch.randn(BH, nc, Q, P)
    dt = torch.rand(BH, nc, Q, 1)
    Bm, Cm = torch.randn(2, nc, Q, N), torch.randn(2, nc, Q, N)
    A = -torch.rand(BH, 1)
    if case == "f64":
        x = x.double()
    elif case == "dt":
        dt = dt[..., 0]
    elif case == "A":
        A = A[:, 0]
    elif case == "bc":
        Cm = torch.randn(2, nc, Q, N + 1)
    elif case == "bsz":
        Bm, Cm = torch.randn(3, nc, Q, N), torch.randn(3, nc, Q, N)
    elif case == "big":
        x = torch.randn(BH, nc, Q, 65)
    elif case == "strided":
        x = torch.randn(BH, nc, P, Q).transpose(2, 3)
    elif case == "meta":
        # meta tensors are a shape function's input, checked all the same
        x = x.to("meta")
    with pytest.raises(exc, match=match):
        ops.ssd_chunk(x, dt, Bm, Cm, A)
