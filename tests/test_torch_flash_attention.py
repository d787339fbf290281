"""The port's flash-attention wrapper and plain version against the JAX
package's Pallas kernel (interpret mode on the CPU, as its own tests run
it) and its oracle ``attention_ref``.

Tolerances are the JAX tests' own (tests/test_kernels.py): 2e-5 in
float32 and 2e-2 in bfloat16. The CUDA kernel itself is tested on the card
by tests/test_torch_gpu.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, t32

from repro.kernels.flash_attention.ops import (
    flash_attention as jax_flash,
    flash_attention_reference,
)
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_plain


def _qkv(rng, B, S, T, H, K, hd):
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32))


@pytest.mark.parametrize("B,S,T,H,K,hd", [
    (2, 128, 128, 4, 2, 64),
    (1, 256, 256, 8, 8, 32),
    (1, 128, 128, 6, 3, 64),     # non-pow2 head count
    (2, 64, 64, 4, 1, 128),      # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_kernel_and_reference(B, S, T, H, K, hd, causal):
    q, k, v = _qkv(np.random.default_rng(S * H), B, S, T, H, K, hd)
    got = ops.flash_attention(t32(q), t32(k), t32(v), causal=causal)
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, block_q=64, block_k=64)
    ref = flash_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    assert got.shape == (B, S, H, hd) and got.dtype == torch.float32
    assert_close(got, np.asarray(pallas), rtol=2e-5, atol=2e-5)
    assert_close(got, np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_bfloat16_matches_jax_reference():
    q, k, v = _qkv(np.random.default_rng(1), 1, 128, 128, 4, 2, 64)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv)
    # both sides see the same bf16-rounded inputs
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (tq, tk, tv))
    ref = flash_attention_reference(jq, jk, jv)
    assert got.dtype == torch.bfloat16
    assert_close(got.float(), np.asarray(ref, np.float32), rtol=2e-2,
                 atol=2e-2)


@pytest.mark.parametrize("S,T", [(300, 300), (37, 37), (100, 160)])
def test_ragged_lengths_match_attention_ref(S, T):
    """S and T need not be multiples of a tile (the Pallas kernel asserts
    they are); held against the oracle in the kernel's [B,H,S,hd] layout."""
    rng = np.random.default_rng(S + T)
    q = rng.standard_normal((2, 8, S, 64)).astype(np.float32)
    k = rng.standard_normal((2, 2, T, 64)).astype(np.float32)
    v = rng.standard_normal((2, 2, T, 64)).astype(np.float32)
    for causal in (True, False):
        got = attention_plain(t32(q), t32(k), t32(v), causal)
        ref = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal)
        assert_close(got, np.asarray(ref), rtol=2e-5, atol=2e-5)
        wrapped = ops.flash_attention(
            t32(q).transpose(1, 2).contiguous(),
            t32(k).transpose(1, 2).contiguous(),
            t32(v).transpose(1, 2).contiguous(), causal)
        assert_close(wrapped.transpose(1, 2), np.asarray(ref), rtol=2e-5,
                     atol=2e-5)


def test_cpu_path_never_counts_launches():
    q = torch.randn(1, 8, 2, 16)
    before = ops.LAUNCHES
    ops.flash_attention(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous())
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("case,exc,match", [
    ("half", TypeError, "float32 or bfloat16"),
    ("mixed", TypeError, "q is"),
    ("3d", ValueError, "4-D"),
    ("heads", ValueError, "multiple"),
    ("hd", ValueError, "head_dim"),
    ("kv", ValueError, "differ"),
    ("strided", ValueError, "contiguous"),
    ("meta", ValueError, "cpu or cuda"),
    ("notensor", TypeError, "torch.Tensor"),
])
def test_wrapper_rejects_bad_inputs(case, exc, match):
    q = torch.randn(1, 8, 4, 16)
    k = torch.randn(1, 8, 2, 16)
    v = torch.randn(1, 8, 2, 16)
    if case == "half":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed":
        k = k.to(torch.bfloat16)
    elif case == "3d":
        q = q[0]
    elif case == "heads":
        k, v = torch.randn(1, 8, 3, 16), torch.randn(1, 8, 3, 16)
    elif case == "hd":
        q, k, v = (torch.randn(*t.shape[:3], 24) for t in (q, k, v))
    elif case == "kv":
        v = torch.randn(1, 7, 2, 16)
    elif case == "strided":
        q = torch.randn(1, 4, 8, 16).transpose(1, 2)
    elif case == "meta":
        q, k, v = (t.to("meta") for t in (q, k, v))
    elif case == "notensor":
        q = q.numpy()
    with pytest.raises(exc, match=match):
        ops.flash_attention(q, k, v)


def test_wrapper_rejects_mixed_devices():
    q = torch.randn(1, 8, 4, 16)
    k = torch.randn(1, 8, 2, 16).to("meta")
    with pytest.raises(ValueError, match="is on"):
        ops.flash_attention(q, k, k)
