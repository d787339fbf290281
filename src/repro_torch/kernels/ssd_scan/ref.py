"""Plain PyTorch versions of the Mamba2/SSD core.

* :func:`ssd_chunk_plain` — the per-chunk function of the CUDA kernel (and
  of the JAX package's Pallas ``ssd_chunk_pallas``), batched over every
  (batch·head, chunk): the intra-chunk quadratic form, the chunk's state
  contribution and the cumulative log-decay. The wrapper (``ops.py``) runs
  it for CPU tensors; on the card it is the yardstick the kernel is held
  to.
* :func:`ssd_ref_plain` — the sequential oracle, the counterpart of the
  JAX package's ``ssd_ref``:

      h_t = exp(dt_t · A) ⊙ h_{t-1} + dt_t · (B_t ⊗ x_t)
      y_t = C_t · h_t

All float32.
"""
from __future__ import annotations

import torch


def ssd_chunk_plain(x, dt, B, C, A):
    """x: [BH,nc,Q,P]; dt: [BH,nc,Q,1]; B, C: [Bsz,nc,Q,N], shared by the
    H = BH / Bsz heads of a batch row; A: [BH,1].

    Returns (y_intra [BH,nc,Q,P], states [BH,nc,P,N], cum [BH,nc,Q,1])."""
    BH, nc, Q, _ = x.shape
    H = BH // B.shape[0]
    Bm = B.repeat_interleave(H, dim=0)            # row bh is B[bh // H]
    Cm = C.repeat_interleave(H, dim=0)
    d = dt[..., 0]                                # [BH,nc,Q]
    cum = torch.cumsum(d * A[:, :, None], dim=-1)
    seg = cum[..., :, None] - cum[..., None, :]   # [BH,nc,Q,Q]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    # exp only where j <= i: above the diagonal seg > 0 can overflow
    Lmat = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    G = Cm @ Bm.transpose(-1, -2)                 # [BH,nc,Q,Q]
    M = G * Lmat * d[..., None, :]
    y = M @ x
    decay_end = torch.exp(cum[..., -1:] - cum)    # [BH,nc,Q]
    wB = Bm * (d * decay_end)[..., None]
    st = x.transpose(-1, -2) @ wB                 # [BH,nc,P,N]
    return y, st, cum[..., None]


def ssd_ref_plain(x, dt, A, B, C):
    """x [B,S,H,P], dt [B,S,H] (post-softplus), A [H] (negative), B/C
    [B,S,N]. Returns y [B,S,H,P] and the final state [B,H,P,N]."""
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    h = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A[None, :])              # [B,H]
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, t], B[:, t], x[:, t])
        h = h * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t], h))
    return torch.stack(ys, dim=1), h
