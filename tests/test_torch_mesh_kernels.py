"""The kernels' wrappers on DTensors and on meta tensors, with real values
on the CPU.

In a dry world (the ``"fake"`` backend, one process playing any rank) a
rank whose inputs are replicated DTensors, split by ``shard_as`` as the
model's call sites split them, cuts its shard locally, with no
collective, so its local output is exact; it must equal that shard of the
unsharded result, for every rank. The gradients of replicated inputs that
a rank reads only in part (flash's KV heads when the query heads are
sharded and the KV heads are not; SSD's B and C) are partial sums: the
fake all-reduce leaves each rank its own, and the ranks' sum must equal
the unsharded gradient. ``moe_ffn`` on a (4, 1) mesh runs one token group
per rank. On meta tensors each wrapper is a shape function.

Each dry world is opened by a context manager that destroys it, so that
no default process group leaks into the next test file an xdist worker
runs."""
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.waterfill import ops as wops
from repro_torch.launch.mesh import dry_world, make_mesh
from repro_torch.models import blocks as B
from repro_torch.sharding import policy as pol


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replicated(t, mesh):
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _leaf(t, mesh):
    """A replicated DTensor leaf holding a copy of ``t``: its gradient
    keeps the placements the backward gives it (a partial sum stays
    partial, which the dry world's all-reduce would hide)."""
    return _replicated(t.clone(), mesh).requires_grad_()


def _flash_inputs(H, K, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(2, 16, H, 16, generator=g)
    k = torch.randn(2, 16, K, 16, generator=g)
    v = torch.randn(2, 16, K, 16, generator=g)
    return q, k, v


@pytest.mark.parametrize("H,K,kv_split", [(8, 2, True), (8, 4, True),
                                          (8, 8, True), (8, 4, False)])
def test_flash_on_mesh_gives_each_rank_its_heads(H, K, kv_split):
    """(1, 4) mesh: query heads split 4 ways at the call site; KV heads
    split with them where the caller splits them (``kv_split``: as
    ``blocks.attention`` does, on "kv_heads", which replicates them where 4
    does not divide K), else whole on every rank and selected per rank;
    outputs exact, KV gradients summing to the unsharded ones over the
    ranks."""
    q, k, v = _flash_inputs(H, K)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    full = fops.flash_attention(*leaves, causal=True)
    up = torch.randn(full.shape, generator=torch.Generator().manual_seed(1))
    (full * up).sum().backward()
    gk = torch.zeros_like(k)
    gv = torch.zeros_like(v)
    kv_axes = ("batch", "seq", "kv_heads" if kv_split else None, None)
    for rank in range(4):
        with dry_world(4, rank=rank):
            mesh = make_mesh((1, 4), ("data", "model"), "cpu")
            with pol.sharding_policy(mesh):
                ql, kl, vl = (_leaf(t, mesh) for t in (q, k, v))
                qd = pol.shard_as(ql, "batch", "seq", "heads", None)
                kd, vd = (pol.shard_as(t, *kv_axes) for t in (kl, vl))
                out = fops.flash_attention(qd, kd, vd, causal=True)
                assert isinstance(out, DTensor)
                hs = slice(rank * H // 4, (rank + 1) * H // 4)
                assert torch.allclose(out.to_local(), full[:, :, hs].detach(),
                                      rtol=1e-6, atol=1e-6)
                (out.to_local() * up[:, :, hs]).sum().backward()
        assert torch.allclose(ql.grad.to_local()[:, :, hs],
                              leaves[0].grad[:, :, hs], rtol=1e-5, atol=1e-6)
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
    assert torch.allclose(gk, leaves[1].grad, rtol=1e-5, atol=1e-5)
    assert torch.allclose(gv, leaves[2].grad, rtol=1e-5, atol=1e-5)


def test_ssd_scan_on_mesh_splits_the_heads():
    """x split by heads 4 ways at the call site (``shard_as`` on "inner",
    as ``mamba2_forward`` does), dt and A following it, B and C whole on
    every rank: each rank's y and final state are exact, and its B and C
    gradients are partial sums over the ranks."""
    g = torch.Generator().manual_seed(0)
    Bsz, L, H, P, N = 2, 32, 8, 16, 8
    x = torch.randn(Bsz, L, H, P, generator=g) * 0.5
    dt = torch.rand(Bsz, L, H, generator=g) * 0.2 + 0.01
    A = -(torch.rand(H, generator=g) * 1.5 + 0.5)
    Bm = torch.randn(Bsz, L, N, generator=g) * 0.5
    Cm = torch.randn(Bsz, L, N, generator=g) * 0.5
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, h = sops.ssd_scan(*leaves, chunk=16)
    up = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    (y * up).sum().backward()
    gb, gc = torch.zeros_like(Bm), torch.zeros_like(Cm)
    for rank in range(4):
        with dry_world(4, rank=rank):
            mesh = make_mesh((1, 4), ("data", "model"), "cpu")
            with pol.sharding_policy(mesh):
                loc = [_leaf(t, mesh) for t in (x, dt, A, Bm, Cm)]
                xd = pol.shard_as(loc[0], "batch", "seq", "inner", None)
                yl, hl = sops.ssd_scan(xd, *loc[1:], chunk=16)
                hs = slice(rank * 2, rank * 2 + 2)
                assert torch.allclose(yl.to_local(), y[:, :, hs].detach(),
                                      rtol=1e-5, atol=1e-6)
                assert torch.allclose(hl.to_local(), h[:, hs].detach(),
                                      rtol=1e-5, atol=1e-6)
                (yl.to_local() * up[:, :, hs]).sum().backward()
        assert torch.allclose(loc[0].grad.to_local()[:, :, hs],
                              leaves[0].grad[:, :, hs], rtol=1e-4, atol=1e-5)
        for t in loc[3:]:
            assert tuple(t.grad.placements) == (Replicate(), Partial())
        gb += loc[3].grad.to_local()
        gc += loc[4].grad.to_local()
    assert torch.allclose(gb, leaves[3].grad, rtol=1e-4, atol=1e-4)
    assert torch.allclose(gc, leaves[4].grad, rtol=1e-4, atol=1e-4)


def test_moe_ffn_on_mesh_runs_each_rank_its_group(monkeypatch):
    """A (4, 1) mesh with the weights replicated: G = 4 token groups, one
    per rank; each rank's output is its group's rows of the unmeshed
    four-group result."""
    rng = np.random.default_rng(0)
    Bt, St, D, F, E, K = 4, 8, 16, 8, 4, 2
    p = {k: torch.tensor(rng.standard_normal(s.shape).astype(np.float32)
                         * 0.3) for k, s in B.moe_specs(D, F, E).items()}
    x = torch.tensor(rng.standard_normal((Bt, St, D)).astype(np.float32))
    with monkeypatch.context() as m:
        m.setattr(B, "shard_count", lambda name: 4)
        want, _ = B.moe_ffn(p, x, E, K, 0.5)
    for rank in range(4):
        with dry_world(4, rank=rank):
            mesh = make_mesh((4, 1), ("data", "model"), "cpu")
            with pol.sharding_policy(mesh, {"embed": None}):
                assert pol.shard_count("batch") == 4
                out, _ = B.moe_ffn(p, x, E, K, 0.5)
                assert torch.allclose(out.to_local(), want[rank:rank + 1],
                                      rtol=1e-5, atol=1e-6)


def test_wrappers_on_meta_are_shape_functions():
    """Empty outputs of the kernels' shapes and dtypes; no launch."""
    counts = (fops.LAUNCHES, sops.LAUNCHES, wops.LAUNCHES)
    q = torch.empty(2, 64, 8, 32, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 48, 2, 32, dtype=torch.bfloat16, device="meta")
    o = fops.flash_attention(q, kv, kv, causal=False)
    assert o.is_meta and o.shape == q.shape and o.dtype == torch.bfloat16
    BH, nc, Q, P, N = 8, 4, 16, 16, 8
    meta = dict(dtype=torch.float32, device="meta")
    y, st, cum = sops.ssd_chunk(
        torch.empty(BH, nc, Q, P, **meta), torch.empty(BH, nc, Q, 1, **meta),
        torch.empty(2, nc, Q, N, **meta), torch.empty(2, nc, Q, N, **meta),
        torch.empty(BH, 1, **meta))
    assert [tuple(t.shape) for t in (y, st, cum)] == [
        (BH, nc, Q, P), (BH, nc, P, N), (BH, nc, Q, 1)]
    assert all(t.is_meta for t in (y, st, cum))
    L, Fl = 5, 7
    r = wops.waterfill_flows(*(torch.empty(Fl, **meta) for _ in range(3)),
                             torch.empty(L, Fl, **meta),
                             torch.empty(L, **meta),
                             torch.empty(L, dtype=torch.int32,
                                         device="meta"))
    assert r.is_meta and tuple(r.shape) == (L, Fl)
    assert (fops.LAUNCHES, sops.LAUNCHES, wops.LAUNCHES) == counts
