"""The port's dry run (``repro_torch.launch.dryrun``), its roofline, and the
kernels' FLOPs on meta:

* the mirror of ``tests/test_distribution.py::test_dryrun_lite_8dev``
  through the port's ``run_cell``: the reference's three archs, reduced as
  there and cut to 2 layers (an eager trace runs every layer, where XLA
  compiles one scanned body), on a dry (2, 4) "cpu" mesh, into
  ``tmp_path``;
* the flash and SSD wrappers' meta calls count their plain versions' FLOPs:
  a reduced train trace gives exactly the FLOPs of the same trace with the
  plain versions run on meta;
* ``cell_terms`` and ``memory_floor_s`` against ``repro.launch.roofline``'s
  on the same synthetic records, with the port's constants set to v5e's
  and every mesh axis at the reference's one link rate;
* the mirror of ``tests/test_scheduler.py::TestDryrunArtifacts`` over
  ``results/dryrun_torch/``, each peak held to the H100's 80 GB; it skips
  where no sweep has written there;
* the repairs of the MoE and vlm train cells on a mesh: a reduced
  qwen3-moe or dbrx train step on a dry (2, 4) mesh allocates nothing at
  the MoE's lines larger than the rank's own dispatch shard (its groups,
  its experts) and gathers no gradient for the global norm; dbrx's FLOPs
  per rank on a (2, 2, 4) ("pod", "data", "model") mesh are half those on
  (2, 4); internvl2's vision prefix is concatenated and sliced off with
  no collective; and the MoE's restructured dispatch computes the same
  bits as the formulation it replaced, its expert slices summing to the
  whole.

Every dry world is opened by ``run_cell`` or a fixture, and destroyed."""
import functools
import json
import math
import pathlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.launch import mesh as jmesh
from repro.launch import roofline as jroof
from repro_torch.core import scheduler
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_plain
from repro_torch.launch import comm_stats, dryrun, dryrun_report, roofline
from repro_torch.launch.mesh import HBM_CAPACITY, dry_world, make_mesh
from repro_torch.models import blocks as B
from repro_torch.models.registry import ShapeSpec, get_config, get_model

RESULTS = dryrun.RESULTS


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def lite_mesh():
    """A (2, 4) "cpu" mesh of a dry world of 8 ranks."""
    with dry_world(8):
        yield make_mesh((2, 4), ("data", "model"), "cpu")


def _lite(arch):
    return get_config(arch).reduced(**dryrun.LITE, n_layers=2)


TRAIN = ShapeSpec("t", 256, 8, "train")


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "dbrx-132b", "mamba2-370m"])
def test_dryrun_lite_8dev(arch, tmp_path, capsys):
    cfg = _lite(arch)
    train = dryrun.run_cell(arch, TRAIN, "lite_2x4",
                            device_type="cpu", cfg=cfg, tag="reduced",
                            results=tmp_path)
    decode = dryrun.run_cell(arch, ShapeSpec("d", 64, 8, "decode"),
                             "lite_2x4", device_type="cpu", cfg=cfg,
                             tag="reduced", results=tmp_path)
    assert train["ok"], train.get("traceback")
    assert train["collectives"]["count"] > 0, "SPMD produced no collectives?"
    assert train["flops"] > 0
    assert decode["ok"], decode.get("traceback")
    assert {k.split("/")[1] for k in train["collectives_by_axis"]} == {
        "data", "model"}
    assert train["call_sites"] and train["memory"]["peak_memory_in_bytes"] \
        >= train["memory"]["argument_size_in_bytes"] > 0
    assert train["depth_traced"] == cfg.n_layers
    # cached: an ok record is read back, not traced again
    again = dryrun.run_cell(arch, TRAIN, "lite_2x4",
                            device_type="cpu", cfg=cfg, tag="reduced",
                            results=tmp_path)
    assert again == json.loads(json.dumps(train))
    # the report and the roofline read the records
    dryrun_report.main(["--results", str(tmp_path)])
    roofline.main(["--results", str(tmp_path), "--mesh", "all"])
    out = capsys.readouterr().out
    assert "2 cells traced, 0 failed" in out and '"cpu" meshes' in out
    assert out.count(f"| {arch} | t | lite_2x4 |") == 2


def _plain_on_meta(monkeypatch):
    """The wrappers' meta branches replaced by their plain versions."""
    flash, ssd = fops._forward, sops._forward

    def flash_plain(q, k, v, causal):
        return fops._plain(q, k, v, causal) if q.is_meta else flash(
            q, k, v, causal)

    def ssd_plain(x, dt, B, C, A):
        return ssd_chunk_plain(x, dt, B, C, A) if x.is_meta else ssd(
            x, dt, B, C, A)
    monkeypatch.setattr(fops, "_forward", flash_plain)
    monkeypatch.setattr(sops, "_forward", ssd_plain)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-370m"])
def test_meta_kernels_count_their_plain_flops(arch, lite_mesh, monkeypatch):
    # the mirror's cells, whose sharding propagation DTensor has cached
    api = get_model(_lite(arch), device="cpu")
    spec = TRAIN
    recs, flops = comm_stats.trace_train_step(api, lite_mesh, spec)
    assert recs.kernel_flops > 0
    _plain_on_meta(monkeypatch)
    recs_plain, flops_plain = comm_stats.trace_train_step(api, lite_mesh,
                                                          spec)
    assert recs_plain.kernel_flops == 0
    assert flops == flops_plain
    assert comm_stats.collective_stats(recs) == comm_stats.collective_stats(
        recs_plain)


@pytest.mark.parametrize("shape", [(2, 8, 2, 16, 16, 8), (1, 4, 4, 5, 7, 16),
                                   (2, 4, 2, 3, 1, 8), (2, 8, 8, 3, 3, 1)])
def test_flash_plain_flops_formula(shape):
    """``plain_flops`` equals the flop counter on the plain version, the
    edge cases of size-1 contractions too."""
    from torch.utils.flop_counter import FlopCounterMode

    B, H, K, S, T, hd = shape
    q = torch.empty(B, S, H, hd, device="meta")
    k = torch.empty(B, T, K, hd, device="meta")
    with FlopCounterMode(display=False) as fc:
        fops._plain(q, k, k, True)
    assert fops.plain_flops(q.shape, k.shape) == fc.get_total_flops()


def _synthetic(arch, kind, mesh, seq, batch, flops, nbytes, coll):
    """A dry-run record with the keys both rooflines read."""
    cfg = get_config(arch)
    api = get_model(cfg, device="cpu")
    axes = ["pod", "data", "model"] if mesh.startswith("multi") else [
        "data", "model"]
    chips = 512 if mesh.startswith("multi") else 256
    kinds = {"all-gather": coll[0], "reduce-scatter": coll[1],
             "all-reduce": coll[2]}
    by_axis = {f"{k}/{a}": [1, b / len(axes)] for k, b in kinds.items()
               for a in axes}
    return {"arch": arch, "kind": kind, "mesh": mesh, "n_chips": chips,
            "seq_len": seq, "global_batch": batch,
            "params": api.count_params(), "active_params": api.active_params(),
            "flops": flops, "bytes_accessed": nbytes,
            "collectives": dict(kinds, total=sum(coll)),
            "collectives_by_axis": by_axis}


@pytest.mark.parametrize("rec", [
    ("yi-6b", "train", "pod_16x16", 4096, 256, 3.1e14, 2.2e12,
     (4e10, 3e10, 1e9)),
    ("qwen3-moe-235b-a22b", "train", "multipod_2x16x16", 4096, 256, 9e14,
     7e12, (2e11, 1e11, 5e9)),
    ("mamba2-370m", "decode", "multipod_2x16x16", 524288, 1, 2e9, 4e9,
     (1e6, 0, 3e6)),
    ("whisper-tiny", "prefill", "pod_16x16", 32768, 32, 4e12, 9e11,
     (1e8, 2e8, 0)),
    ("zamba2-1.2b", "decode", "pod_16x16", 32768, 128, 1e11, 3e10,
     (0, 0, 0)),
])
def test_cell_terms_match_the_reference(rec, monkeypatch):
    r = _synthetic(*rec)
    monkeypatch.setattr(roofline, "PEAK_FLOPS_BF16", jmesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(roofline, "HBM_BW", jmesh.HBM_BW)
    monkeypatch.setattr(scheduler, "_AXIS_BW_GBPS", {
        a: jmesh.ICI_BW / 1e9 for a in ("pod", "data", "model")})
    want, got = jroof.cell_terms(r), roofline.cell_terms(r)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v, k
        else:
            assert math.isclose(got[k], v, rel_tol=1e-12, abs_tol=0.0), k
    assert math.isclose(roofline.memory_floor_s(r), jroof.memory_floor_s(r),
                        rel_tol=1e-12)
    assert roofline.improvement_note(r, got).replace(
        "tensor-core utilisation", "MXU util") == jroof.improvement_note(
        r, want)


def test_collective_term_uses_each_axis_rate():
    r = _synthetic("yi-6b", "train", "multipod_2x16x16", 4096, 256, 1e14,
                   1e12, (3e10, 0, 0))
    rates = scheduler._AXIS_BW_GBPS
    want = sum(1e10 / (rates[a] * 1e9) for a in ("pod", "data", "model"))
    assert math.isclose(roofline.collective_s(r), want, rel_tol=1e-12)


class _Allocations(TorchDispatchMode):
    """The bytes of every local tensor an op allocates (no views), by the
    call site ``comm_stats`` names."""

    def __init__(self):
        super().__init__()
        self.by_site: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            site = comm_stats._site()
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_meta:
                    n = t.numel() * t.element_size()
                    self.by_site[site] = max(self.by_site.get(site, 0), n)
        return out


# the MoE cells: the real experts and top-k of dbrx, qwen3-moe's top-8 over
# 16 experts (4 a rank on the model axis of 4)
MOE_CUTS = {"qwen3-moe-235b-a22b": dict(n_experts=16, top_k=8),
            "dbrx-132b": dict(n_experts=16, top_k=4)}


class _GradientsAsUpdates:
    """An optimizer whose update is the gradients as they are. The flop
    counter counts products only, so a step with it traces the FLOPs of one
    with AdamW, without AdamW's many foreach ops (whose sharding
    propagation on a three-axis dry mesh costs more than the rest of the
    step)."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        return grads, state, torch.zeros(())


@functools.lru_cache(maxsize=None)
def _moe_trace(arch, mesh_shape, n_layers, optimizer=None):
    """A reduced train step of ``arch`` traced on a dry "cpu" mesh of
    ``mesh_shape`` (("data", "model") or ("pod", "data", "model")): (its
    collectives, FLOPs per rank, the largest allocation per call site)."""
    cfg = get_config(arch).reduced(**dryrun.LITE, n_layers=n_layers,
                                   **MOE_CUTS.get(arch, {}))
    api = get_model(cfg, device="cpu")
    axes = ("data", "model") if len(mesh_shape) == 2 else (
        "pod", "data", "model")
    allocs = _Allocations()
    with dry_world(math.prod(mesh_shape)):
        mesh = make_mesh(mesh_shape, axes, "cpu")
        with allocs:
            recs, flops = comm_stats.trace_train_step(
                api, mesh, TRAIN, optimizer=optimizer and optimizer())
    return recs, flops, allocs.by_site, cfg


@pytest.mark.parametrize("arch", list(MOE_CUTS))
def test_moe_train_keeps_the_dispatch_split(arch):
    """No rank holds another rank's expert rows or another group's: every
    tensor allocated at the MoE's lines (forward, recompute, or a
    redistribution's backward) fits the rank's shard [G/2, E/4, C, D] of
    the [G, E, C, D] dispatch (plus the combine's zero row); and the
    global norm of the gradients gathers none of them whole."""
    recs, _, allocs, cfg = _moe_trace(arch, (2, 4), 1)
    G, T = 2, TRAIN.seq_len * TRAIN.global_batch
    E, K, D = cfg.n_experts, cfg.top_k, cfg.d_model
    C = max(math.ceil(K * (T // G) / E * 1.25), K)
    shard = (G // 2) * ((E // 4) * C + 1) * D * 4
    moe = {site: n for site, n in allocs.items() if "moe" in site}
    assert moe and max(moe.values()) <= shard, sorted(
        moe.items(), key=lambda kv: -kv[1])[:4]
    assert max(moe.values()) * 4 > shard      # the shard itself was seen
    gathered = [row for row in comm_stats.by_site(recs)
                if "global_norm" in row[0] and "all-gather" in row[3]]
    assert not gathered, gathered


def test_dbrx_flops_per_rank_halve_on_two_pods():
    """One expert a rank (16 over a model axis of 4 holds 4, as dbrx's 16
    over 16 holds 1 at full size, the groups split over pod and data):
    twice the ranks, half the FLOPs of each."""
    _, flops_1, _, _ = _moe_trace("dbrx-132b", (2, 4), 1,
                                  _GradientsAsUpdates)
    _, flops_2, _, _ = _moe_trace("dbrx-132b", (2, 2, 4), 1,
                                  _GradientsAsUpdates)
    assert math.isclose(flops_2, flops_1 / 2, rel_tol=0.05), (flops_1,
                                                              flops_2)


def test_vlm_prefix_needs_no_collective():
    """internvl2 (a vocab that the model axis does not split, as 151,655
    does not split 16 ways): the vision prefix is concatenated in front of
    the tokens and sliced off the hidden state on each rank's shards, with
    no collective at either (``blocks.seq_op``), forward or backward. (The
    embeddings are put in one layout with the sequence whole just before
    the concatenation, in ``lm._embed``: a prefix shifts every sequence
    shard.)"""
    cfg = get_config("internvl2-1b").reduced(**dict(dryrun.LITE,
                                                    vocab=1022),
                                             n_layers=1)
    api = get_model(cfg, device="cpu")
    with dry_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        recs, _ = comm_stats.trace_train_step(api, mesh, TRAIN)
    sites = comm_stats.by_site(recs)
    assert recs and not [r for r in sites if "seq_op" in r[0]
                         or "(loss_fn)" in r[0]], sites


def _moe_before(probs, xf, w_gate, w_up, w_down, K, C):
    """The dispatch as it was: every expert's rows gathered, the combine
    summing the K rows of each token from one [G, Tl·K, D] gather."""
    xe, gate, row_of_slot, _, _, _ = B._moe_route(probs, xf, K, C)
    G, E, _, D = xe.shape
    xg = xe.permute(1, 0, 2, 3).reshape(E, G * C, D)
    h = B.silu(torch.bmm(xg, w_gate)) * torch.bmm(xg, w_up)
    out_e = torch.bmm(h, w_down).reshape(E, G, C, D).permute(1, 0, 2, 3)
    out_e = out_e * gate[..., None]
    rows = torch.cat([out_e.reshape(G, E * C, D),
                      torch.zeros((G, 1, D), dtype=out_e.dtype)], dim=1)
    picked = torch.gather(rows, 1, row_of_slot[..., None].expand(
        *row_of_slot.shape, D)).reshape(G, -1, K, D)
    out = picked[:, :, 0]
    for k in range(1, K):
        out = out + picked[:, :, k]
    return out


def test_moe_dispatch_same_bits_and_expert_slices_sum_to_whole():
    g = torch.Generator().manual_seed(0)
    G, Tl, D, F, E, K, C = 2, 24, 16, 8, 8, 3, 7
    probs = torch.softmax(torch.randn(G, Tl, E, generator=g), -1)
    xf = torch.randn(G, Tl, D, generator=g)
    ws = [torch.randn(E, D, F, generator=g) * 0.3,
          torch.randn(E, D, F, generator=g) * 0.3,
          torch.randn(E, F, D, generator=g) * 0.3]

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (probs, xf, *ws)]
        out = fn(*leaves)
        out.backward(torch.linspace(-1, 1, out.numel()).reshape(out.shape))
        return out.detach(), [t.grad for t in leaves]

    want, want_g = run(lambda p, x, *w: _moe_before(p, x, *w, K, C))
    got, got_g = run(lambda p, x, *w: B._moe_experts(
        p, x, *w, K=K, C=C, e_first=0)[0])
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)
    # two ranks' expert slices: partial sums of the output and of the
    # probs' and tokens' gradients; each slice's weight gradients are its
    # experts' rows of the whole's
    parts = [run(lambda p, x, *w, lo=lo: B._moe_experts(
        p, x, *(t[lo:lo + E // 2] for t in w), K=K, C=C, e_first=lo)[0])
        for lo in (0, E // 2)]
    torch.testing.assert_close(parts[0][0] + parts[1][0], want, rtol=1e-5,
                               atol=1e-6)
    for i in (0, 1):
        torch.testing.assert_close(parts[0][1][i] + parts[1][1][i],
                                   want_g[i], rtol=1e-5, atol=1e-6)
    for i in (2, 3, 4):
        for half, lo in zip(parts, (0, E // 2)):
            torch.testing.assert_close(half[1][i][lo:lo + E // 2],
                                       want_g[i][lo:lo + E // 2],
                                       rtol=1e-5, atol=1e-6)


def _records():
    return [json.loads(f.read_text()) for f in RESULTS.glob("*.json")]


@pytest.mark.skipif(
    not RESULTS.exists() or not list(RESULTS.glob("*.json")),
    reason="results/dryrun_torch/*.json absent — generate on the card's box "
           "with `PYTHONPATH=src python -m repro_torch.launch.dryrun --arch "
           "all --shape all` (traces every arch×shape×mesh cell at full "
           "depth on dry worlds of 256 and 512 ranks)")
class TestDryrunArtifacts:
    def test_all_cells_traced(self):
        bad = [f"{r['arch']}/{r['shape']}/{r['mesh']}: {r.get('error')}"
               for r in _records() if not r.get("ok")]
        assert not bad, bad

    def test_memory_fits_hbm(self):
        # H100 SXM5: 80 GB of HBM3 per card
        for r in _records():
            if not r.get("ok"):
                continue
            peak = r["memory"].get("peak_memory_in_bytes")
            if peak:
                assert peak <= HBM_CAPACITY, (
                    f"{r['arch']}/{r['shape']}/{r['mesh']} "
                    f"peak {peak / 1e9:.1f} GB > 80 GB")

    def test_flops_positive_and_collectives_present(self):
        for r in _records():
            if not r.get("ok"):
                continue
            assert r["flops"] > 0
            assert r["collectives"].get("count", 0) > 0, (
                f"{r['arch']}/{r['shape']}/{r['mesh']}: the step issued no "
                "collectives — sharding is broken")

    def test_multipod_pod_axis_shards(self):
        """Multi-pod train cells must communicate across the pod axis
        (batch is sharded over it)."""
        recs = {(r["arch"], r["shape"], r["mesh"]): r
                for r in _records() if r.get("ok")}
        pairs = 0
        for (arch, shape, mesh), r in recs.items():
            if mesh != "pod_16x16" or r["kind"] != "train":
                continue
            r2 = recs.get((arch, shape, "multipod_2x16x16"))
            if r2 is None:
                continue
            pairs += 1
            assert r2["collectives"].get("count", 0) >= 1
            assert any(k.endswith("/pod") for k in r2["collectives_by_axis"])
        assert pairs >= 1


def test_results_directory_is_the_ports_own():
    assert RESULTS.name == "dryrun_torch"
    assert RESULTS.parent == pathlib.Path(__file__).resolve().parents[1] / \
        "results"
