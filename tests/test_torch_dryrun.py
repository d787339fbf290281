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
  where no sweep has written there.

Every dry world is opened by ``run_cell`` or a fixture, and destroyed."""
import json
import math
import pathlib

import pytest
import torch

from repro.launch import mesh as jmesh
from repro.launch import roofline as jroof
from repro_torch.core import scheduler
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_plain
from repro_torch.launch import comm_stats, dryrun, dryrun_report, roofline
from repro_torch.launch.mesh import HBM_CAPACITY, dry_world, make_mesh
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
