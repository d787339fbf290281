"""The port's collective record and scheduler (``repro_torch.launch
.comm_stats``, ``repro_torch.core.scheduler``) against the JAX package's
``hlo_stats`` and ``core.scheduler``.

The JAX tests read collectives from HLO lines; the port records them from
the functional collective ops a step issues. Here each HLO line of
``tests/test_distribution.py::TestHloStats`` and ``tests/test_scheduler.py
::TestExtractFlows`` becomes the record that op would leave (kind, result
shapes and dtypes, group size, mesh axis), and both packages must give the
same numbers. ``plan_schedule`` is held to the JAX one at 1e-5 relative on
seeded flow sets, with the JAX link rates (TPU) patched into the port's
module for the comparison; its own rates are the H100's."""
import textwrap

import numpy as np
import pytest
import torch

from repro.core import scheduler as jsched
from repro.launch import hlo_stats
from repro_torch.core import scheduler as tsched
from repro_torch.launch import comm_stats
from repro_torch.launch.comm_stats import Collective
from repro_torch.launch.mesh import (HBM_BW, INTER_NODE_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16, dry_world, make_mesh)

f32, bf16, u8 = torch.float32, torch.bfloat16, torch.uint8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestHloStats:
    HLO = textwrap.dedent("""\
      %all-reduce.1 = f32[16,512]{1,0} all-reduce(%x), channel_id=1, replica_groups=[16,16]<=[256], to_apply=%add
      %ag = bf16[64,1024]{1,0} all-gather(%y), channel_id=2, replica_groups=[8,32]<=[256], dimensions={0}
      %rs = f32[4,256]{1,0} reduce-scatter(%z), channel_id=3, replica_groups=[2,4]<=[8], to_apply=%add
      %cp = u8[1000]{0} collective-permute(%w), channel_id=4, source_target_pairs={{0,1}}
      %ar2 = (f32[8]{0}, f32[8]{0}) all-reduce(%a, %b), channel_id=5, replica_groups=[4,4]<=[16], to_apply=%add
      %notacoll = f32[2,2]{1,0} add(%p, %q)
    """)
    RECORDS = [
        Collective("all-reduce", ((f32, (16, 512)),), 16, "model"),
        Collective("all-gather", ((bf16, (64, 1024)),), 32, None),
        Collective("reduce-scatter", ((f32, (4, 256)),), 4, "model"),
        Collective("collective-permute", ((u8, (1000,)),), 1, None),
        Collective("all-reduce", ((f32, (8,)), (f32, (8,))), 4, None),
    ]

    def test_parse(self):
        st = comm_stats.collective_stats(self.RECORDS)
        assert st == hlo_stats.collective_stats(self.HLO)
        assert st["count"] == 5
        assert st["all-reduce"] == 16 * 512 * 4 + 2 * 8 * 4
        # all-gather operand = result / group size (32)
        assert st["all-gather"] == 64 * 1024 * 2 // 32
        # reduce-scatter operand = result * group size (4)
        assert st["reduce-scatter"] == 4 * 256 * 4 * 4
        assert st["collective-permute"] == 1000
        assert st["total"] == sum(
            st[k] for k in ("all-reduce", "all-gather", "reduce-scatter",
                            "collective-permute"))

    def test_one_record_per_op(self):
        """An async pair (-start/-done) is one op in the HLO; the port
        records each functional collective once, its wait not at all."""
        txt = ("%s = f32[8]{0} all-reduce-start(%x), replica_groups=[2,2]<=[4]\n"
               "%d = f32[8]{0} all-reduce-done(%s)\n")
        st = comm_stats.collective_stats(
            [Collective("all-reduce", ((f32, (8,)),), 2, "data")])
        assert st == hlo_stats.collective_stats(txt)

    @pytest.mark.parametrize("dtype,name", [
        (torch.bool, "pred"), (torch.int8, "s8"), (torch.uint8, "u8"),
        (torch.int16, "s16"), (torch.bfloat16, "bf16"), (torch.float16, "f16"),
        (torch.int32, "s32"), (torch.float32, "f32"), (torch.int64, "s64"),
        (torch.float64, "f64"), (torch.complex64, "c64"),
        (torch.complex128, "c128"), (torch.float8_e4m3fn, "f8e4m3fn"),
        (torch.float8_e5m2, "f8e5m2")])
    def test_shape_bytes(self, dtype, name):
        assert comm_stats.shape_bytes(dtype, (3, 5)) == \
            hlo_stats.shape_bytes(name, "3,5")
        assert comm_stats.shape_bytes(dtype, ()) == hlo_stats.shape_bytes(
            name, "")


class TestExtractFlows:
    HLO = textwrap.dedent("""\
      %ar = f32[16,512]{1,0} all-reduce(%x), replica_groups=[16,16]<=[256], to_apply=%add
      %ag = bf16[64,1024]{1,0} all-gather(%y), replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}
    """)
    MESH = {"data": 16, "model": 16}

    def test_axis_attribution(self):
        # the group's mesh axis is exact: contiguous groups are the minor
        # ("model") axis' groups, strided ones the major's
        recs = [Collective("all-reduce", ((f32, (16, 512)),), 16, "model"),
                Collective("all-gather", ((bf16, (64, 1024)),), 16, "data")]
        flows = tsched.extract_flows(recs, self.MESH)
        want = jsched.extract_flows(self.HLO, self.MESH)
        assert len(flows) == len(want) == 2
        for f, w in zip(flows, want):
            assert (f.kind, f.bytes, f.axis, f.phase) == \
                (w.kind, w.bytes, w.axis, w.phase)
        assert flows[0].axis == "model" and flows[1].axis == "data"
        assert flows[0].bytes == 16 * 512 * 4
        assert flows[1].bytes == 64 * 1024 * 2 / 16  # all-gather operand

    @pytest.mark.parametrize("gsize,axis", [(16, "model"), (4, "model"),
                                            (2, "pod"), (32, "model")])
    def test_group_over_several_dims_goes_by_size(self, gsize, axis):
        """No single mesh axis (a flattened group): the JAX package's size
        rule for a contiguous group."""
        mesh = {"pod": 2, "data": 16, "model": 16}
        rec = Collective("all-reduce", ((f32, (8,)),), gsize, None)
        (f,) = tsched.extract_flows([rec], mesh)
        hlo = (f"%ar = f32[8]{{0}} all-reduce(%x), replica_groups="
               f"[{512 // gsize},{gsize}]<=[512], to_apply=%add\n")
        (w,) = jsched.extract_flows(hlo, mesh)
        assert f.axis == w.axis == axis

    def test_plan_schedule_properties(self):
        flows = [
            tsched.CollectiveFlow("g1", "all-reduce", 1e9, "data"),
            tsched.CollectiveFlow("g2", "all-reduce", 2e9, "data"),
            tsched.CollectiveFlow("a1", "all-gather", 5e8, "model"),
            tsched.CollectiveFlow("dcn", "all-reduce", 1e8, "pod"),
        ]
        sched = tsched.plan_schedule(flows, {"pod": 2, "data": 16,
                                             "model": 16},
                                     step_compute_s=0.1, device="cpu")
        assert len(sched.order) == 4
        assert sched.rates.shape == (4,)
        assert (sched.rates >= 0).all()
        assert sched.est_total_comm_s > 0
        # per-axis allocation is capacity-feasible, at the H100's rates
        for axis, bw in (("data", NVLINK_BW), ("model", NVLINK_BW),
                         ("pod", INTER_NODE_BW)):
            tot = sum(r for r, f in zip(sched.rates, flows) if f.axis == axis)
            assert tot <= bw * 1.001
        # bigger flows on the same axis get proportionally more bandwidth
        r = {f.name: r for f, r in zip(flows, sched.rates)}
        assert r["g2"] > r["g1"]

    def test_empty(self):
        sched = tsched.plan_schedule([], {"data": 4}, 0.1, device="cpu")
        assert sched.order == []


def _flow_set(seed):
    rng = np.random.default_rng(seed)
    axes = {"pod": 2, "data": 16, "model": 16}
    kinds = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all"]
    flows = []
    for i in range(int(rng.integers(3, 40))):
        flows.append(jsched.CollectiveFlow(
            f"f{i}", kinds[int(rng.integers(4))],
            float(rng.integers(1, 4000)) * 1e5,
            list(axes)[int(rng.integers(3))]))
    backlog = None
    if seed % 2:
        backlog = np.array([f.bytes for f in flows]) * rng.uniform(
            0.1, 2.0, len(flows))
    return flows, axes, backlog, float(rng.choice([1e-4, 0.01, 0.3]))


@pytest.mark.parametrize("seed", range(8))
def test_plan_schedule_matches_jax(seed, monkeypatch):
    """Rates (1e-5 relative), order, chunks and both estimates against the
    JAX scheduler on the same flows, with the JAX link rates patched in."""
    monkeypatch.setattr(tsched, "_AXIS_BW_GBPS", dict(jsched._AXIS_BW_GBPS))
    flows, axes, backlog, compute = _flow_set(seed)
    want = jsched.plan_schedule(flows, axes, compute, backlog)
    got = tsched.plan_schedule(
        [tsched.CollectiveFlow(f.name, f.kind, f.bytes, f.axis)
         for f in flows], axes, compute, backlog, device="cpu")
    np.testing.assert_allclose(got.rates, np.asarray(want.rates), rtol=1e-5)
    assert got.chunks == want.chunks
    np.testing.assert_allclose(got.est_exposed_s, want.est_exposed_s,
                               rtol=1e-5)
    np.testing.assert_allclose(got.est_total_comm_s, want.est_total_comm_s,
                               rtol=1e-5)
    # the order: the JAX transfer times, read in the port's order, never
    # rise (flows whose times agree within 1e-5 may trade places)
    b = np.array([f.bytes for f in flows]) if backlog is None else backlog
    ttime = b / np.maximum(np.asarray(want.rates), 1e-9)
    seq = ttime[got.order]
    assert sorted(got.order) == list(range(len(flows)))
    assert np.all(seq[1:] <= seq[:-1] * (1 + 1e-5))
    distinct = np.unique(np.round(ttime, 6)).size == len(flows)
    if distinct:
        assert [int(i) for i in got.order] == [int(i) for i in want.order]


def test_h100_constants():
    """The port's link and chip rates are the H100 SXM5's (700 W), none of
    the TPU numbers the JAX package's mesh module holds."""
    from repro.launch import mesh as jmesh
    assert PEAK_FLOPS_BF16 == 989e12 and HBM_BW == 3.35e12
    assert NVLINK_BW == 450e9 and INTER_NODE_BW == 50e9
    assert tsched._AXIS_BW_GBPS == {"model": 450.0, "data": 450.0,
                                    "pod": 50.0}
    for ours in (PEAK_FLOPS_BF16, HBM_BW, NVLINK_BW):
        assert ours not in (jmesh.PEAK_FLOPS_BF16, jmesh.HBM_BW,
                            jmesh.ICI_BW)


def test_record_names_the_mesh_axis():
    """A DTensor redistribution on a dry (2, 4) mesh: each recorded op
    names the axis of its group and its size."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dry_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        x = DTensor.from_local(torch.empty(4, 8, device="meta"), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        with comm_stats.record(mesh) as recs:
            x.redistribute(mesh, [Replicate(), Shard(1)])
            x.redistribute(mesh, [Shard(0), Replicate()])
    assert [(c.kind, c.axis, c.group_size) for c in recs] == [
        ("all-gather", "data", 2), ("all-gather", "model", 4)]
    assert recs[0].results == ((torch.float32, (8, 8)),)
    st = comm_stats.collective_stats(recs)
    assert st["all-gather"] == 8 * 8 * 4 // 2 + 4 * 32 * 4 // 4
    assert comm_stats.by_axis(recs) == {"data": (1, 128), "model": (1, 128)}


def test_record_counts_dtensors_all_to_all():
    """On a "cuda" mesh DTensor redistributes shard to shard through its
    own op, ``_dtensor.shard_dim_alltoall`` (a "cpu" mesh gathers
    instead): recorded as an all-to-all of its group, operand == result,
    and tallied per (kind, axis) with the flows made of it."""
    from repro_torch.core.scheduler import extract_flows
    from repro_torch.sharding.policy import mesh_axes
    with dry_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        x = torch.empty(8, 16, device="meta")
        with comm_stats.record(mesh) as recs:
            out = torch.ops._dtensor.shard_dim_alltoall(
                x, 0, 1, mesh.get_group(1).group_name)
        axes = mesh_axes(mesh)
    assert tuple(out.shape) == (32, 4)
    assert [(c.kind, c.axis, c.group_size) for c in recs] == [
        ("all-to-all", "model", 4)]
    assert recs[0].bytes == 32 * 4 * 4
    assert comm_stats.collective_stats(recs)["all-to-all"] == 512
    flows = extract_flows(recs, axes)
    assert comm_stats.by_axis(recs, per_kind=True) == comm_stats.by_axis(
        flows, per_kind=True) == {("all-to-all", "model"): (1, 512)}
