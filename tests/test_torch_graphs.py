"""The CUDA-graph path of the campaign's tick loops
(``repro_torch.streams.graphs``) on the CPU, where every bucket runs eager.

A CPU campaign captures and replays nothing (``graph_tick_share`` 0) and
keeps its rows bit for bit those of ``FleetRunner.run`` at the same padded
rows; ``BucketGraphs.run`` on the CPU is ``_run_bucket`` run to its end;
the signature separates runs that differ in the tick count, the policy, a
field's shape or the stream; and the waterfill wrapper's launch counter
takes a replay's launches under its stream. The card's side is in
``tests/test_torch_gpu.py``."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.waterfill import ops
from repro_torch.streams import FleetRunner, campaign_fleet, compile_fleet
from repro_torch.streams.graphs import BucketGraphs, signature
from repro_torch.streams.simulator import _run_bucket

SECONDS, DT = 10.0, 0.5
N_TICKS = int(SECONDS / DT)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _sims():
    return compile_fleet(campaign_fleet(24, seed=0), device="cpu")


def _runner():
    return FleetRunner(device="cpu", tick_overhead=15e3)


def _pack(rows=4):
    sims = _sims()
    (idxs, shape), *_ = _runner().plan(sims, "appaware")
    chunk = [sims[i] for i in idxs[:rows]]
    leaves = FleetRunner._fill_bucket({}, chunk, shape, rows)
    _, enf = FleetRunner._gates(chunk, idxs[:rows], shape, rows, None)
    return ({k: torch.from_numpy(v) for k, v in leaves.items()},
            torch.from_numpy(enf), shape.n_apps)


@pytest.mark.parametrize("policy,solver", [("appaware", "waterfill"),
                                           ("tcp", "sort")])
def test_cpu_campaign_captures_nothing_and_keeps_its_rows(policy, solver):
    sims = _sims()
    runner = _runner()
    cr = runner.run_campaign(sims, policy, seconds=SECONDS, solver=solver,
                             chunk_rows=len(sims))
    st = runner.last_stats
    assert (st["n_graph_captures"], st["n_graph_replays"],
            st["n_graph_fallbacks"], st["graph_tick_share"]) == (0, 0, 0, 0.0)
    assert st["n_ticks"] == st["n_chunks"] * N_TICKS
    oracle = _runner()
    want = np.stack([r.metrics for r in oracle.run(
        sims, policy, seconds=SECONDS, solver=solver)])
    assert oracle.last_stats["rows"] == st["rows"]
    np.testing.assert_array_equal(cr.metrics, want)


def test_bucket_graphs_on_the_cpu_is_the_eager_loop():
    pack, enf, n_apps = _pack()
    args = (n_apps, "appaware", N_TICKS, DT, 10)
    kw = dict(solver="waterfill", enforce=enf, t_event=5.0)
    graphs = BucketGraphs()
    got = graphs.run(pack, *args, **kw)
    loop = _run_bucket(pack, *args, stepwise=True, **kw)
    while True:
        try:
            next(loop)
        except StopIteration as stop:
            want = stop.value
            break
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (graphs.captures, graphs.replays, graphs.fallbacks) == (0, 0, 0)


def _key(pack, enf, n_apps, stream=None, **over):
    static = dict(n_apps=n_apps, policy="appaware", n_ticks=N_TICKS, dt=DT,
                  upd_every=10, alpha=0.5, n_groups=8, qcap=8.0,
                  solver="waterfill", with_metrics=True, t_event=0.0)
    static.update(over)
    return signature(pack, None, enf, stream, **static)


def test_signature_separates_what_a_graph_depends_on():
    pack, enf, n_apps = _pack()
    base = _key(pack, enf, n_apps)
    # the same arguments on fresh tensors of the same shapes: one key
    again = {k: v.clone() for k, v in pack.items()}
    assert _key(again, enf.clone(), n_apps) == base
    wider = dict(pack, R=torch.zeros(pack["R"].shape[0],
                                     pack["R"].shape[1] + 1,
                                     pack["R"].shape[2]))
    f64 = dict(pack, caps=pack["caps"].to(torch.float64))
    others = [_key(pack, enf, n_apps, n_ticks=N_TICKS + 1),
              _key(pack, enf, n_apps, policy="tcp", solver="sort"),
              _key(pack, enf, n_apps, solver="sort"),
              _key(wider, enf, n_apps),
              _key(f64, enf, n_apps),
              _key(pack, enf, n_apps, stream=7),
              _key(pack, None, n_apps)]
    keys = [base] + others
    assert len(set(keys)) == len(keys)


def test_a_replay_counts_its_launches_under_its_stream():
    before, key = ops.LAUNCHES, (0, 12345)
    was = ops.STREAM_LAUNCHES.get(key, 0)
    try:
        ops.count_launches(24, *key)
        assert ops.LAUNCHES - before == 24
        assert ops.STREAM_LAUNCHES[key] - was == 24
    finally:
        ops.LAUNCHES = before
        if was:
            ops.STREAM_LAUNCHES[key] = was
        else:
            del ops.STREAM_LAUNCHES[key]


def test_a_failed_campaign_drops_its_graphs():
    # the teardown that drops the staging slots drops the graphs too
    from repro_torch.streams import FaultAbort, FaultPlan, FaultSpec

    runner = _runner()
    runner._graphs._entries[((torch.device("cpu"), None),)] = None
    with pytest.raises(FaultAbort):
        runner.run_campaign(_sims(), "tcp", seconds=SECONDS, chunk_rows=8,
                            faults=FaultPlan([FaultSpec("abort", chunk=1)]))
    assert runner._graphs._entries == {}
