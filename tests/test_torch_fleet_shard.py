"""``FleetRunner(shard=...)`` on the CPU: the port's mirror of
``tests/test_multidevice.py``.

The reference emulates four host devices with
``--xla_force_host_platform_device_count``; the port takes a list of
devices, and ``["cpu"] * 4`` gives four streams on the one CPU. The
contract is the reference's: a chunk's padded row count does not depend on
the device count, so the shard changes where a chunk runs, never what it
computes. On ``campaign_fleet(54, seed=0)`` (54 does not divide by 4: the
round-robin must take the ragged tail), 8 s at dt 0.5, 16-row chunks:

* campaign metrics over four streams equal the one-stream campaign's bit
  for bit, for tcp, appaware (the waterfill solver: its plain version on
  the CPU), appfair and fixed, and the JAX package's one-device campaign
  at the run tolerance of ``tests/test_torch_campaign.py`` (1e-4);
* four streams are used, host staging stays within three slots per
  stream;
* ``run`` over four devices keeps every trajectory bit for bit, and its
  metrics drift at most in ``total_sink_mb``, by at most 4 ULP (the
  reference's pin);
* a checkpoint written by a one-stream campaign resumes a four-stream one;
* a device that does not exist raises.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

import repro.streams as J
from _torch_parity import CPU, port_sim
from repro_torch.streams import FleetRunner
from repro_torch.streams.simulator import metric_index

SECONDS = 8.0
DT = 0.5
N_SCEN = 54          # not divisible by the 4 streams
CHUNK_ROWS = 16      # 27-member buckets -> 2 chunks each -> 4 streams
POLICIES = ("tcp", "appaware", "appfair", "fixed")
FOUR = ["cpu"] * 4


@pytest.fixture(autouse=True)
def _one_thread_no_fallback():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jsims():
    return J.compile_fleet(J.campaign_fleet(N_SCEN, seed=0))


@functools.lru_cache(maxsize=None)
def _sims():
    return [port_sim(s) for s in _jsims()]


def _kw(policy, sims):
    if policy == "fixed":
        return dict(x_fixed=[np.full(s.R.shape[0], 0.25, np.float32)
                             for s in sims])
    if policy == "appaware":
        return dict(solver="waterfill")
    return {}


def _runner():
    return FleetRunner(device=CPU, tick_overhead=15e3)


def _campaign(runner, policy, shard, **extra):
    sims = _sims()
    return runner.run_campaign(sims, policy, seconds=SECONDS, dt=DT,
                               chunk_rows=CHUNK_ROWS, shard=shard,
                               **_kw(policy, sims), **extra)


@pytest.mark.parametrize("policy", POLICIES)
def test_four_streams_bitwise_equal_to_one(policy):
    runner = _runner()
    one = _campaign(runner, policy, False)
    assert runner.last_stats["n_streams"] == 1
    four = _campaign(runner, policy, FOUR)
    st = runner.last_stats
    np.testing.assert_array_equal(four.metrics, one.metrics)
    # all four streams take chunks, host staging stays within three slots
    # a stream
    assert st["n_streams"] == 4 and st["n_chunks"] >= 4, st
    assert st["devices"] == ["cpu"] * 4
    assert 0 < st["peak_staged_rows"] <= 3 * st["chunk_rows"] * 4
    # the JAX package's one-device campaign (its appaware through the sort
    # solver: the waterfill kernel solves the same fill)
    jsims = _jsims()
    jkw = {k: v for k, v in _kw(policy, jsims).items() if k != "solver"}
    want = J.FleetRunner(tick_overhead=15e3).run_campaign(
        jsims, policy, seconds=SECONDS, dt=DT, chunk_rows=CHUNK_ROWS, **jkw)
    np.testing.assert_allclose(four.metrics, want.metrics, rtol=1e-4,
                               atol=1e-4)


def test_sharded_run_drift_confined_to_total_sink_mb():
    sims = _sims()
    sink = metric_index("total_sink_mb")
    runner = _runner()
    for policy in ("tcp", "appaware"):
        kw = _kw(policy, sims)
        sh = runner.run(sims, policy, seconds=SECONDS, dt=DT, shard=FOUR,
                        **kw)
        assert runner.last_stats["n_shards"] == 4
        assert all(r % 4 == 0 for r in runner.last_stats["rows"])
        un = runner.run(sims, policy, seconds=SECONDS, dt=DT, shard=False,
                        **kw)
        for a, b in zip(sh, un):
            for f in ("sink_mb", "link_load", "latency"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        ms = np.stack([r.metrics for r in sh])
        mu = np.stack([r.metrics for r in un])
        assert set(np.nonzero(ms != mu)[1].tolist()) <= {sink}, policy
        ulp = np.abs(ms.view(np.int32).astype(np.int64)
                     - mu.view(np.int32).astype(np.int64)).max()
        assert ulp <= 4, (policy, ulp)


def test_one_stream_checkpoint_resumes_four_streams(tmp_path):
    runner = _runner()
    one = _campaign(runner, "tcp", False, checkpoint=tmp_path)
    fp = runner.last_stats["fingerprint"]
    four = _campaign(runner, "tcp", FOUR, checkpoint=tmp_path)
    st = runner.last_stats
    assert st["fingerprint"] == fp
    assert st["n_chunks_resumed"] == st["n_chunks"]
    assert st["n_dispatches"] == 0
    np.testing.assert_array_equal(four.metrics, one.metrics)


@pytest.mark.parametrize("shard", [["cpu", "cuda:0"], ["cpu:1"], ["meta"],
                                   []])
def test_a_device_that_does_not_exist_raises(shard):
    runner = _runner()
    with pytest.raises((RuntimeError, ValueError)):
        _campaign(runner, "tcp", shard)
    with pytest.raises((RuntimeError, ValueError)):
        runner.run(_sims()[:4], "tcp", seconds=SECONDS, shard=shard)
