"""Fault injection and the resilient campaign, on the CPU.

``repro_torch.streams.faults`` is the port's own copy of the reference's
module: its plans are held to the reference's (same validation, same
consumption order and log, same seeded random plans). The campaign's
resilience layer is held to the contract of ``tests/test_resilience.py``:
every row the recovery paths touch (retry, watchdog, bisection, resume)
comes out bit for bit equal to the fault-free campaign, because every
re-run uses the bucket's own padded row count and rows are independent."""
import dataclasses
import functools
import os
import sys
import threading

import numpy as np
import pytest

import repro.streams.faults as jfaults
from repro_torch.net.topology import LinkSchedule
from repro_torch.streams import (
    FailureRecord,
    FaultAbort,
    FaultPlan,
    FaultSpec,
    FleetRunner,
    FleetShape,
    InjectedFault,
    campaign_fleet,
    compile_fleet,
    pad_sim,
)

CPU = "cpu"
SECONDS = 4.0
CHUNK = 8
FAST = dict(retry_backoff_s=0.001, retry_backoff_cap_s=0.01)


class TestFaultPlan:
    @pytest.mark.parametrize("kw,match", [
        (dict(stage="h2d"), "unknown fault stage"),
        (dict(stage="pack", times=0), "times"),
        (dict(stage="pack", times=-2), "times"),
        (dict(stage="dispatch", hang_s=1.0), "hang_s"),
        (dict(stage="transfer", hang_s=-1.0), "hang_s"),
    ])
    def test_spec_validation_matches_reference(self, kw, match):
        with pytest.raises(ValueError, match=match) as mine:
            FaultSpec(**kw)
        with pytest.raises(ValueError) as ref:
            jfaults.FaultSpec(**kw)
        assert str(mine.value) == str(ref.value)

    def test_fire_consumes_and_logs_like_reference(self):
        specs = [("dispatch", 3, 2), ("pack", None, 1), ("transfer", 1, -1)]
        mine = FaultPlan([FaultSpec(s, chunk=c, times=t)
                          for s, c, t in specs])
        ref = jfaults.FaultPlan([jfaults.FaultSpec(s, chunk=c, times=t)
                                 for s, c, t in specs])
        visits = [("dispatch", 0), ("pack", 3), ("dispatch", 3),
                  ("dispatch", 3), ("dispatch", 3), ("transfer", 1),
                  ("transfer", 1), ("pack", 5), ("abort", 2)] * 2
        for stage, chunk in visits:
            outcomes = []
            for plan, exc in ((mine, InjectedFault),
                              (ref, jfaults.InjectedFault)):
                try:
                    plan.fire(stage, chunk)
                    outcomes.append(None)
                except exc as e:
                    outcomes.append((e.stage, e.chunk, str(e)))
            assert outcomes[0] == outcomes[1]
        assert mine.log == ref.log
        for stage in (None, "dispatch", "pack", "transfer"):
            assert mine.n_fired(stage) == ref.n_fired(stage)

    @pytest.mark.parametrize("seed", [0, 7, 123])
    def test_random_plans_match_reference(self, seed):
        kw = dict(n_chunks=10, n_scenarios=100, n_transient=3, n_poison=2)
        mine = FaultPlan.random(seed, **kw)
        ref = jfaults.FaultPlan.random(seed, **kw)
        assert [dataclasses.astuple(s) for s in mine.specs] == \
            [dataclasses.astuple(s) for s in ref.specs]
        assert mine.poison == ref.poison
        assert mine.poison and all(0 <= i < 100 for i in mine.poison)
        assert FaultPlan.random(seed, **kw).specs == mine.specs

    def test_poison_mask_abort_and_hang(self):
        fp = FaultPlan([FaultSpec("abort", chunk=2),
                        FaultSpec("transfer", hang_s=0.01)], poison={2, 5})
        np.testing.assert_array_equal(fp.poison_mask([1, 2, 3, 5]),
                                      [False, True, False, True])
        assert issubclass(FaultAbort, BaseException)
        assert not issubclass(FaultAbort, Exception)
        fp.fire("abort", 1)
        with pytest.raises(FaultAbort):
            fp.fire("abort", 2)
        fp.fire("transfer", 0)                       # sleeps, never raises
        assert fp.log == [("abort", 2, "raise"), ("transfer", 0, "hang")]

    def test_consumption_is_thread_safe(self):
        # more threads than cores and a short switch interval: a lost
        # update of the remaining count would fire more than 50 times
        fp = FaultPlan([FaultSpec("transfer", times=50)])
        hits = []

        def worker():
            for _ in range(20):
                try:
                    fp.fire("transfer", 0)
                except InjectedFault:
                    hits.append(1)
        threads = [threading.Thread(target=worker)
                   for _ in range(2 * (os.cpu_count() or 4))]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert len(hits) == 50 == fp.n_fired()


@functools.lru_cache(maxsize=None)
def _corpus():
    return compile_fleet(campaign_fleet(48, seed=0), device=CPU)


@pytest.fixture(scope="module")
def runner():
    return FleetRunner(device=CPU, tick_overhead=15e3)


@pytest.fixture(scope="module")
def oracle(runner):
    cr = runner.run_campaign(_corpus(), "tcp", seconds=SECONDS,
                             chunk_rows=CHUNK)
    assert runner.last_stats["status"] == "ok"
    assert runner.last_stats["n_chunks"] >= 4
    return cr.metrics.copy()


def _campaign(runner, **kw):
    return runner.run_campaign(_corpus(), "tcp", seconds=SECONDS,
                               chunk_rows=CHUNK, **kw)


class TestRecovery:
    @pytest.mark.parametrize("stage", ["pack", "transfer", "dispatch"])
    def test_transient_fault_recovers_bitwise(self, runner, oracle, stage):
        fp = FaultPlan([FaultSpec(stage, chunk=1, times=1)])
        cr = _campaign(runner, faults=fp, **FAST)
        st = runner.last_stats
        assert st["status"] == "ok" and fp.n_fired(stage) == 1
        assert st["n_recovered_chunks"] == 1 and not cr.failures
        np.testing.assert_array_equal(cr.metrics, oracle)

    def test_transfer_retry_then_succeed(self, runner, oracle):
        fp = FaultPlan([FaultSpec("transfer", chunk=2, times=2)])
        cr = _campaign(runner, faults=fp, **FAST)
        assert fp.n_fired("transfer") == 2
        assert runner.last_stats["n_retries"] >= 1 and not cr.failures
        np.testing.assert_array_equal(cr.metrics, oracle)

    @pytest.mark.timeout_s(120)
    def test_hung_transfer_watchdog(self, runner, oracle):
        fp = FaultPlan([FaultSpec("transfer", chunk=1, times=1, hang_s=3.0)])
        cr = _campaign(runner, faults=fp, transfer_timeout_s=0.25, **FAST)
        st = runner.last_stats
        assert st["status"] == "ok" and st["n_recovered_chunks"] == 1
        assert not cr.failures
        np.testing.assert_array_equal(cr.metrics, oracle)

    def test_nan_row_quarantined(self, runner, oracle):
        fp = FaultPlan(poison={9})
        cr = _campaign(runner, faults=fp, **FAST)
        assert np.isnan(cr.metrics[9]).all()
        assert [f.scenario for f in cr.failures] == [9]
        assert cr.failures[0].stage == "non_finite"
        ok = np.arange(48) != 9
        np.testing.assert_array_equal(cr.metrics[ok], oracle[ok])

    def test_retries_exhausted_quarantines_chunk(self, runner, oracle):
        fp = FaultPlan([FaultSpec("dispatch", chunk=0, times=-1)])
        cr = _campaign(runner, faults=fp, max_retries=1, **FAST)
        st = runner.last_stats
        assert st["status"] == "ok"
        assert cr.failures and all(f.stage == "dispatch" and f.attempts > 1
                                   for f in cr.failures)
        bad = cr.quarantined
        assert len(bad) == st["n_quarantined"] > 0
        assert np.isnan(cr.metrics[bad]).all()
        ok = np.ones(48, bool)
        ok[bad] = False
        np.testing.assert_array_equal(cr.metrics[ok], oracle[ok])

    def test_bisection_isolates_exactly_the_poisoned(self, runner, oracle):
        poisoned = {8, 10, 30}
        cr = _campaign(runner, faults=FaultPlan(poison=poisoned), **FAST)
        np.testing.assert_array_equal(cr.quarantined, sorted(poisoned))
        ok = np.ones(48, bool)
        ok[list(poisoned)] = False
        assert np.isnan(cr.metrics[~ok]).all()
        np.testing.assert_array_equal(cr.metrics[ok], oracle[ok])

    def test_finite_check_off_lets_nan_through(self, runner):
        cr = _campaign(runner, faults=FaultPlan(poison={3}),
                       finite_check=False, **FAST)
        assert np.isnan(cr.metrics[3]).all() and not cr.failures
        assert runner.last_stats["n_recovered_chunks"] == 0

    def test_recovery_column_inf_is_not_poison(self, runner):
        # +inf recovery ("never settled") passes the finite check
        cr = runner.run_campaign(_corpus()[:16], "tcp", seconds=SECONDS,
                                 chunk_rows=CHUNK, t_event=1.0)
        rec = cr.recovery_time_s
        assert not cr.failures
        assert not np.isnan(rec).any()


class TestCheckpointResume:
    def test_kill_then_resume_bitwise(self, runner, oracle, tmp_path):
        ck = str(tmp_path / "ck")
        _campaign(runner)
        n_chunks = runner.last_stats["n_chunks"]
        fp = FaultPlan([FaultSpec("abort", chunk=n_chunks - 1)])
        with pytest.raises(FaultAbort):
            _campaign(runner, faults=fp, checkpoint=ck)
        killed = runner.last_stats
        assert killed["status"] == "failed" and "FaultAbort" in killed[
            "error"]
        done = killed["n_chunks_done"]
        assert 0 < done < n_chunks
        cr = _campaign(runner, checkpoint=ck)
        st = runner.last_stats
        assert st["n_chunks_resumed"] == done
        assert st["n_dispatches"] == n_chunks - done
        np.testing.assert_array_equal(cr.metrics, oracle)

    def test_completed_campaign_resumes_with_zero_dispatches(
            self, runner, oracle, tmp_path):
        ck = str(tmp_path / "ck")
        _campaign(runner, checkpoint=ck)
        cr = _campaign(runner, checkpoint=ck)
        st = runner.last_stats
        assert st["n_dispatches"] == 0
        assert st["n_chunks_resumed"] == st["n_chunks"]
        np.testing.assert_array_equal(cr.metrics, oracle)

    def test_failures_survive_resume(self, runner, tmp_path):
        ck = str(tmp_path / "ck")
        cr1 = _campaign(runner, faults=FaultPlan(poison={5}), checkpoint=ck,
                        **FAST)
        cr2 = _campaign(runner, checkpoint=ck)
        assert runner.last_stats["n_dispatches"] == 0
        assert [f.scenario for f in cr2.failures] == [5]
        assert isinstance(cr2.failures[0], FailureRecord)
        np.testing.assert_array_equal(cr2.metrics, cr1.metrics)

    def test_fingerprint_mismatch_ignores_checkpoint(self, runner, tmp_path):
        ck = str(tmp_path / "ck")
        _campaign(runner, checkpoint=ck)
        runner.run_campaign(_corpus(), "appaware", seconds=SECONDS,
                            chunk_rows=CHUNK, checkpoint=ck)
        st = runner.last_stats
        assert st["n_chunks_resumed"] == 0
        assert st["n_dispatches"] == st["n_chunks"]
        names = os.listdir(ck)
        assert sum(n.endswith(".npy") for n in names) == 2 * st["n_chunks"]

    def test_torn_manifest_line_is_skipped(self, runner, oracle, tmp_path):
        ck = tmp_path / "ck"
        _campaign(runner, checkpoint=str(ck))
        with open(ck / "manifest.jsonl", "a") as f:
            f.write('{"fp": "torn')
        cr = _campaign(runner, checkpoint=str(ck))
        assert runner.last_stats["n_dispatches"] == 0
        np.testing.assert_array_equal(cr.metrics, oracle)

    def test_checkpoint_rejects_trajectories(self, runner, tmp_path):
        with pytest.raises(ValueError, match="retain_trajectories"):
            _campaign(runner, checkpoint=str(tmp_path / "ck"),
                      retain_trajectories=True)
        with pytest.raises(ValueError, match="max_retries"):
            _campaign(runner, max_retries=-1)


class TestTeardown:
    def test_failed_stats_and_clean_reset(self, runner, oracle):
        sentinel = {"marker": "previous run"}
        runner.last_stats = sentinel
        with pytest.raises(FaultAbort):
            _campaign(runner, faults=FaultPlan([FaultSpec("abort",
                                                          chunk=2)]))
        st = runner.last_stats
        assert st is not sentinel and st["mode"] == "campaign"
        assert st["status"] == "failed" and "FaultAbort" in st["error"]
        assert st["n_chunks_done"] < st["n_chunks"]
        assert not runner._campaign_bufs
        cr = _campaign(runner)
        assert runner.last_stats["status"] == "ok"
        assert runner.last_stats["error"] is None
        np.testing.assert_array_equal(cr.metrics, oracle)

    def test_fault_free_stats_report_ok(self, runner):
        _campaign(runner)
        st = runner.last_stats
        assert st["status"] == "ok" and st["error"] is None
        assert st["n_chunks_done"] == st["n_chunks"] == st["n_dispatches"]
        assert st["n_retries"] == 0 == st["n_quarantined"]


class TestInputValidation:
    """compile_sim and pad_sim reject poisoned fields by name."""

    @staticmethod
    def _scenario():
        return campaign_fleet(6, seed=0)[0]

    @pytest.mark.parametrize("cap", [np.nan, -5.0])
    def test_bad_capacity_rejected(self, cap):
        scn = self._scenario()
        scn.topo.links[0] = dataclasses.replace(scn.topo.links[0],
                                                capacity=cap)
        with pytest.raises(ValueError, match="capacities"):
            scn.compile(device=CPU)

    @pytest.mark.parametrize("gen", [np.nan, -1.0])
    def test_bad_demand_rejected(self, gen):
        scn = self._scenario()
        scn.graph.gen_rate[0] = gen
        with pytest.raises(ValueError, match="gen_rate"):
            scn.compile(device=CPU)

    def test_nan_proc_rate_rejected_inf_allowed(self):
        scn = self._scenario()
        scn.graph.proc_rate[0] = np.inf
        scn.compile(device=CPU)
        scn.graph.proc_rate[0] = np.nan
        with pytest.raises(ValueError, match="proc_rate"):
            scn.compile(device=CPU)

    @pytest.mark.parametrize("field", ["ev_t0", "ev_t1"])
    def test_bad_event_times_rejected(self, field):
        scn = self._scenario()
        sch = LinkSchedule.empty(scn.topo.n_links).with_event(
            0, t0=5.0, t1=np.inf, scale=0.5)
        dataclasses.replace(scn, schedule=sch).compile(device=CPU)
        for bad in (np.nan, -1.0):
            broken = dataclasses.replace(
                sch, **{field: np.array([bad], np.float32)})
            with pytest.raises(ValueError, match=field):
                dataclasses.replace(scn, schedule=broken).compile(device=CPU)

    def test_pad_sim_rejects_poisoned_compiled_fields(self):
        sims = _corpus()
        bad = sims[0].gen_rate.clone()
        bad[0] = float("inf")
        with pytest.raises(ValueError, match="gen_rate"):
            pad_sim(dataclasses.replace(sims[0], gen_rate=bad),
                    FleetShape.cover([sims[0]]))
        dyn = next(s for s in sims if s.ev_t0.shape[0])
        sc = dyn.ev_scale.clone()
        sc[0] = float("nan")
        with pytest.raises(ValueError, match="ev_scale"):
            pad_sim(dataclasses.replace(dyn, ev_scale=sc),
                    FleetShape.cover([dyn]))
