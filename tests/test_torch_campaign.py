"""The port's streaming campaign on the CPU.

``run_campaign`` streams scenarios through chunks of one padded row count
per bucket; its metric rows are bit for bit those of ``FleetRunner.run`` at
the same padded rows (on the CPU also at other chunk sizes: the rows of a
bucket are independent and the CPU's reductions do not change with the
batch). Plus the pipeline's bookkeeping (host staging bounded by three
slots, timing split, overlap fractions), ``chunk_rows="auto"`` from the
device calibration, the fingerprint knob, opt-in trajectories, and the
campaign against the JAX package's on the same scenarios (the metric
vector at the run tolerance of the parity tests, 1e-4 relative)."""
import dataclasses
import functools
import warnings

import numpy as np
import pytest

import repro.streams as J
import repro_torch.streams.fleet as pf
from _torch_parity import CPU, port_sim
from repro_torch.streams import (
    CAMPAIGN_METRICS,
    FleetRunner,
    campaign_fleet,
    compile_fleet,
    simulate,
)

SECONDS = 10.0
DT = 0.5
POLICIES = ("tcp", "appaware", "appfair", "fixed")


@pytest.fixture(autouse=True)
def _no_batching_fallback():
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield


@functools.lru_cache(maxsize=None)
def _corpus():
    """96 campaign scenarios: {TT, TI} × capacity grid × {static, in-run
    failure, in-run diurnal}, 6 distinct shapes, static and scheduled
    members interleaved."""
    sims = compile_fleet(campaign_fleet(96, seed=0), device=CPU)
    assert len({dataclasses.astuple(pf._sim_shape(s)) for s in sims}) == 6
    dyn = [s.is_dynamic for s in sims]
    assert any(dyn) and not all(dyn)
    return sims


def _x_fixed(sims):
    rng = np.random.default_rng(7)
    return [rng.uniform(0.2, 3.0, s.R.shape[0]).astype(np.float32)
            for s in sims]


def _runner(**kw):
    return FleetRunner(device=CPU, tick_overhead=15e3, **kw)


def _materialized(sims, policy, **kw):
    res = _runner().run(sims, policy, seconds=SECONDS, **kw)
    return np.stack([r.metrics for r in res])


class TestStreamingParity:
    @pytest.mark.parametrize("policy", POLICIES)
    def test_bitwise_vs_run_at_same_rows(self, policy):
        # chunks as large as the buckets: the campaign's padded rows are
        # exactly run's, and so are its metric rows, bit for bit
        sims = _corpus()
        kw = dict(x_fixed=_x_fixed(sims)) if policy == "fixed" else {}
        runner = _runner()
        cr = runner.run_campaign(sims, policy, seconds=SECONDS,
                                 chunk_rows=len(sims), **kw)
        rows = runner.last_stats["rows"]
        oracle_runner = _runner()
        oracle = np.stack([r.metrics for r in oracle_runner.run(
            sims, policy, seconds=SECONDS, **kw)])
        assert oracle_runner.last_stats["rows"] == rows
        np.testing.assert_array_equal(cr.metrics, oracle)
        assert np.isfinite(cr.metrics[:, :5]).all()
        assert cr.metrics.shape == (len(sims), len(CAMPAIGN_METRICS))

    @pytest.mark.parametrize("policy", ["tcp", "appaware"])
    def test_chunked_bitwise_on_cpu(self, policy):
        sims = _corpus()
        runner = _runner()
        cr = runner.run_campaign(sims, policy, seconds=SECONDS, chunk_rows=8)
        st = runner.last_stats
        assert st["n_chunks"] > st["n_buckets"]
        np.testing.assert_array_equal(cr.metrics,
                                      _materialized(sims, policy))

    def test_single_scenario_simulate_agrees(self):
        sims = _corpus()[:16]
        cr = _runner().run_campaign(sims, "tcp", seconds=SECONDS,
                                    chunk_rows=8)
        for i in (0, 5):
            one = simulate(sims[i], "tcp", seconds=SECONDS, device=CPU)
            np.testing.assert_allclose(cr.metrics[i], one.metrics,
                                       rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("policy", ["tcp", "appaware"])
    def test_matches_reference_campaign(self, policy):
        jsims = J.compile_fleet(J.campaign_fleet(24, seed=0))
        want = J.FleetRunner(tick_overhead=15e3).run_campaign(
            jsims, policy, seconds=SECONDS, chunk_rows=8)
        got = _runner().run_campaign([port_sim(s) for s in jsims], policy,
                                     seconds=SECONDS, chunk_rows=8)
        np.testing.assert_allclose(got.metrics, want.metrics, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(got.tuples_per_mb, want.tuples_per_mb)

    def test_corpora_match_reference(self):
        # campaign_fleet and bench_fleet: the same scenarios as the JAX
        # package's builders, field for field
        from repro_torch.streams import bench_fleet
        for mine, ref in ((campaign_fleet(30, seed=3),
                           J.campaign_fleet(30, seed=3)),
                          (bench_fleet(), J.bench_fleet())):
            assert [s.name for s in mine] == [s.name for s in ref]
            for s, r in zip(mine[::4], ref[::4]):
                ps_, rs = s.compile(device=CPU), r.compile()
                for f in ("R", "caps", "kinds", "gen_rate", "ev_t0",
                          "ev_scale", "sin_amp", "sin_phase"):
                    np.testing.assert_array_equal(
                        getattr(ps_, f).numpy(), np.asarray(getattr(rs, f)),
                        err_msg=f)

    def test_metric_accessors(self):
        cr = _runner().run_campaign(_corpus()[:16], "tcp", seconds=SECONDS,
                                    chunk_rows=8)
        np.testing.assert_array_equal(
            cr.throughput_tps, cr.metric("avg_tput_mb_s") * cr.tuples_per_mb)
        np.testing.assert_array_equal(
            cr.final_throughput_tps,
            cr.metric("final_tput_mb_s") * cr.tuples_per_mb)
        assert cr.avg_latency_s.shape == (16,)
        assert (cr.utilization >= 0).all()
        assert cr.dip_depth.shape == cr.recovery_time_s.shape == (16,)


class TestPipeline:
    def test_stats_and_bounded_staging(self):
        sims = _corpus()
        runner = _runner()
        runner.run_campaign(sims, "tcp", seconds=4.0, chunk_rows=16)
        st = dict(runner.last_stats)
        assert st["status"] == "ok" and st["n_chunks"] > st["n_buckets"]
        for key in ("stage_s", "dispatch_s", "block_s", "transfer_s",
                    "transfer_wait_s", "wall_s"):
            assert st[key] >= 0.0, key
        spent = (st["stage_s"] + st["transfer_wait_s"] + st["dispatch_s"]
                 + st["block_s"])
        assert spent <= st["wall_s"] + 1e-6
        assert 0.0 <= st["overlap_fraction"] <= 1.0
        assert 0.0 <= st["transfer_overlap"] <= 1.0
        assert st["transfer_s"] > 0.0
        assert 0 < st["peak_staged_rows"] <= 3 * st["chunk_rows"]
        assert st["peak_staged_bytes"] > 0
        assert len(st["target_chunk_rows"]) == st["n_buckets"]
        assert st["n_dispatches"] == st["n_chunks"] == st["n_chunks_done"]

    def test_single_chunk_overlap_well_defined(self):
        sims = _corpus()
        one = [s for s in sims if pf._sim_shape(s) == pf._sim_shape(
            sims[0])][:6]
        runner = _runner()
        runner.run_campaign(one, "tcp", seconds=SECONDS, chunk_rows=64)
        assert runner.last_stats["n_chunks"] == 1
        assert runner.last_stats["overlap_fraction"] == 1.0

    def test_chunk_rows_validation(self):
        sims = _corpus()
        with pytest.raises(ValueError):
            _runner().run_campaign(sims[:4], chunk_rows=0)
        with pytest.raises(ValueError):
            _runner().run_campaign(sims[:4], chunk_rows="adaptive")
        with pytest.raises(ValueError):
            _runner().run_campaign([])
        with pytest.raises(ValueError, match="x_fixed"):
            _runner().run_campaign(sims[:4], "fixed",
                                   x_fixed=_x_fixed(sims[:3]))

    def test_retain_trajectories(self):
        sims = _corpus()[:24]
        cr = _runner().run_campaign(sims, "tcp", seconds=SECONDS,
                                    chunk_rows=8, retain_trajectories=True)
        oracle = _runner().run(sims, "tcp", seconds=SECONDS)
        assert cr.results is not None and len(cr.results) == 24
        for r, o in zip(cr.results, oracle):
            np.testing.assert_array_equal(r.sink_mb, o.sink_mb)
            np.testing.assert_array_equal(r.latency, o.latency)
            np.testing.assert_array_equal(r.link_load, o.link_load)
            np.testing.assert_array_equal(r.metrics, o.metrics)
            if o.caps_t is not None:
                np.testing.assert_array_equal(r.caps_t, o.caps_t)
        assert _runner().run_campaign(sims[:8], "tcp",
                                      seconds=SECONDS).results is None

    def test_streaming_path_never_hashes(self, monkeypatch):
        def boom(sim):
            raise AssertionError("the campaign path must not content-hash")
        monkeypatch.setattr(pf, "_sim_content_sig", boom)
        cr = _runner().run_campaign(_corpus()[:32], "tcp", seconds=SECONDS,
                                    chunk_rows=16)
        assert cr.metrics.shape[0] == 32


class TestCalibration:
    def test_auto_chunk_records_calibration(self):
        sims = _corpus()[:48]
        runner = _runner()
        cr = runner.run_campaign(sims, "tcp", seconds=SECONDS,
                                 chunk_rows="auto")
        st = runner.last_stats
        assert st["auto_chunk"] is True
        cal = st["calibration"]
        assert cal["backend"] == "cpu"
        assert cal["dispatch_us"] > 0 and cal["sync_us"] > 0
        assert cal["proxy_mflops"] > 0
        lo, hi = pf._CALIB_CLAMP["cpu"]
        assert lo <= cal["tick_overhead_flops"] <= hi
        for t in st["target_chunk_rows"]:
            assert pf.AUTO_CHUNK_MIN <= t <= pf.AUTO_CHUNK_MAX
        np.testing.assert_array_equal(cr.metrics,
                                      _materialized(sims, "tcp"))

    def test_cached_per_device_type(self):
        a = pf.calibrate_backend(CPU)
        assert pf.calibrate_backend("cpu") is a
        assert FleetRunner(device=CPU).tick_overhead == a.tick_overhead_flops

    def test_fallback_constants(self, monkeypatch):
        saved = dict(pf._CALIBRATION)
        try:
            monkeypatch.setenv("REPRO_CALIBRATE", "0")
            c = pf.calibrate_backend(CPU, force=True)
            assert not c.measured and not c.clamped
            assert c.tick_overhead_flops == pf.TICK_OVERHEAD_FLOPS_CPU
            assert c.chunk_overhead_s == pytest.approx(30e-6)
        finally:
            pf._CALIBRATION.clear()
            pf._CALIBRATION.update(saved)


class TestEpilogueConsistency:
    """The device epilogue against the host-side SimResult properties (the
    tolerance contract of tests/test_campaign.py)."""

    def test_matches_host_properties(self):
        from repro_torch.streams import link_failure_sweep
        sim = link_failure_sweep(n=1, seed=3, in_run=True, t_fail=60.0,
                                 t_recover=90.0)[0].compile(device=CPU)
        r = simulate(sim, "tcp", seconds=120.0, t_event=60.0, device=CPU)
        m = r.metric
        assert m("avg_tput_mb_s") * sim.tuples_per_mb == pytest.approx(
            r.throughput_tps, rel=1e-4)
        assert m("avg_latency_s") == pytest.approx(r.avg_latency_s,
                                                   rel=1e-4)
        assert m("utilization") == pytest.approx(
            r.bottleneck_utilization(), rel=1e-4)
        assert m("dip_depth") == pytest.approx(r.dip_depth(60.0), abs=1e-3)
        assert m("total_sink_mb") == pytest.approx(float(r.sink_mb.sum()),
                                                   rel=1e-4)
        host, dev = r.recovery_time_s(60.0), m("recovery_time_s")
        assert np.isinf(dev) if np.isinf(host) else abs(dev - host) <= 2 * DT

    def test_metrics_without_epilogue_raises(self):
        from repro_torch.streams import SimResult
        r = SimResult(sink_mb=np.zeros(4), sink_mb_app=np.zeros((4, 1)),
                      latency=np.zeros(4), link_load=np.zeros((4, 2)),
                      caps=np.ones(2), kinds=np.zeros(2, int),
                      tuples_per_mb=1.0, dt=DT)
        with pytest.raises(ValueError):
            r.metric("utilization")
        assert FleetRunner(device=CPU, tick_overhead=0.0).fingerprint == \
            "content"
