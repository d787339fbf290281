"""The port's host spans (``repro_torch.tracing``) on the CPU.

The recorder off and on, the spans' parents and campaign ids (the copy
worker's ``transfer`` spans included), one ``stage``, ``dispatch`` and
``collect`` a chunk, the tick counters, ``last_stats``' seconds as the sums
of their spans, the campaign's rows the same bits with recording on and
off, and the profiler's operations inside the spans on the same clock."""
import functools
import threading

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.streams import (FleetRunner, campaign_fleet, compile_fleet,
                                 link_failure_sweep)

SECONDS, DT, UPD_EVERY = 10.0, 0.5, 10
N_TICKS = int(SECONDS / DT)
KW = dict(seconds=SECONDS, dt=DT, solver="waterfill", chunk_rows=4)
STAT_OF = {"stage": "stage_s", "transfer": "transfer_s",
           "transfer_wait": "transfer_wait_s", "dispatch": "dispatch_s",
           "collect": "block_s"}


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


def _campaign(record: bool):
    runner = _runner()
    if not record:
        return runner.run_campaign(_sims(), "appaware", **KW), runner.last_stats, None
    with tracing.recording() as rec:
        out = runner.run_campaign(_sims(), "appaware", **KW)
    return out, runner.last_stats, rec


@pytest.fixture(scope="module")
def traced():
    return _campaign(record=True)


def _named(rec, name):
    return [s for s in rec.spans if s.name == name]


def test_off_is_a_shared_no_op_and_records_nothing():
    assert tracing.span("a", tick=1) is tracing.span("b")
    assert tracing.current() is None
    with tracing.timed("stage") as t:
        pass
    assert t.ns >= 0
    _campaign(record=False)
    with tracing.recording() as rec:
        pass
    assert rec.spans == []


def test_spans_nest_under_one_campaign(traced):
    _, st, rec = traced
    (camp,) = _named(rec, "campaign")
    assert camp.parent is None and camp.campaign == camp.id
    assert {s.campaign for s in rec.spans} == {camp.id}
    by_id = {s.id: s for s in rec.spans}
    parent = {s.name: {by_id[s.parent].name for s in _named(rec, s.name)}
              for s in rec.spans if s.parent is not None}
    assert parent == {"plan": {"campaign"}, "stage": {"campaign"},
                      "pack_routes": {"stage"},
                      "transfer": {"campaign"}, "transfer_wait": {"campaign"},
                      "dispatch": {"campaign"}, "collect": {"campaign"},
                      "schedule": {"dispatch"}, "update": {"dispatch"},
                      "advance": {"dispatch"}, "epilogue": {"dispatch"},
                      "solve": {"update"}}
    # the copies run on the worker thread, on behalf of the campaign's
    workers = {s.thread for s in _named(rec, "transfer")}
    assert camp.thread not in workers
    assert {s.thread for s in rec.spans if s.name != "transfer"} == {camp.thread}
    assert camp.thread == threading.get_ident()
    for s in rec.spans:
        assert camp.start_ns <= s.start_ns <= s.end_ns <= camp.end_ns
        if s.parent is not None and s.thread == camp.thread:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
    assert tracing.paths(rec.spans)[_named(rec, "solve")[0].id] == (
        "campaign > dispatch > update > solve")


def test_one_stage_dispatch_and_collect_a_chunk(traced):
    _, st, rec = traced
    chunks = list(range(st["n_chunks"]))
    assert st["n_chunks"] == 6
    for name in ("stage", "transfer", "transfer_wait", "dispatch", "collect"):
        assert sorted(s.attrs["chunk"] for s in _named(rec, name)) == chunks
    assert len(_named(rec, "advance")) == st["n_ticks"]
    assert len(_named(rec, "update")) == st["n_updates"]
    assert len(_named(rec, "solve")) == st["n_updates"]
    assert len(_named(rec, "schedule")) == len(_named(rec, "epilogue")) == 6


@pytest.mark.parametrize("record", [False, True])
def test_tick_counters(record, traced):
    _, st, _ = traced if record else _campaign(record=False)
    n = st["n_chunks"]
    assert st["n_ticks"] == n * N_TICKS
    assert st["n_updates"] == n * -(-N_TICKS // UPD_EVERY)


def test_stats_are_the_sums_of_their_spans(traced):
    _, st, rec = traced
    for name, key in STAT_OF.items():
        ns = sum(s.end_ns - s.start_ns for s in _named(rec, name))
        assert st[key] == pytest.approx(ns * 1e-9, rel=1e-9, abs=1e-12)
    (camp,) = _named(rec, "campaign")
    assert st["wall_s"] == pytest.approx((camp.end_ns - camp.start_ns) * 1e-9,
                                         rel=1e-9)
    # the campaign's thread is inside one of its spans all through the call
    pieces = tracing.timeline(rec.spans, camp.thread)
    assert pieces[0][0] == camp.start_ns and pieces[-1][1] == camp.end_ns
    assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))


def test_rows_are_the_same_bits_on_and_off(traced):
    on, _, _ = traced
    off, _, _ = _campaign(record=False)
    np.testing.assert_array_equal(on.metrics, off.metrics)


def test_profiler_ops_fall_inside_the_spans():
    from torch.profiler import ProfilerActivity, profile

    runner = _runner()
    runner.run_campaign(_sims()[:8], "appaware", **KW)
    with tracing.recording() as rec, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        runner.run_campaign(_sims()[:8], "appaware", **KW)
    (camp,) = _named(rec, "campaign")
    starts = [int(e.start_ns()) for e in prof.profiler.kineto_results.events()
              if e.name().startswith("aten::")]
    assert len(starts) > 1000
    assert camp.start_ns <= min(starts) and max(starts) <= camp.end_ns
    # every tick's own operations start inside its advance span
    for s in _named(rec, "advance"):
        assert sum(s.start_ns <= t <= s.end_ns for t in starts) > 10


def test_compile_sim_and_route_bank_spans():
    with tracing.recording() as rec:
        compile_fleet(link_failure_sweep(n=2, reroute=True), device="cpu")
        compile_fleet(campaign_fleet(2, seed=0), device="cpu")
    names = tracing.paths(rec.spans)
    assert sorted(names.values()) == (["compile_sim"] * 4
                                      + ["compile_sim > route_bank"] * 2)


def test_timeline_cuts_a_thread_at_its_innermost_span():
    S = tracing.Span
    spans = [S("campaign", 0, 100, 1, None, 7, 1, {}),
             S("stage", 10, 20, 2, 1, 7, 1, {}),
             S("dispatch", 30, 90, 3, 1, 7, 1, {}),
             S("update", 40, 50, 4, 3, 7, 1, {}),
             S("transfer", 15, 60, 5, 1, 8, 1, {})]
    assert tracing.timeline(spans, 7) == [
        (0, 10, "campaign"), (10, 20, "campaign > stage"),
        (20, 30, "campaign"), (30, 40, "campaign > dispatch"),
        (40, 50, "campaign > dispatch > update"),
        (50, 90, "campaign > dispatch"), (90, 100, "campaign")]
    assert tracing.timeline(spans, 8) == [(15, 60, "campaign > transfer")]


def test_a_span_left_open_by_an_error_does_not_adopt_the_next():
    with tracing.recording() as rec:
        with pytest.raises(RuntimeError):
            with tracing.span("outer"):
                tracing.timed("inner").start()
                raise RuntimeError
        with tracing.span("next"):
            pass
    outer, nxt = _named(rec, "outer")[0], _named(rec, "next")[0]
    assert outer.parent is None and nxt.parent is None
    assert tracing.current() is None


def test_idle_time_is_split_by_the_innermost_span():
    pieces = [(0, 10, "campaign"), (10, 40, "campaign > dispatch > advance"),
              (40, 60, "campaign > dispatch"), (60, 80, "campaign")]
    busy = [[5, 12], [20, 30], [45, 50]]
    split = tracing.idle_by_span(busy, pieces, 0, 100)
    assert split == {"campaign": [pytest.approx(5e-9 + 20e-9), 2],
                     "campaign > dispatch > advance": [pytest.approx(18e-9), 2],
                     "campaign > dispatch": [pytest.approx(15e-9), 2],
                     "outside the spans": [pytest.approx(20e-9), 1]}
    total = sum(v[0] for v in split.values())
    assert total == pytest.approx((100 - 7 - 10 - 5) * 1e-9)
    assert tracing.idle_by_span([], [], 0, 10) == {
        "outside the spans": [pytest.approx(10e-9), 1]}
