"""The harness's arithmetic on synthetic timings and traces, and whole runs
of each cell cut to a tiny size on the CPU: the window, the check against
the reference, and the traced run's per-layer metrics."""
import json

import pytest

from portbench import run
from portbench.tests import tiny


def test_rates_are_whole_jobs_over_their_whole_time():
    spans = [(10.0, 12.0), (12.5, 14.5), (14.5, 17.0)]   # a gap between jobs
    r = run.rates(spans, [32, 32, 30], 120.0)
    assert r["wall_s"] == pytest.approx(7.0)
    assert r["scenarios_per_s"] == pytest.approx(94 / 7.0)
    assert r["sim_s_per_s"] == pytest.approx(94 * 120.0 / 7.0)


def test_busy_time_is_the_union_per_device_averaged():
    ev = [("a", 0, 10, 0), ("b", 5, 10, 0), ("c", 30, 5, 0),   # 0..15, 30..35
          ("d", 0, 40, 1)]
    assert run.busy_intervals(ev[:3]) == [[0, 15], [30, 35]]
    assert run.busy_s(ev, 2) == pytest.approx((20 + 40) / 2 * 1e-9)
    assert run.busy_s(ev[:3], 4) == pytest.approx(20 / 4 * 1e-9)


def test_idle_gaps_are_named_by_phase():
    busy = [[10, 20], [30, 40]]
    phases = [("job", 0, 50), ("collect", 50, 60)]
    gaps = dict(run.idle_gaps(busy, phases, 0, 60))
    assert gaps == {
        "job: host before its first device op: 1 gaps, longest 0.000000 s": 10e-9,
        "job: host between device ops: 1 gaps, longest 0.000000 s": 10e-9,
        "job: host after its last device op: 1 gaps, longest 0.000000 s": 10e-9,
        "collect: 1 gaps, longest 0.000000 s": 10e-9}


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_tiny_run_is_correct(cell):
    r = tiny.run_tiny(tiny.tiny_files(cell))
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    wanted = {m["name"] for m in tiny.bench()["end_to_end"]
              if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == wanted
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "check"
    json.dumps(r)


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", tiny.CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
