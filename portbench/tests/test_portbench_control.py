"""The check fails what it must: the control (the reference computed with
TF32 products in the program's place) and the faults the cells can have,
each driven through a whole run of the harness with the timed path broken
underneath."""
import pytest

from portbench import control, scenario
from portbench.tests import tiny

CAMPAIGNS = [c for c in tiny.CELLS if "campaign" in c]
SEED = 2**31 + 1234


def run_with(cell, broken):
    f = tiny.tiny_files(cell)
    with broken(f):
        return tiny.run_tiny(f, seed=SEED)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_is_not_correct(cell):
    r = run_with(cell, lambda f: control.reference_in_place(
        f["config"], f["traffic"], scenario.draw(f["config"], f["traffic"], SEED)))
    assert r["correct"] is False


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_tick_that_keeps_its_state_is_not_correct(cell):
    assert run_with(cell, lambda f: control.frozen_tick())["correct"] is False


@pytest.mark.parametrize("cell", CAMPAIGNS)
def test_half_a_campaign_left_out_is_not_correct(cell):
    assert run_with(cell, lambda f: control.half_batch())["correct"] is False


@pytest.mark.parametrize("cell", CAMPAIGNS)
def test_a_twelfth_of_the_rows_mixed_up_is_not_correct(cell):
    r = run_with(cell, lambda f: control.mixed_rows(every=12 if cell == tiny.CELL
                                                     else 2))
    assert r["correct"] is False and 0 < r["failed"] < r["attempted"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_an_answer_altered_where_it_is_made_is_not_correct(cell):
    assert run_with(cell, lambda f: control.altered_sink())["correct"] is False


def test_an_answer_that_is_not_a_number_prints_as_the_largest_float():
    import json
    import sys

    import numpy as np
    from repro_torch.streams import fleet

    run_campaign = fleet.FleetRunner.run_campaign

    def poisoned(self, sims, *a, **kw):
        out = run_campaign(self, sims, *a, **kw)
        out.metrics = np.full_like(out.metrics, np.nan)
        return out
    f = tiny.tiny_files(CAMPAIGNS[0])
    with control.patched(fleet.FleetRunner, "run_campaign", poisoned):
        r = tiny.run_tiny(f, seed=SEED)
    assert r["correct"] is False and r["failed"] == r["attempted"]
    assert all(v["value"] == sys.float_info.max for v in r["check"].values())
    json.loads(json.dumps(r, allow_nan=False))
