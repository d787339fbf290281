"""Whole-run behaviour of the port's simulator: the golden transients of the
reference's mid-run 4-link failure (tests/test_dynamics.py, same bands:
±0.05 on the dip depth, ±3 s on the recovery time) and the paper's core
result on the single-hop demo grid (examples/stream_allocator_demo.py):
appaware beats tcp in every cell, with either appaware solver."""
import pytest

from repro_torch.net import big_switch, link_failure_schedule
from repro_torch.streams import (
    compile_sim,
    parallelize,
    round_robin,
    simulate,
    trending_topics,
    trucking_iot,
)
from test_dynamics import TestTransientCalibration as Golden

CPU = "cpu"


@pytest.mark.parametrize("policy", ["tcp", "appaware"])
@pytest.mark.parametrize("mk", [trending_topics, trucking_iot])
def test_transients_match_golden(mk, policy):
    topo = big_switch(8, 1.25)
    sched = link_failure_schedule(topo, [0, 1, 2, 3], Golden.T_FAIL,
                                  Golden.T_REC, degrade=0.1)
    g = parallelize(mk(), seed=0)
    sim = compile_sim(g, topo, round_robin(g, 8), schedule=sched, device=CPU)
    r = simulate(sim, policy, seconds=120.0, dt=0.5, device=CPU)
    dip, rec = r.dip_depth(Golden.T_FAIL), r.recovery_time_s(Golden.T_FAIL)
    g_dip, g_rec = Golden.GOLDEN[(mk.__name__, policy)]
    assert abs(dip - g_dip) <= Golden.DIP_BAND, (dip, g_dip)
    assert abs(rec - g_rec) <= Golden.REC_BAND_S, (rec, g_rec)
    # the in-program epilogue agrees with the host-side definitions
    r2 = simulate(sim, policy, seconds=120.0, dt=0.5, device=CPU,
                  t_event=Golden.T_FAIL)
    assert abs(r2.metric("dip_depth") - dip) <= 1e-4
    assert abs(r2.metric("recovery_time_s") - rec) <= 1e-4


@pytest.mark.parametrize("cap", [1.25, 1.875, 2.5])
@pytest.mark.parametrize("mk", [trending_topics, trucking_iot])
def test_appaware_beats_tcp_on_demo_grid(mk, cap):
    g = parallelize(mk(), seed=0)
    sim = compile_sim(g, big_switch(8, cap), round_robin(g, 8), device=CPU)
    tcp = simulate(sim, "tcp", seconds=600.0, device=CPU)
    for solver in ("sort", "waterfill"):
        aa = simulate(sim, "appaware", seconds=600.0, solver=solver,
                      device=CPU)
        assert aa.throughput_tps > tcp.throughput_tps, (solver, cap)
    assert tcp.n_order_rebuilds >= 1
