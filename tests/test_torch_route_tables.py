"""The tick's routes in index form (``repro_torch.streams.simulator``): each
flow's link ids and each link's flow ids, read in place of the dense
[F, L] routing matrix.

Held against the dense formula the tick used before, kept here as the
oracle, on random routing matrices (flows on no link, banks of one to three
route states beside static routes, scenarios of two shapes padded into one
bucket) under ``torch.func.vmap``: the flow scale bit for bit (a minimum,
which no order changes), the link loads to 1e-6 relative (float32 sums in
another order), the transfer and queues to float32 rounding. The tables
``compile_sim`` builds from each flow's path are the ones read off its
matrices, and ``_advance`` runs with the dense matrix and bank replaced by
stand-ins that raise on any use."""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

from repro_torch.net.topology import big_switch, fat_tree, link_failure_schedule
from repro_torch.streams import (
    compile_sim,
    nexmark_q4,
    parallelize,
    round_robin,
    trending_topics,
)
from repro_torch.streams import simulator as ps
from repro_torch.streams.fleet import stack_sims

DT, QCAP = 0.5, 8.0
_EPS = 1e-9


@pytest.fixture(autouse=True)
def one_thread_no_fallback():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _bases():
    """Two scenarios of different shapes whose dataflow fields the random
    routes are laid over."""
    g = parallelize(trending_topics(), seed=0)
    a = compile_sim(g, big_switch(4, 2.0), round_robin(g, 4), device="cpu")
    g = parallelize(nexmark_q4(2, 6, 8, 5, 307.4, 942.6), seed=1)
    topo = fat_tree(2, 4, 2)
    b = compile_sim(g, topo, round_robin(g, topo.n_machines),
                    schedule=link_failure_schedule(topo, [16], 2.0, 6.0, 0.2),
                    device="cpu")
    return a, b


def _random_routes(rng, F, L):
    """A binary [F, L] routing matrix: each flow on 0 to 4 distinct links,
    about one flow in six on none."""
    R = np.zeros((F, L), np.float32)
    for f in range(F):
        k = 0 if rng.random() < 0.17 else int(rng.integers(1, min(4, L) + 1))
        R[f, rng.choice(L, k, replace=False)] = 1.0
    return R


def _random_sim(rng, base, n_states):
    """``base`` with random routes: a static sim (``n_states`` 0) or a bank
    of ``n_states`` route states over as many intervals; the route tables
    are read off the matrices."""
    F, L = base.R.shape
    fields = {f: getattr(base, f).numpy() for f in ps.DATA_FIELDS}
    fields["R"] = _random_routes(rng, F, L)
    fields["has_links"] = fields["R"].sum(1) > 0
    fields["route_bank"] = np.stack(
        [_random_routes(rng, F, L) for _ in range(n_states)]
        or [np.zeros((F, L), np.float32)])[:n_states]
    fields["route_t"] = np.arange(n_states, dtype=np.float32) * 10.0
    fields["route_state"] = np.arange(n_states, dtype=np.int32)
    return ps.sim_from_numpy(fields, tuples_per_mb=base.tuples_per_mb,
                             n_apps=base.n_apps, device="cpu")


def _bucket(seed):
    """Six random sims of both shapes, one static and the others with one
    to three route states, stacked into one padded bucket; each row's
    route state, its dense routing matrix and its route tables."""
    rng = np.random.default_rng(seed)
    bases = _bases()
    sims = [_random_sim(rng, bases[k % 2], n) for k, n in
            enumerate((0, 1, 2, 3, int(rng.integers(1, 4)), 3))]
    stacked, _ = stack_sims(sims)
    rows = torch.arange(len(sims))
    state = torch.tensor([int(rng.integers(0, max(s.route_bank.shape[0], 1)))
                          for s in sims])
    R = stacked.route_bank[rows, state]
    routes = (stacked.flow_links[rows, state].long(),
              stacked.link_flows[rows, state].long())
    return sims, stacked, R, routes


def _dense_transfer(desired, R, caps_t, enforce):
    """The dense formula the tick's capacity enforcement used: the oracle."""
    load0 = desired @ R
    lscale = torch.where(
        load0 > caps_t * DT,
        torch.clamp(caps_t * DT / torch.clamp_min(load0, _EPS), 0.0, 1.0),
        1.0)
    fscale = torch.where(R > 0, lscale[None, :], float("inf")).amin(1)
    fscale = torch.where(torch.isfinite(fscale), fscale, 1.0)
    return desired * torch.where(enforce, fscale, 1.0)


@pytest.mark.parametrize("seed", range(6))
def test_index_form_is_the_dense_formula(seed):
    sims, stacked, R, (flow_links, link_flows) = _bucket(seed)
    B, F, L = R.shape
    rng = np.random.default_rng(100 + seed)

    def t(*shape, lo=0.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, shape).astype(np.float32))

    # the per-link sums: any per-flow vector, float32 sums in another order
    v = t(B, F, hi=6.0)
    got = torch.func.vmap(ps._link_sums)(v, link_flows)
    torch.testing.assert_close(got, torch.bmm(v[:, None], R)[:, 0],
                               rtol=1e-6, atol=1e-12)
    # the per-flow minimum of link scales of at most 1, some exactly 0 or
    # 1: bit for bit, and 1.0 for a flow on no link
    lscale = t(B, L)
    lscale[:, ::3] = 1.0
    lscale[:, 1::5] = 0.0
    got = torch.func.vmap(ps._flow_mins)(lscale, flow_links)
    want = torch.where(R > 0, lscale[:, None, :], float("inf")).amin(2)
    want = torch.where(torch.isfinite(want), want, 1.0)
    assert torch.equal(got, want)
    # a whole enforced tick, some rows' enforcement gated off
    Qs, Qr = t(B, F, hi=6.0), t(B, F, hi=6.0)
    x = t(B, F, hi=30.0)                        # rates links cannot carry
    caps_t = t(B, L, lo=0.5, hi=3.0)
    enforce = torch.tensor([True, False, True, True, False, True])

    def tick(Qs, Qr, x, caps_t, enforce, routes, *fields):
        sim = dataclasses.replace(stacked, **dict(zip(ps.SIM_FIELDS, fields)))
        return ps._tick(sim, Qs, Qr, x, DT, QCAP, caps_t=caps_t,
                        enforce=enforce, routes=routes)

    fields = [getattr(stacked, f) for f in ps.SIM_FIELDS]
    gQs, gQr, gtr, _, (_, _, _, gload) = torch.func.vmap(tick)(
        Qs, Qr, x, caps_t, enforce, (flow_links, link_flows), *fields)
    desired = torch.minimum(torch.minimum(Qs, x * DT),
                            torch.clamp_min(QCAP - Qr, 0.0))
    wtr = torch.stack([_dense_transfer(desired[b], R[b], caps_t[b],
                                       enforce[b]) for b in range(B)])
    torch.testing.assert_close(gtr, wtr, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(gload, torch.bmm(gtr[:, None], R)[:, 0] / DT,
                               rtol=1e-6, atol=1e-12)
    # the queues: the processing half is the same code on both sides, so
    # the oracle feeds it the dense transfer (x·dt = transfer exactly, at
    # dt 0.5, and no capacity check)
    wQs, wQr, *_ = torch.func.vmap(
        lambda Qs, Qr, x, routes, *f: tick(Qs, Qr, x, None, False, routes,
                                           *f))(
        Qs, Qr, wtr / DT, (flow_links, link_flows), *fields)
    torch.testing.assert_close(gQs, wQs, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gQr, wQr, rtol=1e-6, atol=1e-6)
    assert (gtr < desired).any()                # enforcement bound


def _rerouting_pod(n_fail, failed_seed):
    g = parallelize(nexmark_q4(2, 6, 8, 5, 307.4, 942.6), seed=failed_seed)
    topo = fat_tree(4, 4, 4)
    rng = np.random.default_rng(failed_seed)
    internal = np.arange(32, topo.n_links)
    sched = link_failure_schedule(
        topo, sorted(rng.choice(internal, n_fail, replace=False)), 2.5, 6.5,
        0.1).with_event([int(internal[3])], 4.0, 8.0, 0.0)
    return g, topo, sched


@pytest.mark.parametrize("case", ["switch", "pod", "pod_reroute_2",
                                  "pod_reroute_5"])
def test_compiled_tables_are_read_off_the_matrices(case):
    """``compile_sim`` builds the route tables from every flow's path (base
    routes, then each route state's); they are the tables read off its
    dense routing matrix or bank, values, widths and dtype."""
    if case == "switch":
        g = parallelize(trending_topics(), seed=0)
        topo, sched, reroute = big_switch(8, 1.0), None, False
    else:
        n_fail = 0 if case == "pod" else int(case[-1])
        g, topo, sched = _rerouting_pod(max(n_fail, 1), 3)
        reroute = n_fail > 0
    sim = compile_sim(g, topo, round_robin(g, topo.n_machines),
                      schedule=sched, reroute=reroute, device="cpu")
    assert sim.is_rerouting == reroute
    if reroute:
        assert sim.route_bank.shape[0] >= 3
    n_states = int(sim.route_state.max()) + 1 if reroute else 0
    want = ps._tables_of_matrices(sim.R.numpy(),
                                  sim.route_bank.numpy()[:n_states])
    for f, w in zip(ps.ROUTE_TABLES, want):
        got = getattr(sim, f).numpy()
        assert got.dtype == w.dtype == np.int16, f
        np.testing.assert_array_equal(got, w, err_msg=f)
    assert sim.flow_links.shape[2] == (2 if case == "switch" else 4)


def test_route_tables_widen_their_ids_past_int16():
    """Ids past int16's range are stored in int32; the groups list their
    ids in ascending order, 0 after them."""
    flow = np.array([0, 39_999, 7, 39_999])
    link = np.array([2, 2, 0, 1])
    fl, lf = ps.route_tables(np.zeros(4, int), flow, link, 1, 40_000, 3)
    assert (fl.dtype, lf.dtype) == (np.int16, np.int32)
    assert lf[0].tolist() == [[8, 0], [40_000, 0], [1, 40_000]]
    assert fl[0, 39_999].tolist() == [2, 3]
    assert fl[0, 1].tolist() == [0, 0]
    with pytest.raises(ValueError, match="binary"):
        ps._tables_of_matrices(np.full((2, 3), 0.5, np.float32),
                               np.zeros((0, 2, 3), np.float32))


class _Untouchable:
    """A stand-in for a field that no tick may read: any use raises."""

    def __getattr__(self, name):
        raise AssertionError(f"the tick read .{name} of a dense field")

    def __getitem__(self, key):
        raise AssertionError("the tick indexed a dense field")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"the tick passed a dense field to {func}")


@pytest.mark.parametrize("rerouting", [False, True])
@pytest.mark.parametrize("policy", ps.POLICIES)
def test_advance_never_reads_the_dense_matrix(policy, rerouting):
    g, topo, sched = _rerouting_pod(2, 4)
    sim = compile_sim(g, topo, round_robin(g, topo.n_machines),
                      schedule=sched, reroute=rerouting, device="cpu")
    F, L = sim.R.shape
    rng = np.random.default_rng(9)
    carry = list(ps._init_carry(policy, F, sim.n_apps, "cpu"))
    for i in range(4):
        carry[i] = torch.tensor(rng.uniform(0, 6, F).astype(np.float32))
    carry = tuple(carry)
    caps_t = ps._caps_over(sim, torch.tensor([4.5]))[0]
    routes = ps._routes(sim, int(rerouting))
    blind = dataclasses.replace(sim, R=_Untouchable(),
                                route_bank=_Untouchable())
    got = ps._advance(blind, policy, carry, caps_t, routes, True, dt=DT,
                      qcap=QCAP)
    want = ps._advance(sim, policy, carry, caps_t, routes, True, dt=DT,
                       qcap=QCAP)
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    with pytest.raises(AssertionError, match="dense field"):
        blind.R.shape


def test_a_bucket_past_int16_stages_int32_tables():
    """Staged tables take the dtype that the bucket's padded flows need: a
    member padded past int16's range makes the bucket's link table int32,
    and every member's ids are copied exactly."""
    from repro_torch.streams.fleet import FleetRunner, FleetShape, pad_sim

    small, _ = _bases()
    shape = FleetShape.cover([small])
    wide = pad_sim(small, dataclasses.replace(shape, n_flows=40_000))
    bufs = FleetRunner._fill_bucket({}, [small, wide], FleetShape.cover(
        [small, wide]), 3)
    assert bufs["link_flows"].dtype == np.int32
    assert bufs["flow_links"].dtype == np.int16
    for b, sim in enumerate((small, wide)):
        for f in ps.ROUTE_TABLES:
            t = getattr(sim, f).numpy()
            np.testing.assert_array_equal(
                bufs[f][b][:t.shape[0], :t.shape[1], :t.shape[2]], t)
    assert not bufs["link_flows"][2].any()
