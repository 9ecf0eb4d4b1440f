"""The port's ``engine/server.py`` against the JAX package's.

The same requests go to ``repro``'s ``Server`` and the port's, over the
same hierarchy and budget (numpy pages made from the same seeds): ledgers,
latencies, waits and makespans must agree exactly, and each must show the
invariants ``tests/test_serving.py`` pins (single-tenant parity with a
standalone Session, ``slots`` bounding concurrency, ``fifo`` serializing).
``SlotLoop``, the slot discipline the LM ``ServeEngine`` runs on, is held
to the JAX one call for call.
"""

import pytest

from repro.core import TABLE_I as JAX_TABLE_I
from repro.engine import QueryRequest as JaxQueryRequest, Server as JaxServer
from repro.engine import Session as JaxSession, WorkloadStats as JaxWorkloadStats
from repro.engine.registry import hierarchy_spec as jax_hierarchy_spec
from repro.engine.server import SlotLoop as JaxSlotLoop
from repro.remote import make_relation as jax_make_relation
from repro.remote.simulator import make_key_pages as jax_make_key_pages

import repro_torch.engine as port_engine
from repro_torch.core import TABLE_I
from repro_torch.engine import QueryRequest, Server, Session, SlotLoop, WorkloadStats
from repro_torch.engine.registry import hierarchy_spec
from repro_torch.remote import make_relation
from repro_torch.remote.simulator import make_key_pages

ROWS = 8
BUDGET = 96.0
SIDES = {
    "jax": dict(tables=JAX_TABLE_I, spec=jax_hierarchy_spec, server=JaxServer,
                request=JaxQueryRequest, session=JaxSession, stats=JaxWorkloadStats,
                key_pages=jax_make_key_pages, relation=jax_make_relation),
    "port": dict(tables=TABLE_I, spec=hierarchy_spec, server=Server, request=QueryRequest,
                 session=Session, stats=WorkloadStats, key_pages=make_key_pages,
                 relation=make_relation),
}


def _hspec(side):
    t, spec = SIDES[side]["tables"], SIDES[side]["spec"]
    return spec((t["dram"], 48), (t["rdma"], 512), t["ssd"])


def _sort_tasks_of(side, pages=96, seed=3):
    mod = SIDES[side]

    def tasks_of(sess):
        ids = mod["key_pages"](sess.remote, pages, ROWS, seed=seed)
        return [sess.task("ems", mod["stats"](size_r=pages, k_cap=8),
                          inputs={"page_ids": ids}, rows_per_page=ROWS)]
    return tasks_of


def _pipeline_tasks_of(side, seed=11):
    mod = SIDES[side]

    def tasks_of(sess):
        ids = mod["key_pages"](sess.remote, 96, ROWS, seed=seed)
        build = mod["relation"](sess.remote, 48 * ROWS, ROWS, 96, seed=seed + 1)
        probe = mod["relation"](sess.remote, 96 * ROWS, ROWS, 96, seed=seed + 2)
        return [
            sess.task("ems", mod["stats"](size_r=96, k_cap=8),
                      inputs={"page_ids": ids}, rows_per_page=ROWS),
            sess.task("ehj", mod["stats"](size_r=48, size_s=96, out=36, partitions=8,
                                          sigma=0.5),
                      inputs={"build": build, "probe": probe}),
        ]
    return tasks_of


def _serve(side, requests, **server_kw):
    """requests: (rid, tasks_of factory, kwargs) -> the side's ServerReport."""
    mod = SIDES[side]
    srv = mod["server"](_hspec(side), budget=BUDGET, **server_kw)
    srv.submit([mod["request"](rid=rid, tasks_of=make(side), **kw)
                for rid, make, kw in requests])
    return srv.run()


def _same_reports(jrep, rep):
    assert [q.rid for q in rep.queries] == [q.rid for q in jrep.queries]
    for jq, q in zip(jrep.queries, rep.queries):
        assert q.ledger.to_dict() == jq.ledger.to_dict()
        assert (q.arrival, q.admitted, q.finished, q.wait, q.latency) == (
            jq.arrival, jq.admitted, jq.finished, jq.wait, jq.latency)
    assert rep.makespan == jrep.makespan
    assert rep.total.to_dict() == jrep.total.to_dict()


def test_engine_exports_the_serving_surface():
    for name in ("Server", "QueryRequest", "QueryReport", "ServerReport",
                 "PreemptionEvent", "SlotLoop"):
        assert name in port_engine.__all__
        assert getattr(port_engine, name).__module__ == "repro_torch.engine.server"


def test_single_tenant_parity_ledger_and_latency():
    reps = {}
    for side in SIDES:
        mod = SIDES[side]
        sess = mod["session"](_hspec(side), budget=BUDGET, eviction="lru")
        res = sess.run(_pipeline_tasks_of(side)(sess), replan="measured")
        rep = _serve(side, [(7, _pipeline_tasks_of, dict(label="solo"))], slots=4)
        q = rep.query(7)
        for name in _hspec(side).names:
            assert res.total.tier(name) == q.ledger.tier(name), name
        assert q.latency == pytest.approx(res.latency_seconds(), rel=1e-12)
        assert q.wait == 0.0
        reps[side] = rep
    _same_reports(reps["jax"], reps["port"])


@pytest.mark.parametrize("mode,slots", [("arbitrated", 1), ("fifo", 8), ("even", 2),
                                        ("arbitrated", 3)])
def test_queueing_matches_jax(mode, slots):
    requests = [(0, lambda s: _sort_tasks_of(s, seed=41), dict()),
                (1, lambda s: _sort_tasks_of(s, seed=42), dict(arrival=0.001)),
                (2, lambda s: _pipeline_tasks_of(s, seed=43),
                 dict(arrival=0.002, priority=4.0))]
    reps = {side: _serve(side, requests, mode=mode, slots=slots) for side in SIDES}
    _same_reports(reps["jax"], reps["port"])
    rep = reps["port"]
    iv = {q.rid: (q.admitted, q.finished) for q in rep.queries}
    if mode == "fifo" or slots == 1:
        # One at a time: each admission waits for the previous finish.
        order = sorted(iv, key=lambda r: iv[r][0])
        for a, b in zip(order, order[1:]):
            assert iv[b][0] >= iv[a][1] - 1e-12
        assert max(q.wait for q in rep.queries) > 0.0


@pytest.mark.parametrize("slots", [1, 2, 3, 5])
def test_slot_loop_discipline_matches_jax(slots):
    """At most ``slots`` active, FIFO refill, one quantum per active item per
    round, a finished item's slot goes to the queue head at once."""
    quanta = {0: 3, 1: 1, 2: 4, 3: 2, 4: 1, 5: 2}
    logs = {}
    for name, loop in (("jax", JaxSlotLoop), ("port", SlotLoop)):
        log, active = [], set()

        def start(item, log=log, active=active):
            active.add(item)
            assert len(active) <= slots
            log.append(("start", item))
            return {"left": quanta[item]}

        def step(item, state, log=log, active=active):
            log.append(("step", item))
            state["left"] -= 1
            if state["left"] == 0:
                active.discard(item)
                return True
            return False

        finished = loop(slots, start, step).run(list(quanta))
        logs[name] = (log, finished)
    assert logs["port"] == logs["jax"]
    log, finished = logs["port"]
    assert [e for e in log if e[0] == "start"] == [("start", i) for i in quanta]
    assert sorted(finished) == sorted(quanta)
    assert sum(e[0] == "step" for e in log) == sum(quanta.values())
    with pytest.raises(ValueError, match="slots must be >= 1"):
        SlotLoop(0, start, step)
