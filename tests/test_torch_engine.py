"""The port's spill engine against the JAX package's: same plans, same ledgers.

The host-side modules are copies of ``repro``'s with their imports renamed,
so every closed form, plan, generated page and ledger must come out equal.
These tests hold them to that on small workloads, and run the whole slice —
a four-operator ``Session`` on the port's torch backend (``device="cpu"``)
— against ``repro``'s simulator.
"""

import dataclasses

import numpy as np
import pytest

import repro.engine as jax_engine
from repro.core import TABLE_I as JAX_TABLE_I
from repro.engine import registry as jax_registry
from repro.remote import simulator as jax_sim

import repro_torch.engine as engine
from repro_torch.core import TABLE_I
from repro_torch.engine import registry
from repro_torch.remote import make_backend, simulator as sim

OPS = ["bnlj", "ems", "ehj", "eagg"]
STATS = {
    "bnlj": dict(size_r=24, size_s=48, out=12, selectivity=1 / 2048),
    "ems": dict(size_r=96, k_cap=8),
    "ehj": dict(size_r=48, size_s=96, out=36, partitions=8, sigma=0.5),
    "eagg": dict(size_r=64, out=12, partitions=8, sigma=0.5),
}
BUDGETS = [2.0, 3.0, 5.0, 8.0, 16.0, 64.0]
ROWS = 8
LEVELS = (("dram", 48), ("rdma", 512), "ssd")


def _same_or_both_raise(fn_a, fn_b):
    try:
        a = fn_a()
    except ValueError as exc_a:
        with pytest.raises(ValueError) as exc_b:
            fn_b()
        assert str(exc_a) == str(exc_b.value)
        return None
    b = fn_b()
    return a, b


@pytest.mark.parametrize("op", OPS)
def test_plans_and_closed_forms_equal_jax_package(op):
    assert set(TABLE_I) == set(JAX_TABLE_I)
    policies = registry.get(op).policies
    assert policies == jax_registry.get(op).policies
    stats = registry.WorkloadStats(**STATS[op])
    jstats = jax_registry.WorkloadStats(**STATS[op])
    compared = 0
    for tier in sorted(TABLE_I):
        assert dataclasses.asdict(TABLE_I[tier]) == dataclasses.asdict(JAX_TABLE_I[tier])
        for m in BUDGETS:
            for policy in policies:
                for fn in ("plan_operator", "model_costs", "model_latency"):
                    pair = _same_or_both_raise(
                        lambda: getattr(jax_registry, fn)(op, jstats, tier, m, policy),
                        lambda: getattr(registry, fn)(op, stats, tier, m, policy),
                    )
                    if pair is None:
                        continue
                    want, got = pair
                    if fn == "plan_operator":
                        assert type(want).__name__ == type(got).__name__
                        want, got = dataclasses.asdict(want), dataclasses.asdict(got)
                    assert want == got, (op, tier, m, policy, fn)
                    compared += 1
    assert compared > 0


def test_generators_make_byte_identical_pages():
    for seed in (0, 4, 9):
        a = jax_sim.RemoteMemory(JAX_TABLE_I["tcp"])
        b = sim.RemoteMemory(TABLE_I["tcp"])
        ra = jax_sim.make_relation(a, 100, 16, 50, payload_width=2, seed=seed)
        rb = sim.make_relation(b, 100, 16, 50, payload_width=2, seed=seed)
        assert (ra.page_ids, ra.rows_per_page, ra.total_rows) == \
            (rb.page_ids, rb.rows_per_page, rb.total_rows)
        ka = jax_sim.make_key_pages(a, 7, 32, key_domain=1000, seed=seed)
        kb = sim.make_key_pages(b, 7, 32, key_domain=1000, seed=seed)
        assert ka == kb
        for pa, pb in zip(a.peek_batch(ra.page_ids + ka), b.peek_batch(rb.page_ids + kb)):
            assert pa.dtype == pb.dtype and pa.shape == pb.shape
            assert pa.tobytes() == pb.tobytes()


def test_load_pages_carries_ids_and_placement():
    jax_h = jax_sim.make_hierarchy(*LEVELS)
    rel = jax_sim.make_relation(jax_h, 40 * ROWS, ROWS, 64, seed=2, tier="rdma")
    keys = jax_sim.make_key_pages(jax_h, 12, ROWS, seed=3)
    ours = sim.make_hierarchy(*LEVELS)
    got_rel = sim.load_pages(ours, jax_h.peek_batch(rel.page_ids), tier="rdma")
    got_keys = sim.load_pages(ours, jax_h.peek_batch(keys))
    assert got_rel == rel.page_ids and got_keys == keys
    for i in rel.page_ids + keys:
        assert ours.tier_of(i) == jax_h.tier_of(i)
        assert ours.peek_batch([i])[0].tobytes() == jax_h.peek_batch([i])[0].tobytes()


def _four_op_tasks(sess, stats_cls, make_relation, make_key_pages):
    r = make_relation(sess.remote, 24 * ROWS, ROWS, 2048, seed=1)
    s = make_relation(sess.remote, 48 * ROWS, ROWS, 2048, seed=2)
    ids = make_key_pages(sess.remote, 96, ROWS, seed=3)
    build = make_relation(sess.remote, 48 * ROWS, ROWS, 96, seed=4)
    probe = make_relation(sess.remote, 96 * ROWS, ROWS, 96, seed=5)
    agg = make_relation(sess.remote, 64 * ROWS, ROWS, 128, seed=6)
    inputs = [{"outer": r, "inner": s}, {"page_ids": ids},
              {"build": build, "probe": probe}, {"rel": agg}]
    tasks = [
        sess.task(op, stats_cls(**STATS[op]), inputs=inp,
                  **({"rows_per_page": ROWS} if op == "ems" else {}))
        for op, inp in zip(OPS, inputs)
    ]
    return tasks, inputs


def _assert_oracles(remote, res, inputs):
    """Each operator's output is its oracle's answer."""
    bnlj, ems, ehj, eagg = (tr.result for tr in res.per_task)
    got = np.concatenate(remote.peek_batch(bnlj.output_page_ids), axis=0)
    got = got[np.lexsort((got[:, 2], got[:, 1], got[:, 0]))]
    np.testing.assert_array_equal(got, registry.get("bnlj").oracle(remote, *inputs[0].values()))
    got = np.concatenate([p.ravel() for p in remote.peek_batch(ems.run_page_ids)])
    np.testing.assert_array_equal(got, registry.get("ems").oracle(remote, *inputs[1].values()))
    assert ehj.output_rows == registry.get("ehj").oracle(remote, *inputs[2].values())
    got = np.concatenate(remote.peek_batch(eagg.output_page_ids), axis=0)
    got = got[np.argsort(got[:, 0], kind="stable")]
    np.testing.assert_array_equal(got, registry.get("eagg").oracle(remote, *inputs[3].values()))


def _misestimated_tasks(sess, stats_cls, make_relation, make_key_pages):
    """EHJ whose output estimate is ~8x low feeding EMS, then EAGG."""
    build = make_relation(sess.remote, 48 * ROWS, ROWS, 48, seed=30)
    probe = make_relation(sess.remote, 96 * ROWS, ROWS, 48, seed=32)
    agg = make_relation(sess.remote, 96 * ROWS, ROWS, 128, seed=34)
    join = sess.task("ehj", stats_cls(size_r=48, size_s=96, out=6, partitions=8,
                                      sigma=0.5),
                     inputs={"build": build, "probe": probe})
    sort = sess.task("ems", stats_cls(size_r=6, k_cap=8),
                     inputs={"page_ids": join.output}, rows_per_page=ROWS)
    aggt = sess.task("eagg", stats_cls(size_r=96, out=16, partitions=8, sigma=0.5),
                     inputs={"rel": agg})
    return [join, sort, aggt]


def _outputs(sess, res):
    out = []
    for task_run in res.per_task:
        spec = registry.get(task_run.op)
        out.append([p.tobytes() for p in sess.remote.peek_batch(spec.output_of(task_run.result))])
    return out


def _summary(res):
    return ([dataclasses.asdict(tr.delta) for tr in res.per_task],
            dataclasses.asdict(res.total),
            [tr.m_pages for tr in res.per_task])


def test_replan_measured_with_lru_eviction_matches_jax_package():
    """Fires the session's lazy imports: the evictor, make_policy, the
    pipeline planner and re-planning on a 3-tier hierarchy."""
    jsess = jax_engine.Session(jax_sim.make_hierarchy(*LEVELS), budget=64.0,
                               eviction="lru")
    jres = jsess.run(_misestimated_tasks(jsess, jax_registry.WorkloadStats,
                                         jax_sim.make_relation, jax_sim.make_key_pages),
                     replan="measured")
    sess = engine.Session(sim.make_hierarchy(*LEVELS), budget=64.0, eviction="lru")
    res = sess.run(_misestimated_tasks(sess, registry.WorkloadStats,
                                       sim.make_relation, sim.make_key_pages),
                   replan="measured")
    assert jres.replan_events and len(res.replan_events) == len(jres.replan_events)
    assert _summary(res) == _summary(jres)
    assert res.latency_seconds() == jres.latency_seconds()
    assert _outputs(sess, res) == _outputs(jsess, jres)


def test_four_operator_session_on_torch_backend_matches_jax_simulator():
    """The slice as a whole: BNLJ, EMS, EHJ and EAGG through the port's
    backend hooks give the JAX package's ledgers and output bytes."""
    jsess = jax_engine.Session(jax_sim.make_hierarchy(*LEVELS), budget=48.0)
    jtasks, _ = _four_op_tasks(jsess, jax_registry.WorkloadStats,
                               jax_sim.make_relation, jax_sim.make_key_pages)
    jres = jsess.run(jtasks)
    backend = make_backend(*LEVELS, device="cpu")
    sess = engine.Session(backend, budget=48.0)
    tasks, inputs = _four_op_tasks(sess, registry.WorkloadStats,
                                   sim.make_relation, sim.make_key_pages)
    res = sess.run(tasks)
    assert _summary(res) == _summary(jres)
    assert _outputs(sess, res) == _outputs(jsess, jres)
    _assert_oracles(backend, res, inputs)
    assert backend.wall.kernel_calls > 0
    assert backend.wall.kernel_fallbacks == 0
    assert backend.wall.host_pinned_pages == 0


def test_engine_exports_only_the_slice():
    # The serving surface came with slice 2, SlotLoop exported beside it for
    # the LM ServeEngine; engine/plan.py came with slice 10 and, as in repro,
    # is imported as engine.plan, not re-exported by engine.
    import repro.engine.plan as jax_plan
    import repro_torch.engine.plan as plan

    assert set(engine.__all__) <= set(jax_engine.__all__) | {"SlotLoop"}
    assert {"Session", "TransferScheduler", "plan_operator", "Evictor",
            "Server", "QueryRequest", "SlotLoop"} <= set(engine.__all__)
    assert not {"plan", "LogicalPlan", "compile_plan"} & set(jax_engine.__all__)
    assert not {"plan", "LogicalPlan", "compile_plan"} & set(engine.__all__)
    assert ({n for n in dir(plan) if not n.startswith("_")}
            == {n for n in dir(jax_plan) if not n.startswith("_")})
    assert {"LogicalPlan", "compile_plan", "CompiledPlan", "JoinChoice", "Node"} <= set(dir(plan))
