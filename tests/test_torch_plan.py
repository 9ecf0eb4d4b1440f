"""The port's logical-plan frontend against the JAX package's: same DAGs.

``repro_torch.engine.plan`` is ``repro.engine.plan`` with its two imports
renamed, so every compiled DAG, join choice, filter disposition, ``explain``
report, ledger and output page must come out equal.  The cases are those of
``tests/test_plan_frontend.py`` and ``tests/test_pushdown.py`` that go
through ``compile_plan``, plus ``compile_plan`` DAGs under the DAG
scheduler's schedules and re-planning (``tests/test_plan_dag.py`` drives the
scheduler with hand-wired tasks), each built once on either package from the
same seeds.  A Q3- and a Q18-shaped plan also run on the port's torch backend
(``make_backend(..., device="cpu")``) against ``repro``'s simulator.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

import repro.core as jax_core
import repro.core.cost_model as jax_cost_model
import repro.engine as jax_engine
import repro.engine.plan as jax_plan
import repro.remote as jax_remote
import repro.remote.simulator as jax_sim
from repro.remote.backend import make_backend as jax_make_backend

import repro_torch.core as core
import repro_torch.core.cost_model as cost_model
import repro_torch.engine as engine
import repro_torch.engine.plan as plan
import repro_torch.remote as remote
from repro_torch.remote import make_backend

ROOT = Path(__file__).resolve().parents[1]
ROWS = 8
DOMAIN = 64
FAST, SLOW = 200_000.0, 2_000.0
LEVELS = (("dram", 64), ("rdma", 512), "ssd")


def _pkg(core_mod, cost, eng, plan_mod, rem):
    return types.SimpleNamespace(
        TABLE_I=core_mod.TABLE_I, TierLevel=cost.TierLevel, hierarchy_spec=cost.hierarchy_spec,
        Session=eng.Session, WorkloadStats=eng.WorkloadStats, LogicalPlan=plan_mod.LogicalPlan,
        compile_plan=plan_mod.compile_plan, make_relation=rem.make_relation, registry=eng.registry)


JAX = _pkg(jax_core, jax_cost_model, jax_engine, jax_plan, jax_remote)
PORT = _pkg(core, cost_model, engine, plan, remote)


def _hier(pkg, dram=64):
    t = pkg.TABLE_I
    return pkg.hierarchy_spec((t["dram"], dram), (t["rdma"], 512), t["ssd"])


# -- plans, each buildable on either package -----------------------------------------


def _q3ish(pkg, sess):
    """lineitem |><| orders |><| customer -> group-by -> order-by."""
    li = pkg.make_relation(sess.remote, 48 * ROWS, ROWS, 96, seed=21)
    o = pkg.make_relation(sess.remote, 24 * ROWS, ROWS, 96, seed=22)
    c = pkg.make_relation(sess.remote, 12 * ROWS, ROWS, 96, seed=23)
    lp = pkg.LogicalPlan("q3")
    l_n = lp.scan("lineitem", li, rows_per_page=ROWS)
    o_n = lp.scan("orders", o, rows_per_page=ROWS)
    c_n = lp.filter(lp.scan("customer", c, rows_per_page=ROWS), 0.5)
    j = lp.join(lp.join(l_n, o_n, out_pages=48.0), c_n, out_pages=48.0,
                sigma=0.5, partitions=8)
    lp.sort(lp.aggregate(j, out_pages=12.0, sigma=0.5, partitions=8), k_cap=8)
    return lp


def _q18ish(pkg, sess):
    """join(customer |><| orders, agg(lineitem)): two independent subtrees."""
    c = pkg.make_relation(sess.remote, 12 * ROWS, ROWS, 96, seed=41)
    o = pkg.make_relation(sess.remote, 24 * ROWS, ROWS, 96, seed=42)
    li = pkg.make_relation(sess.remote, 48 * ROWS, ROWS, 96, seed=43)
    lp = pkg.LogicalPlan("q18")
    agg = lp.aggregate(lp.scan("lineitem", li, rows_per_page=ROWS),
                       out_pages=12.0, sigma=0.5, partitions=8)
    j = lp.join(lp.join(lp.scan("customer", c, rows_per_page=ROWS),
                        lp.scan("orders", o, rows_per_page=ROWS), out_pages=24.0),
                agg, out_pages=24.0, sigma=0.5, partitions=8)
    lp.sort(j, k_cap=8)
    return lp


def _chain(pkg, sess):
    lp = pkg.LogicalPlan("q")
    l_n = lp.scan("l", pkg.make_relation(sess.remote, 24 * ROWS, ROWS, 64, seed=31),
                  rows_per_page=ROWS)
    r_n = lp.scan("r", pkg.make_relation(sess.remote, 12 * ROWS, ROWS, 64, seed=32),
                  rows_per_page=ROWS)
    lp.sort(lp.join(l_n, r_n, out_pages=24.0, sigma=0.5, partitions=8), k_cap=8)
    return lp


def _two_leaf_placed(pkg, sess):
    lp = pkg.LogicalPlan("q")
    a = lp.scan("a", pkg.make_relation(sess.remote, 12 * ROWS, ROWS, 64, seed=81),
                rows_per_page=ROWS)
    b = lp.scan("b", pkg.make_relation(sess.remote, 24 * ROWS, ROWS, 64, seed=82),
                rows_per_page=ROWS)
    lp.join(a, b, out_pages=24.0, sigma=0.5, partitions=8, placement={"build": "dram"})
    return lp


def _pushdown_session(pkg, pps, budget=24.0):
    t = pkg.TABLE_I
    rdma = pkg.TierLevel(tier=t["rdma"], capacity_pages=4096.0, compute_pps=pps,
                         pushdown_ops=("filter", "reduce") if pps else ())
    return pkg.Session(pkg.hierarchy_spec((t["dram"], 4.0), rdma), budget=budget)


def _pushdown(pkg, sess, predicate=False, **join_opts):
    r = pkg.make_relation(sess.remote, 30 * ROWS, ROWS, DOMAIN, seed=11, tier="rdma")
    s = pkg.make_relation(sess.remote, 50 * ROWS, ROWS, DOMAIN, seed=12, tier="rdma")
    lp = pkg.LogicalPlan("pd")
    r_n = lp.scan("R", r, rows_per_page=ROWS)
    pred = (lambda page: page[0, 0] % 2 == 0) if predicate else None
    s_n = lp.filter(lp.scan("S", s, rows_per_page=ROWS), 0.4, name="sel_s", predicate=pred)
    lp.join(r_n, s_n, out_pages=20.0, name="J", selectivity=0.4, **join_opts)
    return lp


def _three_leaf(pkg, sess):
    a, b, c = (pkg.make_relation(sess.remote, n * ROWS, ROWS, DOMAIN, seed=seed, tier="rdma")
               for n, seed in ((10, 41), (20, 42), (40, 43)))
    lp = pkg.LogicalPlan("q3")
    a_n = lp.scan("A", a, rows_per_page=ROWS)
    b_n = lp.scan("B", b, rows_per_page=ROWS)
    c_n = lp.filter(lp.scan("C", c, rows_per_page=ROWS), 0.3, name="fc")
    j1 = lp.join(a_n, b_n, out_pages=8.0, selectivity=0.4)
    lp.join(j1, c_n, out_pages=12.0, name="top", selectivity=0.4)
    return lp


# (session maker, plan constructor, compile_plan keywords, run keywords)
CASES = {
    "q3": (lambda pkg: pkg.Session(_hier(pkg), budget=64), _q3ish, {}, {}),
    "q3_as_written": (lambda pkg: pkg.Session(_hier(pkg), budget=64), _q3ish,
                      {"optimize": False}, {}),
    "q3_replan_measured": (lambda pkg: pkg.Session(_hier(pkg), budget=64), _q3ish, {},
                           {"replan": "measured"}),
    "q18": (lambda pkg: pkg.Session(_hier(pkg), budget=64), _q18ish, {}, {}),
    "q18_as_written_serial": (lambda pkg: pkg.Session(_hier(pkg), budget=64), _q18ish,
                              {"optimize": False}, {"schedule": "serial"}),
    "q18_lru": (lambda pkg: pkg.Session(_hier(pkg, dram=16), budget=24, eviction="lru"),
                _q18ish, {"prefetch": True}, {"replan": "measured"}),
    "chain_serial": (lambda pkg: pkg.Session(_hier(pkg), budget=64), _chain,
                     {"optimize": False}, {"schedule": "serial"}),
    "chain_single_tier": (lambda pkg: pkg.Session(pkg.TABLE_I["tcp"], budget=64), _chain,
                          {}, {}),
    "two_leaf_placed": (lambda pkg: pkg.Session(_hier(pkg), budget=64), _two_leaf_placed,
                        {}, {}),
    "pushdown_fast": (lambda pkg: _pushdown_session(pkg, FAST), _pushdown,
                      {"join_op": "bnlj"}, {}),
    "pushdown_slow": (lambda pkg: _pushdown_session(pkg, SLOW), _pushdown,
                      {"join_op": "bnlj"}, {}),
    "pushdown_incapable": (lambda pkg: _pushdown_session(pkg, None), _pushdown,
                           {"join_op": "bnlj"}, {}),
    "pushdown_predicate": (lambda pkg: _pushdown_session(pkg, FAST),
                           lambda pkg, sess: _pushdown(pkg, sess, predicate=True),
                           {"join_op": "bnlj"}, {}),
    "pushdown_overridden": (lambda pkg: _pushdown_session(pkg, FAST),
                            lambda pkg, sess: _pushdown(pkg, sess, pushdown=False),
                            {"join_op": "bnlj"}, {}),
    "three_leaf_bnlj": (lambda pkg: _pushdown_session(pkg, FAST), _three_leaf,
                        {"join_op": "bnlj"}, {}),
    "ehj_annotations": (lambda pkg: _pushdown_session(pkg, FAST), _pushdown,
                        {"join_op": "ehj"}, {}),
}


# -- what is compared ------------------------------------------------------------------


def _value(v):
    """A task option or input as comparable data: callables by presence."""
    if callable(v):
        return "<callable>"
    if isinstance(v, dict):
        return {k: _value(x) for k, x in sorted(v.items())}
    if hasattr(v, "page_ids"):
        return ("relation", list(v.page_ids), v.rows_per_page, v.total_rows)
    return v


def _dag(cp):
    index = {id(t): i for i, t in enumerate(cp.tasks)}

    def wire(v):
        task = getattr(v, "task", None)
        return ("task", index[id(task)]) if task is not None else _value(v)

    return [(t.op, t.label, dataclasses.asdict(t.stats),
             {k: wire(v) for k, v in sorted(t.inputs.items())},
             _value(dict(t.options)), _value(t.placement))
            for t in cp.tasks]


def _compiled(cp):
    return (_dag(cp), [dataclasses.asdict(c) for c in cp.join_choices],
            list(cp.pushed_filters), list(cp.annotation_filters),
            cp.tasks.index(cp.root))


def _ledgers(res):
    return ([(tr.label, tr.op, dataclasses.asdict(tr.delta), tr.m_pages, tr.placement)
             for tr in res.per_task],
            dataclasses.asdict(res.total), res.schedule, res.makespan_seconds,
            res.latency_seconds(), len(res.replan_events))


def _outputs(pkg, sess, res):
    return [[p.tobytes() for p in sess.remote.peek_batch(
        pkg.registry.get(tr.op).output_of(tr.result))] for tr in res.per_task]


def _build(pkg, case):
    make_session, build, compile_kw, run_kw = CASES[case]
    sess = make_session(pkg)
    cp = pkg.compile_plan(sess, build(pkg, sess), **compile_kw)
    return sess, cp, run_kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_compiled_dag_explain_ledgers_and_outputs_equal_jax(case):
    jsess, jcp, run_kw = _build(JAX, case)
    sess, cp, _ = _build(PORT, case)
    assert _compiled(cp) == _compiled(jcp)
    assert str(cp.explain(sess)) == str(jcp.explain(jsess))
    assert cp.explain(sess).to_dict() == jcp.explain(jsess).to_dict()
    jres, res = jcp.run(jsess, **run_kw), cp.run(sess, **run_kw)
    assert _ledgers(res) == _ledgers(jres)
    assert _outputs(PORT, sess, res) == _outputs(JAX, jsess, jres)
    if res.schedule == "dag":
        assert res.makespan_seconds <= res.latency_seconds() + 1e-9


def test_q18_overlaps_its_independent_subtrees():
    sess, cp, _ = _build(PORT, "q18")
    deps = engine.Session._dag_deps(cp.tasks)
    assert len([d for d in deps if not d]) == 2  # the agg and the first join
    res = cp.run(sess)
    assert res.makespan_seconds < res.latency_seconds() - 1e-12


def test_invalid_plans_raise_as_jax_does():
    for pkg in (JAX, PORT):
        sess = pkg.Session(_hier(pkg), budget=64)
        with pytest.raises(ValueError, match="empty"):
            pkg.compile_plan(sess, pkg.LogicalPlan("empty"))
        lp = pkg.LogicalPlan("scan_only")
        a = lp.scan("t", pkg.make_relation(sess.remote, 8 * ROWS, ROWS, 32, seed=51))
        with pytest.raises(ValueError, match="no operator tasks"):
            pkg.compile_plan(sess, lp)
        lp.join(a, lp.scan("b", pkg.make_relation(sess.remote, 8 * ROWS, ROWS, 32, seed=53)))
        with pytest.raises(ValueError, match="join_op"):
            pkg.compile_plan(sess, lp, join_op="sortmerge")
        for bad in (float("nan"), float("inf"), 0.0, 1.5):
            with pytest.raises(ValueError, match="selectivity"):
                lp.filter(a, bad)
        with pytest.raises(TypeError, match="callable"):
            lp.filter(a, 0.5, predicate=5)
        with pytest.raises(ValueError, match="no pages"):
            pkg.LogicalPlan("x").scan("empty", [])
        with pytest.raises(TypeError, match="plan Node"):
            pkg.LogicalPlan("y").filter("not-a-node", 0.5)


def test_plan_module_is_the_jax_packages_with_its_imports_renamed():
    src = (ROOT / "src" / "repro" / "engine" / "plan.py").read_text().splitlines()
    port = (ROOT / "src" / "repro_torch" / "engine" / "plan.py").read_text().splitlines()
    diff = [(a, b) for a, b in zip(src, port) if a != b]
    assert len(src) == len(port) and len(diff) == 2
    for a, b in diff:
        assert a.startswith("from repro.engine.") and b == a.replace("repro.", "repro_torch.", 1)
    assert sorted(n for n in dir(plan) if not n.startswith("_")) == sorted(
        n for n in dir(jax_plan) if not n.startswith("_"))


# -- on the torch backend ----------------------------------------------------------------


def _tpch_plan(pkg, sess, shape):
    """A Q3 or Q18 skeleton of benchmarks/bench_tpch.py at a small size."""
    li = pkg.make_relation(sess.remote, 64 * ROWS, ROWS, 128, seed=3)
    o = pkg.make_relation(sess.remote, 16 * ROWS, ROWS, 128, seed=2)
    c = pkg.make_relation(sess.remote, 4 * ROWS, ROWS, 128, seed=4)
    lp = pkg.LogicalPlan(shape)
    l_n = lp.scan("lineitem", li, rows_per_page=ROWS)
    o_n = lp.scan("orders", o, rows_per_page=ROWS)
    if shape == "q3":
        c_n = lp.filter(lp.scan("customer", c, rows_per_page=ROWS), 0.2)
        j = lp.join(lp.join(l_n, o_n, out_pages=2.0), c_n, out_pages=1.0, sigma=0.5,
                    partitions=16)
        lp.sort(lp.aggregate(j, out_pages=1.0, sigma=0.5, partitions=16), k_cap=8)
    else:
        agg = lp.aggregate(l_n, out_pages=0.63 * 64, sigma=0.5, partitions=16)
        j = lp.join(lp.join(lp.scan("customer", c, rows_per_page=ROWS), o_n,
                            out_pages=1.0), agg, out_pages=1.0, sigma=0.5, partitions=16)
        lp.sort(j, k_cap=8)
    return lp


@pytest.mark.parametrize("shape", ["q3", "q18"])
def test_tpch_dag_on_torch_backend_matches_jax_simulator_and_backend(shape):
    """repro's simulator, repro's ExecutionBackend and the port's backend run
    the same compiled DAG.  At this size some partition blocks hold one row,
    which both backends' hooks leave to numpy by their rule (``n >= 2``) and
    count: the counts must agree too."""
    jax_backend = jax_make_backend(*LEVELS)
    backend = make_backend(*LEVELS, device="cpu")
    runs = []
    for pkg, target in ((JAX, jax_sim.make_hierarchy(*LEVELS)), (JAX, jax_backend),
                        (PORT, backend)):
        sess = pkg.Session(target, budget=24.0)
        cp = pkg.compile_plan(sess, _tpch_plan(pkg, sess, shape))
        res = cp.run(sess, replan="measured")
        runs.append((_compiled(cp), _ledgers(res), _outputs(pkg, sess, res)))
    assert runs[0] == runs[1] == runs[2]
    assert res.schedule == "dag" and res.makespan_seconds <= res.latency_seconds() + 1e-9
    final = np.concatenate([p.ravel() for p in backend.peek_batch(
        res.per_task[-1].result.run_page_ids)])
    assert (np.diff(final) >= 0).all()
    assert any(sum(tr.result.per_phase_rounds.values()) > 0 for tr in res.per_task
               if hasattr(tr.result, "per_phase_rounds"))
    assert backend.wall.kernel_calls == jax_backend.wall.kernel_calls > 0
    assert backend.wall.kernel_fallbacks == jax_backend.wall.kernel_fallbacks
    assert backend.wall.host_pinned_pages == jax_backend.wall.host_pinned_pages == 0


def test_plan_and_moe_run_with_jax_package_blocked():
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        from repro_torch.engine import Session
        from repro_torch.engine.plan import LogicalPlan, compile_plan
        from repro_torch.remote import make_backend, make_relation
        backend = make_backend(("dram", 16), "ssd", device="cpu")
        sess = Session(backend, budget=12.0)
        lp = LogicalPlan("q")
        a = lp.scan("a", make_relation(backend, 64, 8, 32, seed=1), rows_per_page=8)
        b = lp.scan("b", make_relation(backend, 128, 8, 32, seed=2), rows_per_page=8)
        lp.sort(lp.join(a, b, out_pages=8.0, sigma=0.5, partitions=4), k_cap=4)
        res = compile_plan(sess, lp).run(sess, replan="measured")
        assert res.schedule == "dag" and backend.wall.kernel_fallbacks == 0
        from repro_torch.configs import ARCHS, reduced
        from repro_torch.models import transformer as tf
        from repro_torch.runtime.serve_loop import Request, ServeEngine
        cfg = reduced(ARCHS["granite-moe-3b-a800m"])
        engine = ServeEngine(cfg, tf.init_params(cfg, device="cpu"), max_len=32,
                             batch_slots=2, device="cpu")
        served = engine.submit([Request(rid=i, prompt=np.arange(n, dtype=np.int32),
                                        max_new_tokens=4) for i, n in enumerate((5, 9, 7))])
        assert sorted(served) == [0, 1, 2] and all(len(t) == 4 for t in served.values())
        leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                        and m.split(".")[0] in ("jax", "repro"))
        assert not leaked, leaked
        print("ok", res.total.c_total)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
