"""Torch execution backend parity: device copies, kernels, same answers.

The port's :class:`repro_torch.remote.backend.TorchExecutionBackend` changes
nothing the simulator asserts: every test here runs the same workload
against a simulated ``MemoryHierarchy`` and a backend on the same hierarchy
spec and demands byte-identical operator output pages, field-for-field equal
ledger snapshots, and wall-clock measurements present on the backend only.

The backend runs on the CPU here (``device="cpu"``), where each kernel hook
takes the kernel's plain PyTorch version.  The three-way test holds the
port against the JAX package's simulator and its ``ExecutionBackend`` (Pallas
in interpret mode) on the two scenarios of ``benchmarks/bench_backend.py``.
"""

import dataclasses

import numpy as np
import pytest

from repro.engine import Session as JaxSession, WorkloadStats as JaxStats
from repro.engine.registry import hierarchy_spec as jax_hierarchy_spec
from repro.remote import MemoryHierarchy as JaxHierarchy, make_backend as jax_make_backend
from repro.remote.simulator import (
    make_key_pages as jax_make_key_pages,
    make_relation as jax_make_relation,
)

from repro_torch.core import TABLE_I
from repro_torch.engine import Session, WorkloadStats
from repro_torch.engine.registry import hierarchy_spec
from repro_torch.kernels import runtime
from repro_torch.remote import MemoryHierarchy, make_backend
from repro_torch.remote.backend import TorchExecutionBackend
from repro_torch.remote.simulator import make_key_pages, make_relation

ROWS = 4
THREE = ((TABLE_I["dram"], 16), (TABLE_I["rdma"], 128), TABLE_I["ssd"])
ONE = (TABLE_I["tcp"],)
# bench_backend.py's scenarios, by tier name.
SCENARIOS = {
    "tcp": ("tcp",),
    "dram_rdma_ssd": (("dram", 16), ("rdma", 128), "ssd"),
}


def _cpu_backend(*levels):
    return make_backend(*levels, device="cpu")


def _tasks(sess, stats=WorkloadStats, key_pages=make_key_pages,
           relation=make_relation):
    """A tiny EMS + EHJ pipeline exercising both kernel hooks."""
    ids = key_pages(sess.remote, 24, ROWS, seed=3)
    build = relation(sess.remote, 8 * ROWS, ROWS, 16, seed=4)
    probe = relation(sess.remote, 16 * ROWS, ROWS, 16, seed=5)
    return [
        sess.task("ems", stats(size_r=24, k_cap=4),
                  inputs={"page_ids": ids}, rows_per_page=ROWS),
        sess.task("ehj", stats(size_r=8, size_s=16, out=6,
                               partitions=4, sigma=0.5),
                  inputs={"build": build, "probe": probe}),
    ]


def _run(remote):
    sess = Session(remote, budget=24.0)
    return sess, sess.run(_tasks(sess))


def _run_jax(remote):
    sess = JaxSession(remote, budget=24.0)
    tasks = _tasks(sess, JaxStats, jax_make_key_pages, jax_make_relation)
    return sess, sess.run(tasks)


def _output_ids(op, result):
    return result.run_page_ids if op == "ems" else result.output_page_ids


def _assert_same_outputs(sess_a, res_a, sess_b, res_b):
    for (op_a, ra, _), (op_b, rb, _) in zip(res_a.per_op, res_b.per_op):
        assert op_a == op_b
        pages_a = sess_a.remote.peek_batch(_output_ids(op_a, ra))
        pages_b = sess_b.remote.peek_batch(_output_ids(op_b, rb))
        assert len(pages_a) == len(pages_b)
        for pa, pb in zip(pages_a, pages_b):
            assert pa.dtype == pb.dtype
            assert pa.shape == pb.shape
            assert np.array_equal(pa, pb)


def _assert_same_ledgers(res_a, res_b):
    assert dataclasses.asdict(res_a.total) == dataclasses.asdict(res_b.total)
    for (op_a, _, da), (op_b, _, db) in zip(res_a.per_op, res_b.per_op):
        assert op_a == op_b
        assert dataclasses.asdict(da) == dataclasses.asdict(db)


def _assert_parity(levels):
    sim_sess, sim = _run(MemoryHierarchy(hierarchy_spec(*levels)))
    backend = _cpu_backend(*levels)
    bk_sess, bkr = _run(backend)

    # Wall clock: measured on the backend, absent from the simulator.
    assert sim.wall_seconds is None
    assert bkr.wall_seconds is not None and bkr.wall_seconds > 0.0

    _assert_same_ledgers(sim, bkr)
    _assert_same_outputs(sim_sess, sim, bk_sess, bkr)
    return backend


def test_session_parity_three_tier():
    backend = _assert_parity(THREE)
    # The hooks ran through the kernel wrappers: no silent numpy fallbacks.
    assert backend.wall.kernel_calls > 0
    assert backend.wall.kernel_fallbacks == 0
    assert backend.wall.host_pinned_pages == 0


def test_session_parity_single_tier():
    backend = _assert_parity(ONE)
    assert backend.wall.kernel_calls > 0
    assert backend.wall.kernel_fallbacks == 0


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_three_way_parity_with_jax_package(scenario):
    """repro's simulator, repro's ExecutionBackend and the port's backend."""
    levels = SCENARIOS[scenario]
    sim_sess, sim = _run_jax(JaxHierarchy(jax_hierarchy_spec(*levels)))
    jax_backend = jax_make_backend(*levels)
    jbk_sess, jbk = _run_jax(jax_backend)
    backend = _cpu_backend(*levels)
    bk_sess, bkr = _run(backend)

    _assert_same_ledgers(sim, bkr)
    _assert_same_ledgers(jbk, bkr)
    _assert_same_outputs(sim_sess, sim, bk_sess, bkr)
    _assert_same_outputs(jbk_sess, jbk, bk_sess, bkr)
    assert backend.wall.kernel_calls == jax_backend.wall.kernel_calls == 14
    assert backend.wall.kernel_fallbacks == jax_backend.wall.kernel_fallbacks == 0
    assert backend.wall.host_pinned_pages == jax_backend.wall.host_pinned_pages
    assert set(backend.wall.to_dict()) == set(jax_backend.wall.to_dict())


# -- direct hook parity ------------------------------------------------------


def test_sort_keys_hook_matches_numpy():
    backend = _cpu_backend(*ONE)
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 50, size=37).astype(np.int64)  # duplicates likely
    out = backend.sort_keys(keys)
    assert out.dtype == keys.dtype
    np.testing.assert_array_equal(out, np.sort(keys, kind="stable"))
    assert backend.wall.kernel_calls == 1
    assert backend.wall.kernel_fallbacks == 0


def test_partition_rows_hook_matches_masks():
    backend = _cpu_backend(*ONE)
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 1000, size=(29, 3)).astype(np.int64)
    parts = rng.integers(0, 4, size=29).astype(np.int64)
    got = backend.partition_rows(rows, parts)
    want = [(int(q), rows[parts == q]) for q in np.unique(parts)]
    assert [q for q, _ in got] == [q for q, _ in want]
    for (_, ga), (_, wa) in zip(got, want):
        assert ga.dtype == wa.dtype
        np.testing.assert_array_equal(ga, wa)  # mask order == stable order
    assert backend.wall.kernel_fallbacks == 0


def test_out_of_int32_range_keys_fall_back_but_agree():
    backend = _cpu_backend(*ONE)
    keys = np.array([2**40, 5, 2**35, 5, -1], dtype=np.int64)
    out = backend.sort_keys(keys)
    np.testing.assert_array_equal(out, np.sort(keys, kind="stable"))
    assert backend.wall.kernel_fallbacks == 1
    assert backend.wall.kernel_calls == 0


def test_host_pinned_pages_round_trip_unchanged():
    """Pages whose values exceed int32 never get a device copy, yet reads
    return them bit-exact (the host copy is authoritative)."""
    backend = _cpu_backend(*ONE)
    big = np.array([2**40, 2**41, 3], dtype=np.int64)
    small = np.arange(5, dtype=np.int64)
    ids = backend.put_local([big, small])
    assert backend.wall.host_pinned_pages == 1
    got = backend.read_batch(ids)
    np.testing.assert_array_equal(got[0], big)
    assert got[0].dtype == np.int64
    np.testing.assert_array_equal(got[1], small)
    assert got[1].dtype == np.int64


def test_wall_clock_report_shape():
    backend = _cpu_backend(*THREE)
    report = backend.wall.to_dict()
    assert set(report["tiers"]) == {"dram", "rdma", "ssd"}
    for tier in report["tiers"].values():
        for key in ("h2d_seconds", "h2d_rounds", "h2d_bytes",
                    "d2h_seconds", "d2h_rounds", "d2h_bytes"):
            assert key in tier
    assert "wall_seconds" in report
    assert "kernel_seconds" in report


def test_backend_is_a_hierarchy_and_flagged():
    backend = _cpu_backend(*THREE)
    assert isinstance(backend, MemoryHierarchy)
    assert isinstance(backend, TorchExecutionBackend)
    assert backend.is_backend is True
    assert backend.device.type == "cpu"
    assert getattr(MemoryHierarchy(hierarchy_spec(*THREE)), "is_backend",
                   False) is False


def test_migrate_keeps_device_mirrors_consistent():
    backend = _cpu_backend(*THREE)
    pages = [np.arange(i, i + ROWS, dtype=np.int64) for i in range(0, 12, ROWS)]
    ids = backend.put_local(pages)  # seeds on the bottom tier (ssd)
    backend.promote(ids)
    # Each device copy moved with its page, to the tier that now holds it.
    for i in ids:
        assert backend.tier_of(i) != "ssd"
        assert i in backend.tier(backend.tier_of(i))._dev
        assert i not in backend.tier("ssd")._dev
    got = backend.read_batch(ids)
    for page, back in zip(pages, got):
        np.testing.assert_array_equal(page, back)
        assert back.dtype == np.int64


def test_cpu_backend_launches_no_kernel():
    """On the CPU every hook takes the plain versions: no kernel launches."""
    runtime.reset_launches()
    _assert_parity(ONE)
    assert sum(runtime.launches.values()) == 0
