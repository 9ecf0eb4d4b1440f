#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout on a machine with one H100:

    python3 chip_smoke.py

Four phases, each printing JSON objects, one per line:

1. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) and read the card's name and power
   limit from ``nvidia-smi``;
2. kernels: hold every kernel against its plain PyTorch version on the card
   (bit for bit), and time kernel, plain version and the PyTorch library call
   that computes the same function with CUDA events;
3. session: drive the spill engine's main path, ``Session(make_backend(...))
   .run(tasks)``, at a TPC-H SF1-shaped size (EMS over ``l_orderkey``, EHJ of
   orders with lineitem, EAGG of lineitem by key), with the launch counters
   set to 0 just before and read just after; hold it against the port's own
   simulator (ledgers field for field, output pages byte for byte) and the
   operators' oracles;
4. report: per-query wall, transfer, kernel and simulated seconds, the
   card's peak memory, and one ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check raises,
and the script exits non-zero without that line; it also exits non-zero when
no CUDA device is present or when ``src/repro_torch`` is not beside it.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks: HBM3 bandwidth, and 32-bit operations outside
# the tensor cores (the float32 rate; the kernels compare 32-bit keys).
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

# TPC-H SF1, spilled in DuckDB's 256 KiB blocks.
KEY_PAGE_ROWS = 32_768  # int64 keys per page
ROW_PAGE_ROWS = 16_384  # (key, payload) int64 rows per page
EMS_PAGES = 184  # 6,029,312 l_orderkey values
ORDERS_ROWS = 1_500_000
LINEITEM_ROWS = 6_001_215
KEY_DOMAIN = 6_000_000
PARTITIONS = 64
LEVELS = (("dram", 256), ("rdma", 4096), "ssd")
BUDGET_PAGES = 128.0  # 32 MiB

SOURCES = {
    "sort_blocks": "src/repro_torch/kernels/csrc/merge_sort.cu",
    "merge_pass": "src/repro_torch/kernels/csrc/merge_sort.cu",
    "gather_rows": "src/repro_torch/kernels/csrc/gather_rows.cu",
}
REPLACES = {
    "sort_blocks": "src/repro/kernels/merge_sort/merge_sort.py:97",
    "merge_pass": "src/repro/kernels/merge_sort/merge_sort.py:115",
    "gather_rows": "src/repro/kernels/dispatch/dispatch.py:26",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


class Bench:
    """Median CUDA-event times with the L2 cache flushed before each launch."""

    def __init__(self, torch, device, reps: int = 15, warmup: int = 3):
        self.torch = torch
        self.reps = reps
        self.warmup = warmup
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def max_abs_err(torch, got, want) -> float:
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"dtype/shape differ: {got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    return float((got.double() - want.double()).abs().max().item())


def equal_bits(torch, names, got_pair, want_pair, errs):
    """Check kernel outputs equal to the plain version's, bit for bit; record
    the largest absolute difference under each kernel in ``names``."""
    for got, want in zip(got_pair, want_pair):
        err = max_abs_err(torch, got, want)
        for name in names:
            errs[name] = max(errs.get(name, 0.0), err)
        check(torch.equal(got, want), f"{names}: kernel differs from its plain version (max abs err {err})")


def bound(bytes_moved: float, ops: float):
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ALU_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_kernels(torch, device):
    from repro_torch.kernels.dispatch.dispatch import gather_rows, gather_rows_plain
    from repro_torch.kernels.merge_sort.merge_sort import (
        merge_pass, merge_pass_plain, sort_blocks, sort_blocks_plain)
    from repro_torch.kernels.merge_sort.ops import (
        argsort_by_key, argsort_by_key_plain, remop_sort, remop_sort_plain)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    errs = {}
    rows = {}
    sorts = ["sort_blocks", "merge_pass"]  # remop_sort and argsort_by_key run both

    def tied(n, dtype, hi=1000):
        return torch.randint(0, hi, (n,), device=device, generator=gen,
                             dtype=torch.int32).to(dtype)

    # -- correctness: ties, every merge run, ragged lengths, bit for bit --------
    for dtype in (torch.int32, torch.float32):
        keys = tied(1 << 21, dtype)
        vals = torch.arange(1 << 21, dtype=torch.int32, device=device)
        for block in (2, 256, 1 << 14):
            equal_bits(torch, ["sort_blocks"], sort_blocks(keys, vals, block),
                       sort_blocks_plain(keys, vals, block), errs)
    n = 1 << 21
    perm = torch.randperm(n, device=device, generator=gen).to(torch.int32)
    for dtype in (torch.int32, torch.float32):
        base = tied(n, dtype)
        runs = [1 << e for e in range(1, 21)] if dtype == torch.int32 else [2, 1 << 13, 1 << 14, 1 << 20]
        for run in runs:
            # Sorted runs with ties inside and across them (the library sort
            # only prepares inputs here).
            keys = torch.sort(base.view(-1, run), dim=1).values.reshape(-1)
            equal_bits(torch, ["merge_pass"], merge_pass(keys, perm, run),
                       merge_pass_plain(keys, perm, run), errs)
    for n in (3, (1 << 14) + 1, 1 << 21):
        for dtype in (torch.int32, torch.float32):
            keys = tied(n, dtype, hi=max(2, n // 8))
            equal_bits(torch, sorts, remop_sort(keys), remop_sort_plain(keys), errs)
        parts = tied(n, torch.int32, hi=64)
        equal_bits(torch, sorts, (argsort_by_key(parts, max_key=63),),
                   (argsort_by_key_plain(parts, max_key=63),), errs)
        emit({"phase": "kernels", "check": "remop_sort+argsort_by_key", "n": n, "equal": True})
    x = torch.randint(-(1 << 30), 1 << 30, (1 << 20, 2), device=device,
                      generator=gen, dtype=torch.int32)
    for rpb in (1, 8):
        blocks = torch.randperm((1 << 20) // rpb, device=device, generator=gen)
        idx = (blocks[:, None] * rpb + torch.arange(rpb, device=device)).reshape(-1).to(torch.int32)
        equal_bits(torch, ["gather_rows"], (gather_rows(x, idx, rpb),),
                   (gather_rows_plain(x, idx, rpb),), errs)
    for shape, dtype in (((4096, 3), torch.int64), ((1000, 5), torch.int16),
                         ((777, 8), torch.float32), ((513, 7), torch.uint8)):
        src = torch.randint(0, 100, shape, device=device, generator=gen).to(dtype)
        idx = torch.randint(0, shape[0], (shape[0] // 2 * 2,), device=device,
                            generator=gen, dtype=torch.int32)
        equal_bits(torch, ["gather_rows"], (gather_rows(src, idx),),
                   (gather_rows_plain(src, idx),), errs)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "check": "bit-identical to the plain versions",
          "max_abs_err": errs})

    # -- timing at the main path's widest shapes -------------------------------
    bench = Bench(torch, device)
    n = 1 << 22  # EMS run formation over 128 key pages: 4,194,304 keys
    keys = tied(n, torch.int32, hi=KEY_DOMAIN)
    vals = torch.arange(n, dtype=torch.int32, device=device)
    b = 1 << 14
    stages = 14 * 15 // 2
    ms_bound, by = bound(16 * n, n / 2 * stages)
    rows["sort_blocks"] = dict(
        shape=f"n={n}, block={b}, int32 keys + int32 values",
        ms=bench.ms(lambda: sort_blocks(keys, vals, b)),
        plain_ms=bench.ms(lambda: sort_blocks_plain(keys, vals, b)),
        library_ms=bench.ms(lambda: torch.sort(keys.view(-1, b), dim=1, stable=True)),
        bound_ms=ms_bound, bound_by=by)

    runs_sorted, _ = sort_blocks(keys, vals, b)
    merge_runs = [1 << e for e in range(14, 22)]

    def ladder(fn):
        k, v = runs_sorted, vals
        for run in merge_runs:
            k, v = fn(k, v, run)
        return k, v

    merge_stages = sum(e + 1 for e in range(14, 22))
    ms_bound, by = bound(16 * n * len(merge_runs), n / 2 * merge_stages)
    rows["merge_pass"] = dict(
        shape=f"n={n}, runs 2^14..2^21 (8 passes), int32 keys + int32 values",
        ms=bench.ms(lambda: ladder(merge_pass)),
        plain_ms=bench.ms(lambda: ladder(merge_pass_plain)),
        library_ms=bench.ms(lambda: torch.sort(runs_sorted, stable=True)),
        bound_ms=ms_bound, bound_by=by)

    m = 1 << 20  # a partition block of (key, payload) rows narrowed to int32
    x = torch.randint(0, KEY_DOMAIN, (m, 2), device=device, generator=gen, dtype=torch.int32)
    idx = torch.randperm(m, device=device, generator=gen).to(torch.int32)
    ms_bound, by = bound(2 * x.numel() * 4 + idx.numel() * 4, 0)
    rows["gather_rows"] = dict(
        shape=f"x=[{m}, 2] int32, idx=[{m}] int32, rows_per_block=1",
        ms=bench.ms(lambda: gather_rows(x, idx)),
        plain_ms=bench.ms(lambda: gather_rows_plain(x, idx)),
        library_ms=bench.ms(lambda: torch.index_select(x, 0, idx)),
        bound_ms=ms_bound, bound_by=by)
    for name, row in rows.items():
        emit({"phase": "kernels", "timing": name, **row})

    # The composite ops on the main path, with the library sort beside them.
    keys = tied(n, torch.int32, hi=KEY_DOMAIN)
    parts = tied(m, torch.int32, hi=PARTITIONS)
    emit({"phase": "kernels", "timing": "remop_sort", "n": n,
          "ms": bench.ms(lambda: remop_sort(keys)),
          "plain_ms": bench.ms(lambda: remop_sort_plain(keys)),
          "library_ms": bench.ms(lambda: torch.sort(keys, stable=True))})
    emit({"phase": "kernels", "timing": "argsort_by_key", "n": m,
          "ms": bench.ms(lambda: argsort_by_key(parts, max_key=PARTITIONS - 1)),
          "plain_ms": bench.ms(lambda: argsort_by_key_plain(parts, max_key=PARTITIONS - 1)),
          "library_ms": bench.ms(lambda: torch.argsort(parts, stable=True))})
    del bench
    return errs, rows


# --------------------------------------------------------------------------
# Phase 3: the Session at a TPC-H SF1-shaped size
# --------------------------------------------------------------------------


def sf1_queries(remote):
    """Seed the SF1-shaped data on ``remote``; one task per query."""
    from repro_torch.remote.simulator import make_key_pages, make_relation

    keys = make_key_pages(remote, EMS_PAGES, KEY_PAGE_ROWS, key_domain=KEY_DOMAIN, seed=1)
    orders = make_relation(remote, ORDERS_ROWS, ROW_PAGE_ROWS, KEY_DOMAIN, seed=2)
    lineitem = make_relation(remote, LINEITEM_ROWS, ROW_PAGE_ROWS, KEY_DOMAIN, seed=3)
    o_pages, l_pages = len(orders.page_ids), len(lineitem.page_ids)
    return [
        ("ems", dict(size_r=EMS_PAGES), {"page_ids": keys}, {"rows_per_page": KEY_PAGE_ROWS}),
        ("ehj", dict(size_r=o_pages, size_s=l_pages, out=o_pages, partitions=PARTITIONS,
                     sigma=0.5), {"build": orders, "probe": lineitem}, {}),
        ("eagg", dict(size_r=l_pages, out=0.63 * l_pages, partitions=PARTITIONS, sigma=0.5),
         {"rel": lineitem}, {}),
    ]


def run_queries(remote, on_query=None):
    """One Session per query over ``remote``, each with the full budget.

    A query is one ``Session(remote, budget).run([task])``, so each reports
    its own wall clock and ledger; ``on_query`` snapshots the backend's wall
    clock before and after each.
    """
    from repro_torch.engine import Session, WorkloadStats

    out = []
    for op, stats, inputs, opts in sf1_queries(remote):
        sess = Session(remote, budget=BUDGET_PAGES)
        task = sess.task(op, WorkloadStats(**stats), inputs=inputs, **opts)
        before = on_query() if on_query else None
        t0 = time.perf_counter()
        res = sess.run([task])
        host_s = time.perf_counter() - t0
        after = on_query() if on_query else None
        out.append((op, inputs, res, host_s, before, after))
    return out


def wall_state(backend):
    w = backend.wall
    return dict(transfer_seconds=w.transfer_seconds, kernel_seconds=w.kernel_seconds,
                kernel_calls=w.kernel_calls)


def output_ids(op, result):
    from repro_torch.engine import registry

    return registry.get(op).output_of(result)


def check_oracle(remote, op, inputs, result):
    from repro_torch.engine import registry
    import numpy as np

    oracle = registry.get(op).oracle(remote, *inputs.values())
    if op == "ems":
        got = np.concatenate([p.ravel() for p in remote.peek_batch(result.run_page_ids)])
        check(np.array_equal(got, oracle), "EMS output is not the sorted keys")
        check(result.passes >= 1, "EMS formed a single run: nothing spilled")
    elif op == "ehj":
        check(result.output_rows == oracle, f"EHJ rows {result.output_rows} != oracle {oracle}")
        check(result.per_phase_rounds["P3"] > 0, "EHJ spilled no partition")
    else:
        got = np.concatenate(remote.peek_batch(result.output_page_ids), axis=0)
        got = got[np.argsort(got[:, 0], kind="stable")]
        check(np.array_equal(got, oracle), "EAGG groups differ from the oracle")
        check(result.per_phase_rounds["P2"] > 0, "EAGG spilled no partition")


def phase_session(torch, device):
    import numpy as np
    from repro_torch.kernels import runtime
    from repro_torch.remote import make_backend, make_hierarchy

    backend = make_backend(*LEVELS, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    runtime.reset_launches()
    queries = run_queries(backend, on_query=lambda: wall_state(backend))
    torch.cuda.synchronize()
    launches = dict(runtime.launches)
    peak = torch.cuda.max_memory_allocated(device)

    simulator = make_hierarchy(*LEVELS)
    sim_queries = run_queries(simulator)
    check(backend.wall.kernel_fallbacks == 0, "a kernel hook fell back to numpy")
    check(backend.wall.host_pinned_pages == 0, "a page was pinned to the host")
    for name in SOURCES:
        check(launches.get(name, 0) > 0, f"the main path never launched {name}")

    for (op, inputs, res, host_s, before, after), (_, _, sim, _, _, _) in zip(queries, sim_queries):
        check(dataclasses.asdict(res.total) == dataclasses.asdict(sim.total),
              f"{op}: backend ledger differs from the simulator's")
        (tr,), (str_,) = res.per_task, sim.per_task
        pages = backend.peek_batch(output_ids(op, tr.result))
        sim_pages = simulator.peek_batch(output_ids(op, str_.result))
        check(len(pages) == len(sim_pages) and all(
            a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
            for a, b in zip(pages, sim_pages)), f"{op}: output pages differ from the simulator's")
        check_oracle(backend, op, inputs, tr.result)
        calls = after["kernel_calls"] - before["kernel_calls"]
        check(calls > 0, f"{op}: its kernel hook never ran")
        emit({"phase": "session", "query": op, "m_pages": tr.m_pages,
              "placement": tr.placement, "output_pages": len(pages),
              "wall_seconds": res.wall_seconds,
              "transfer_seconds": after["transfer_seconds"] - before["transfer_seconds"],
              "kernel_seconds": after["kernel_seconds"] - before["kernel_seconds"],
              "kernel_calls": calls,
              "host_seconds": host_s,
              "simulated_seconds": res.latency_seconds(),
              "d_total": res.total.d_total, "c_total": res.total.c_total,
              "ledger_equal": True, "outputs_equal": True, "oracle_equal": True})
    emit({"phase": "session", "launches": launches,
          "kernel_calls": backend.wall.kernel_calls,
          "kernel_fallbacks": backend.wall.kernel_fallbacks,
          "host_pinned_pages": backend.wall.host_pinned_pages,
          "wall": backend.wall.to_dict(),
          "peak_device_bytes": peak})
    return launches


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import runtime

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    compiled = runtime.build()  # one nvcc per source, all started together
    for name in runtime.SOURCES:
        runtime.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "compiled": compiled,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    card = nvidia_smi()
    print(card, flush=True)
    emit({"phase": "scale", "reduced": [],
          "note": "TPC-H SF1 row counts and 256 KiB pages as stated; nothing cut"})

    errs, rows = phase_kernels(torch, device)
    launches = phase_session(torch, device)

    kernels = []
    for name, row in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    emit({"card": card, "kernel_shapes": {n: r["shape"] for n, r in rows.items()}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
