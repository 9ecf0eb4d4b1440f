"""The flash backward's flush: no dkdv accumulator sums more than
``BWD_FLUSH_ROWS`` (head, query) rows between flushes in a call that
flushes, nor more than ``BWD_RUN_ROWS`` in one that does not, on the CPU.

A call whose key block's walk may pass ``BWD_RUN_ROWS`` rows (granite-20b's
48 heads on one KV head, G 8 at S 2048, granite-moe's G 3), or that has a
prefix (paligemma's patches, the encoder's and cross-attention's every
key), flushes: every ``BWD_FLUSH_ROWS`` rows each dkdv CTA adds its f32
sums into its partial in scratch and restarts them from 0, in one launch
(``plan_bwd_flush_steps``, ``dkdv_runs``; the launch hands the kernels the
flush length, which plan nothing of their own), and splits over CTAs only
where occupancy asks.  Pinned here: the runs of every plan up to 48 x 8192
rows; the planted fault of a flushing call handed no flush, rejected by
``check_bwd_runs`` and by the launch; every ``chip_smoke.BWD_CHECKS`` row
that does not flush keeping one run a CTA (so its one launch and its
bits); a call with a prefix held to ``BWD_FLUSH_ROWS``; and
``kv_split_partials_plain`` over several runs a CTA summing to the unsplit
plain dK and dV and to ``jax.vjp`` of ``repro``'s ``full_attention``.
"""

import contextlib
import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

import test_torch_flash_grad as cases
from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention.flash_attention import flash_attention

ROOT = Path(__file__).resolve().parents[1]
# The partials summed in another order than the unsplit walk: f32 rounding
# of sums of a few hundred terms of order 1.
SUM_TOL = 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dkdv_bq(hd, hd_v, capped=False):
    return fab.plan_bwd_tc_blocks(hd, hd_v, capped)["dkdv"][1]


def test_kernel_run_rows_match_the_host():
    """The kernels take their flush length from the host (``flush_steps``,
    no run length of their own to drift from :data:`BWD_FLUSH_ROWS`), launch
    dkdv once a call (no pass loop), and their CTA cap is
    BWD_KV_SPLIT_MAX."""
    src = (ROOT / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu").read_text()
    assert not re.search(r"RUN_ROWS|FLUSH_ROWS|kRunRows|run_steps|PASSES|p\.pass", src)
    assert re.search(r"int prefix, float softcap, int flush_steps, void\* stream\)", src)
    assert fab.BWD_RUN_ROWS % fab.BWD_FLUSH_ROWS == 0
    assert re.search(r"constexpr int kMaxSplit = (\d+);", src).group(1) == str(
        fab.BWD_KV_SPLIT_MAX)


def test_the_launch_hands_the_kernels_the_planned_runs(monkeypatch):
    """The tc entry's flush_steps (before the stream) is the host's plan: 0
    where a call keeps one run a CTA (G 1 at 2048), BWD_FLUSH_ROWS / bq at
    G 2, G 8 and granite-20b's G 48; a flush length given by the caller goes
    through the same check, and a flushing call's scratch is allocated
    even at one CTA a key block."""
    lib = _Recorder()
    monkeypatch.setattr(fab.runtime, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(fab.runtime, "library", lambda name: lib)
    monkeypatch.setattr(fab.runtime, "stream_of", lambda x: None)
    monkeypatch.setattr(fab.torch.cuda, "device", lambda d: contextlib.nullcontext())
    lse = torch.zeros(4, 48, 2048)
    for b, heads, want in ((4, 1, 0), (4, 2, fab.BWD_FLUSH_ROWS // 64),
                           (1, 8, fab.BWD_FLUSH_ROWS // 64),
                           (1, 48, fab.BWD_FLUSH_ROWS // 64), (4, 3, fab.BWD_FLUSH_ROWS // 64)):
        q = torch.zeros(b, heads, 2048, 128, dtype=torch.bfloat16)
        k = torch.zeros(b, 1, 2048, 128, dtype=torch.bfloat16)
        _, _, _, part, split = fab.bwd_tc_launch(q, k, k, q, q, lse[:b, :heads], 0.1)
        assert lib.args[-2] == want and lib.args[23] == split == fab.bwd_tc_kv_split(
            b, heads, 1, 2048, 2048, 128, 128)
        assert (part is None) == (split == 1 and want == 0)
    q = torch.zeros(1, 48, 2048, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 2048, 128, dtype=torch.bfloat16)
    fab.bwd_tc_launch(q, k, k, q, q, lse[:1], 0.1, flush_steps=2)
    assert lib.args[-2] == 2
    with pytest.raises(ValueError, match="dkdv run of 6144"):  # each CTA's whole part
        fab.bwd_tc_launch(q, k, k, q, q, lse[:1], 0.1, flush_steps=0)
    with pytest.raises(ValueError, match="power of two"):
        fab.bwd_tc_launch(q, k, k, q, q, lse[:1], 0.1, flush_steps=3)


class _Recorder:
    def remop_flash_attention_bwd_tc(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("hd,hd_v,capped", [(128, 128, False), (128, 128, True), (64, 64, False),
                                            (256, 256, False), (192, 128, False)])
@pytest.mark.parametrize("b,h,kv,s", [
    (1, 48, 1, 2048),    # granite-20b: 98,304 rows, 16 CTAs of 6,144
    (1, 48, 1, 8192),    # 48 x 8192: 393,216 rows, 16 CTAs of 24,576
    (1, 8, 1, 16384),    # gemma-2b's G 8 at S 16,384: 131,072 rows
    (1, 8, 1, 8192),     # 65,536 rows
    (1, 8, 1, 8200),     # just past it, ragged
    (4, 24, 8, 2048),    # granite-moe-3b-a800m's training shape: G 3
    (4, 16, 16, 2048),   # deepseek-v2-lite's MLA: G 1, no flush
    (1, 10, 1, 4096),    # recurrentgemma's 10 heads
    (2, 8, 2, 1000),     # ragged, G 4: 4,000 rows
])
def test_every_run_stays_within_the_run_rows(b, h, kv, s, hd, hd_v, capped):
    """Whatever group * s is, the plan's longest accumulator run (key block
    0's walk, every query block of every head) is at most BWD_FLUSH_ROWS
    rows where the call flushes and BWD_RUN_ROWS where it does not; the
    CTAs stay at most BWD_KV_SPLIT_MAX; the launch's check passes."""
    bq = _dkdv_bq(hd, hd_v, capped)
    kv_split = fab.bwd_tc_kv_split(b, h, kv, s, s, hd, hd_v)
    assert 1 <= kv_split <= fab.BWD_KV_SPLIT_MAX
    flush = fab.plan_bwd_flush_steps(h // kv, s, bq)
    bound = fab.BWD_FLUSH_ROWS if flush else fab.BWD_RUN_ROWS
    assert (flush > 0) == (h // kv * s > fab.BWD_RUN_ROWS)
    longest = fab.longest_bwd_run(h // kv, s, bq, kv_split)
    assert 0 < longest <= bound
    fab.check_bwd_runs(h // kv, s, bq, kv_split)
    # Exactly: every run's rows, from dkdv_runs, within the bound; the CTAs'
    # runs cover each step once, in order.
    n_q = -(-s // bq)
    ctas = fab.dkdv_runs(h // kv * n_q, kv_split, flush)
    steps = [i for cta in ctas for run in cta for i in run]
    assert steps == list(range(h // kv * n_q))
    for cta in ctas:
        for run in cta:
            assert sum(min(bq, s - (i % n_q) * bq) for i in run) <= bound


def test_granite_20b_walks_several_runs_a_cta():
    """48 heads on one KV head of 2048 at hd 128: 16 CTAs a key block (the
    cap), each part of 96 steps of 64 rows flushed every BWD_FLUSH_ROWS rows
    in one launch."""
    kv_split = fab.bwd_tc_kv_split(1, 48, 1, 2048, 2048, 128, 128)
    assert kv_split == fab.BWD_KV_SPLIT_MAX == 16
    run = fab.plan_bwd_flush_steps(48, 2048, 64)
    assert run * 64 == fab.BWD_FLUSH_ROWS
    ctas = fab.dkdv_runs(48 * 32, kv_split, run)
    assert [[len(r) for r in cta] for cta in ctas] == [[run] * (96 // run)] * 16
    assert fab.longest_bwd_run(48, 2048, 64, kv_split) == fab.BWD_FLUSH_ROWS
    # Within BWD_RUN_ROWS one run a part and no flush: 1 head of 2048.
    assert fab.plan_bwd_flush_steps(1, 2048, 64) == 0


@pytest.mark.parametrize("shape", [(48, 2048, 64), (8, 16384, 64), (48, 8192, 32)])
def test_planted_fault_the_capped_split_without_runs_is_rejected(shape):
    """A flushing call handed no flush (its 16 CTAs each summing the whole
    part in one run, the walk before the flush): its runs pass
    BWD_FLUSH_ROWS, and the check rejects it."""
    group, s, bq = shape
    kv_split = fab.BWD_KV_SPLIT_MAX
    fab.check_bwd_runs(group, s, bq, kv_split)
    assert fab.longest_bwd_run(group, s, bq, kv_split, flush_steps=0) > fab.BWD_RUN_ROWS
    with pytest.raises(ValueError, match="dkdv run of"):
        fab.check_bwd_runs(group, s, bq, kv_split, flush_steps=0)


def test_planted_fault_the_launch_refuses_a_walk_of_one_run(monkeypatch):
    """With the flush plan planted back to none, granite-20b's call raises
    before any launch (the stand-in library records none)."""
    calls = []
    monkeypatch.setattr(fab.runtime, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(fab.runtime, "library", lambda name: calls.append(name))
    monkeypatch.setattr(fab, "plan_bwd_flush_steps", lambda *args: 0)
    fab.longest_bwd_run.cache_clear()
    try:
        q = torch.zeros(1, 48, 2048, 128, dtype=torch.bfloat16)
        k = v = torch.zeros(1, 1, 2048, 128, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="dkdv run of 6144"):
            fab.bwd_tc_launch(q, k, v, q, q, torch.zeros(1, 48, 2048), 0.1)
        assert calls == []
    finally:
        fab.longest_bwd_run.cache_clear()


def test_every_bwd_check_row_keeps_one_run_a_cta():
    """Every tensor-core row of chip_smoke's BWD_CHECKS flushes exactly where
    its walk may pass BWD_RUN_ROWS rows or it has a prefix (the rows of
    chip_smoke.BWD_UNFLUSHED do not: one run a CTA, the arithmetic and bits
    they had); the flushing rows' accumulators sum at most BWD_FLUSH_ROWS
    between flushes."""
    smoke = _chip_smoke()
    unflushed = set()
    for name, b, h, kv, s, t, hd, hd_v, window, prefix, cap, gain, dtype in smoke.BWD_CHECKS:
        if dtype != "bfloat16" or (hd, hd_v) not in fab.BWD_TC_HEAD_PAIRS:
            continue
        bq = _dkdv_bq(hd, hd_v, cap > 0)
        kv_split = fab.bwd_tc_kv_split(b, h, kv, s, t, hd, hd_v, prefix)
        n_q = -(-s // bq)
        flush = fab.plan_bwd_flush_steps(h // kv, s, bq, prefix)
        runs = max(len(cta) for cta in fab.dkdv_runs(h // kv * n_q, kv_split, flush))
        fab.check_bwd_runs(h // kv, s, bq, kv_split, prefix=prefix)
        if flush:
            assert fab.longest_bwd_run(h // kv, s, bq, kv_split, prefix=prefix) <= (
                fab.BWD_FLUSH_ROWS), name
        else:
            assert runs == 1 and (kv_split == 1 or (hd, hd_v) in fab.BWD_TC_WG_PAIRS), name
            unflushed.add(name)
    assert unflushed == set(smoke.BWD_UNFLUSHED)


@pytest.mark.parametrize("hd,hd_v,capped", [(256, 256, False), (128, 128, False),
                                            (128, 128, True), (64, 64, False)])
@pytest.mark.parametrize("b,h,kv,s,prefix", [
    (4, 8, 1, 2048, 256),     # paligemma-3b's training shape: 16,384 rows
    (1, 8, 1, 700, 200),      # prefix 200, ragged
    (1, 16, 16, 4096, 4096),  # every key (an encoder's self-attention)
    (1, 16, 16, 300, 200),    # cross-attention, S > T: every key
    (1, 48, 1, 2048, 2048),   # 48 heads on one KV head, every key: 98,304 rows
])
def test_every_prefix_run_stays_within_the_prefix_rows(b, h, kv, s, prefix, hd, hd_v, capped):
    """A call with a prefix flushes: the plan's longest accumulator run is at
    most BWD_FLUSH_ROWS rows, its runs cover each step once, in order, and
    the launch's check passes; the same walk handed no flush passes 256 rows
    wherever it is longer, and the check at the prefix rejects it."""
    bq = _dkdv_bq(hd, hd_v, capped)
    group = h // kv
    kv_split = fab.bwd_tc_kv_split(b, h, kv, s, s, hd, hd_v, prefix)
    assert 1 <= kv_split <= fab.BWD_KV_SPLIT_MAX
    run = fab.plan_bwd_flush_steps(group, s, bq, prefix)
    assert run * bq == fab.BWD_FLUSH_ROWS
    assert 0 < fab.longest_bwd_run(group, s, bq, kv_split, prefix=prefix) <= fab.BWD_FLUSH_ROWS
    fab.check_bwd_runs(group, s, bq, kv_split, prefix=prefix)
    n_q = -(-s // bq)
    ctas = fab.dkdv_runs(group * n_q, kv_split, run)
    assert [i for cta in ctas for r in cta for i in r] == list(range(group * n_q))
    if fab.longest_bwd_run(group, s, bq, kv_split, 0) > fab.BWD_FLUSH_ROWS:
        with pytest.raises(ValueError, match="dkdv run of"):
            fab.check_bwd_runs(group, s, bq, kv_split, 0, prefix=prefix)


def test_the_launch_plans_a_prefix_call_on_the_prefix_rows(monkeypatch):
    """paligemma-3b's [4, 8, 2048, 256] with prefix 256 on one KV head: 4
    CTAs a key block (BWD_CTA_ROWS of its 16,384-row walks), each flushing
    every BWD_FLUSH_ROWS (flush_steps before the stream); seamless-m4t's
    every-key [4, 16, 2048,
    64] on 16 KV heads: one CTA a key block, flushing, its scratch handed
    on; a prefix call handed no flush is refused before any launch."""
    lib = _Recorder()
    monkeypatch.setattr(fab.runtime, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(fab.runtime, "library", lambda name: lib)
    monkeypatch.setattr(fab.runtime, "stream_of", lambda x: None)
    monkeypatch.setattr(fab.torch.cuda, "device", lambda d: contextlib.nullcontext())
    for b, h, kv, hd, prefix, split in ((4, 8, 1, 256, 256, 4), (4, 16, 16, 64, 2048, 1)):
        q = torch.zeros(b, h, 2048, hd, dtype=torch.bfloat16)
        k = torch.zeros(b, kv, 2048, hd, dtype=torch.bfloat16)
        lse = torch.zeros(b, h, 2048)
        bq = _dkdv_bq(hd, hd)
        _, _, _, part, n = fab.bwd_tc_launch(q, k, k, q, q, lse, 0.0625, prefix=prefix)
        assert (lib.args[23], lib.args[-2]) == (n, fab.BWD_FLUSH_ROWS // bq) == (
            split, fab.BWD_FLUSH_ROWS // bq), prefix
        assert lib.args[-4] == prefix  # prefix, softcap, flush_steps, stream
        assert part is not None and lib.args[10] == part.data_ptr()
        assert tuple(part.shape) == (split, b, kv, 2048, 2 * hd)
        lib.args = None
        with pytest.raises(ValueError, match="dkdv run of"):
            fab.bwd_tc_launch(q, k, k, q, q, lse, 0.0625, prefix=prefix, flush_steps=0)
        assert lib.args is None


def _partials(case, kv_split, flush_steps):
    arrays, mask = cases._inputs(case)
    q, k, v, do = (torch.from_numpy(x) for x in arrays)
    out, lse = flash_attention(q, k, v, **mask, return_lse=True)
    delta = (do * out).sum(-1)
    part = fab.kv_split_partials_plain(q, k, v, do, lse, delta, kv_split, **mask, keys=16,
                                       rows=16, flush_steps=flush_steps)
    return arrays, mask, (q, k, v, out, do), part


def _partial_sums(case, kv_split):
    arrays, mask, (q, k, v, out, do), part = _partials(case, kv_split, flush_steps=1)
    steps = q.shape[1] // k.shape[1] * -(-q.shape[2] // 16)
    assert min(len(cta) for cta in fab.dkdv_runs(steps, kv_split, 1)) > 1
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    scale = 1 / math.sqrt(q.shape[3])
    fab.kv_reduce(part, dk, dv, kv_split, scale)
    _, dk_plain, dv_plain = fab.flash_attention_bwd_plain(q, k, v, out, do, bk=16, **mask)
    assert cases._rel(dk, dk_plain.numpy()) <= SUM_TOL, cases._rel(dk, dk_plain.numpy())
    assert cases._rel(dv, dv_plain.numpy()) <= SUM_TOL, cases._rel(dv, dv_plain.numpy())
    _, dk_want, dv_want = cases._jax_grads(case, arrays, jnp.float32)
    assert cases._rel(dk, dk_want) <= cases.F32_TOL
    assert cases._rel(dv, dv_want) <= cases.F32_TOL


@pytest.mark.parametrize("case", ["G 8", "softcap", "window"])
def test_partials_over_several_runs_sum_to_the_unsplit_plain(case):
    """Blocks of 16 keys and 16 query rows, 2 CTAs a key block flushing
    every step: several runs a CTA.  The partials' fixed-order sum equals
    the unsplit plain dK and dV within f32 rounding, and jax.vjp of
    full_attention within the f32 bound."""
    _partial_sums(case, 2)


@pytest.mark.parametrize("case", ["G 8", "softcap", "window", "prefix", "cross"])
def test_one_cta_flushing_every_step_sums_to_the_unsplit_plain(case):
    """The same at one CTA a key block (a flushing call whose key blocks
    fill the SMs: the encoder-decoder's every-key and cross calls), every
    mask kind: its partial, scaled and rounded, is dK and dV."""
    _partial_sums(case, 1)


def test_runs_add_into_the_partial_in_order():
    """A CTA's partial is its runs' sums added in order, each run from 0:
    flushing every step, part[z] is ((run 0) + run 1) + ..., the one-run
    partial's value within f32 rounding."""
    _, _, _, many = _partials("G 8", 2, flush_steps=1)
    _, _, _, one = _partials("G 8", 2, flush_steps=0)
    assert torch.allclose(many, one, rtol=SUM_TOL, atol=SUM_TOL)
    assert many.abs().sum() > 0
