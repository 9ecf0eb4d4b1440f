"""The flash backward's flush plan at the shapes ``chip_smoke.py`` checks and
trains, on the CPU.

A call whose key block's walk may pass ``BWD_RUN_ROWS`` (head, query) rows,
or that has a prefix, flushes dkdv's accumulators into its f32 partial every
``BWD_FLUSH_ROWS`` rows; every other call keeps the plan it had before the
flush: one run a CTA, ``kv_split`` 1 at hd 64 / 128 (``dkdv_tc``) and the
occupancy split at 256 and (192, 128) (``dkdv_wg``), no scratch without a
split, one dkdv launch and the sum only where split.  Pinned here, per row
of ``chip_smoke.BWD_CHECKS`` (and the trainers' shapes): the flushing rows'
longest run between flushes; the other rows' plan, entry arguments and
launches through a stand-in library; and the plain backward, which the
kernel is held to, against softmax attention written out densely in f64
on the same inputs (it computes in f64 and rounds once, so the two agree
to the last bit of its f32 output but for ties of that rounding).
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_plain

from test_torch_flash_bwd_tc import _FakeLibrary, fake_card  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_flush", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()
TC_ROWS = {c[0]: c for c in SMOKE.BWD_CHECKS
           if c[-1] == "bfloat16" and (c[6], c[7]) in fab.BWD_TC_HEAD_PAIRS}
FLUSHED = sorted(n for n in TC_ROWS if n not in SMOKE.BWD_UNFLUSHED)


def _plan(row):
    _, b, h, kv, s, t, hd, hd_v, window, prefix, cap, *_ = row
    bq = fab.plan_bwd_tc_blocks(hd, hd_v, cap > 0)["dkdv"][1]
    return (bq, fab.bwd_tc_kv_split(b, h, kv, s, t, hd, hd_v, prefix),
            fab.plan_bwd_flush_steps(h // kv, s, bq, prefix))


@pytest.mark.parametrize("name", FLUSHED)
def test_every_flushing_row_sums_at_most_the_flush_rows(name):
    """Each flushing row's longest accumulator run (every step of key block
    0's walk, each head's query blocks, the CTAs' parts) is at most
    BWD_FLUSH_ROWS rows, and would pass it without the flush wherever its
    parts are longer."""
    _, b, h, kv, s, t, hd, hd_v, window, prefix, *_ = TC_ROWS[name]
    bq, split, flush = _plan(TC_ROWS[name])
    assert flush * bq == fab.BWD_FLUSH_ROWS
    assert fab.bwd_flushes(h // kv, s, prefix)
    longest = fab.longest_bwd_run(h // kv, s, bq, split, flush, prefix)
    assert 0 < longest <= fab.BWD_FLUSH_ROWS
    fab.check_bwd_runs(h // kv, s, bq, split, prefix=prefix)
    n_q = -(-s // bq)
    for cta in fab.dkdv_runs(h // kv * n_q, split, flush):
        assert all(len(run) <= flush for run in cta)
    if fab.longest_bwd_run(h // kv, s, bq, split, 0, prefix) > fab.BWD_FLUSH_ROWS:
        with pytest.raises(ValueError, match="dkdv run of"):
            fab.check_bwd_runs(h // kv, s, bq, split, 0, prefix)


@pytest.mark.parametrize("name", SMOKE.BWD_UNFLUSHED)
def test_rows_that_keep_their_plan_launch_as_before(fake_card, name):
    """A row that does not flush gets the plan it had: ``kv_split`` 1 at hd
    64 / 128, the occupancy split at 256 and (192, 128) (the same numbers
    as before the flush), flush_steps 0, no scratch without a split, the tc
    entry once and the sum only where split."""
    _, b, h, kv, s, t, hd, hd_v, window, prefix, cap, *_ = TC_ROWS[name]
    bq, split, flush = _plan(TC_ROWS[name])
    assert flush == 0 and not fab.bwd_flushes(h // kv, s, prefix)
    wide = (hd, hd_v) in fab.BWD_TC_WG_PAIRS
    before = (fab.plan_bwd_kv_split(b, kv, t, h // kv, 64) if wide else 1)
    assert split == before
    assert fab.longest_bwd_run(h // kv, s, bq, split, 0, prefix) <= fab.BWD_RUN_ROWS
    lib = fake_card(_FakeLibrary())
    q = torch.zeros(b, h, s, hd, dtype=torch.bfloat16)
    k = torch.zeros(b, kv, t, hd, dtype=torch.bfloat16)
    v = torch.zeros(b, kv, t, hd_v, dtype=torch.bfloat16)
    out = torch.zeros(b, h, s, hd_v, dtype=torch.bfloat16)
    fab.flash_attention_bwd(q, k, v, out, out, window=window, prefix=prefix, softcap=cap,
                            lse=torch.zeros(b, h, s))
    assert [n for n, _ in lib.calls] == ["bwd_tc"] + (["kv_reduce"] if split > 1 else [])
    args = lib.calls[0][1]
    assert args[23] == split and args[-2] == 0
    assert (args[10] is None) == (split == 1)


@pytest.mark.parametrize("name", ["seamless encoder train", "seamless cross train",
                                  "granite-moe train", "every key"])
def test_flushing_calls_that_fill_the_sms_write_dk_and_dv_in_one_launch(fake_card, name):
    """A flushing call whose key blocks already fill the SMs (seamless-m4t's
    every-key and cross calls, granite-moe's G 3) runs one dkdv CTA a key
    block: one tc launch handed its flush scratch, no sum after it."""
    _, b, h, kv, s, t, hd, hd_v, window, prefix, cap, *_ = TC_ROWS[name]
    bq, split, flush = _plan(TC_ROWS[name])
    assert split == 1 and flush * bq == fab.BWD_FLUSH_ROWS
    lib = fake_card(_FakeLibrary())
    q = torch.zeros(b, h, s, hd, dtype=torch.bfloat16)
    k = torch.zeros(b, kv, t, hd, dtype=torch.bfloat16)
    v = torch.zeros(b, kv, t, hd_v, dtype=torch.bfloat16)
    out = torch.zeros(b, h, s, hd_v, dtype=torch.bfloat16)
    fab.flash_attention_bwd(q, k, v, out, out, window=window, prefix=prefix, softcap=cap,
                            lse=torch.zeros(b, h, s))
    (call, args), = lib.calls
    assert call == "bwd_tc" and args[23] == 1 and args[-2] == flush and args[10] is not None


def _dense_f64(q, k, v, out, dout, scale, window, prefix, softcap):
    """Softmax attention's gradients written out densely in f64."""
    b, h, s, hd = q.shape
    kv, t = k.shape[1], k.shape[2]
    g = h // kv
    kd, vd = (x.double().repeat_interleave(g, 1) for x in (k, v))
    qd, dod = q.double(), dout.double()
    raw = torch.einsum("bhsd,bhtd->bhst", qd, kd) * scale
    sc = torch.tanh(raw / softcap) * softcap if softcap else raw
    qpos = torch.arange(s)[:, None] + (t - s)
    kpos = torch.arange(t)[None, :]
    seen = (kpos <= qpos) | (kpos < prefix)
    if window:
        seen &= kpos > qpos - window
    p = torch.softmax(sc.masked_fill(~seen, float("-inf")), -1).nan_to_num()
    ds = p * (torch.einsum("bhsd,bhtd->bhst", dod, vd)
              - (dod * out.double()).sum(-1, keepdim=True))
    if softcap:
        ds = ds * (1 - (sc / softcap) ** 2)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kd) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qd).view(b, kv, g, t, hd).sum(2) * scale
    dv = torch.einsum("bhst,bhsd->bhtd", p, dod).view(b, kv, g, t, vd.shape[3]).sum(2)
    return dq, dk, dv


@pytest.mark.parametrize("b,h,kv,s,t,mask", [
    (2, 8, 2, 96, 96, {}),                        # causal, G 4
    (1, 4, 1, 130, 130, {"window": 40}),          # window, ragged blocks
    (1, 4, 2, 100, 100, {"prefix": 37}),          # prefix-LM
    (2, 4, 4, 70, 70, {"prefix": 70}),            # every key (an encoder)
    (1, 4, 4, 50, 90, {"prefix": 90}),            # cross-attention, S < T
    (1, 4, 4, 120, 45, {"prefix": 45}),           # cross-attention, S > T
    (1, 4, 2, 64, 64, {"softcap": 5.0}),          # capped
])
def test_the_plain_backward_is_f64_dense_softmax(b, h, kv, s, t, mask):
    """The plain backward (the kernel's reference) on f32 inputs equals the
    dense f64 gradients rounded to f32, to one f32 ulp of each entry."""
    hd = 32
    g = torch.Generator().manual_seed(5)
    q = torch.randn(b, h, s, hd, generator=g) * 2
    k, v = torch.randn(b, kv, t, hd, generator=g), torch.randn(b, kv, t, hd, generator=g)
    dout = torch.randn(b, h, s, hd, generator=g)
    out = flash_attention_plain(q, k, v, **mask)
    scale = 1 / math.sqrt(hd)
    got = fab.flash_attention_bwd_plain(q, k, v, out, dout, **mask)
    want = _dense_f64(q, k, v, out, dout, scale, mask.get("window", 0), mask.get("prefix", 0),
                      mask.get("softcap", 0.0))
    for x, w in zip(got, want):
        assert x.dtype == torch.float32
        ulp = torch.finfo(torch.float32).eps * w.abs().clamp_min(1e-30)
        assert bool(((x.double() - w).abs() <= ulp + 1e-12).all())
