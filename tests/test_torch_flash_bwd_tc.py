"""The flash backward's tensor-core route, its host decisions and the
log-sum-exp it reads from the forward, on the CPU.

Pinned here: :func:`bwd_route` (bf16 at every width the backward takes,
64, 128, 256 and (192, 128), with five TMA-aligned tensors is ``"tc"``, the
model's transposed views included; anything else, an f32 call, another
width, a misaligned stride or base, is ``"simt"``); the route's block plan
and shared memory (within 227 KB at all four widths, refused elsewhere);
:func:`plan_bwd_kv_split` (1 at qwen3-0.6b's training shape, more at the
one-KV-head rows of gemma-2b, recurrentgemma and paligemma); the split's
fixed-order sum (``kv_split_plain``) against ``jax.vjp`` of ``repro``'s
``full_attention`` at f32; ``flash_attention_plain(..., return_lse=True)`` against
``jax.nn.logsumexp`` of ``repro``'s masked, scaled and capped scores on the
inputs of ``test_torch_flash_grad.py``'s ``CASES`` (f32, ``LSE_TOL``
relative); ``flash_attention_bwd_plain`` given the forward's lse against
the one that recomputes it (f32 rounding); ``FlashAttentionFn`` on the CPU
through the lse flow against autograd of the reference; a planted fault
(lse one row off) that must miss the f32 bound; and the CUDA branches
through a stand-in library: a ``tc`` call (hd 256 and (192, 128) too) goes
to the tensor-core entry with its blocks, its split and the forward's lse,
then (split) to the fixed-order sum, and counts under both names, a failed
one raises and never re-routes, the forward writes an lse only ahead of a
``tc`` backward.
"""

import contextlib
import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn

import test_torch_flash_grad as cases
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention.flash_attention import (
    LSE_HEAD_PAIRS, SMEM_LIMIT, flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import remop_flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

BF16 = torch.bfloat16
# The plain lse against jax.nn.logsumexp, both f32 over the same scores:
# they differ by summation order only.
LSE_TOL = 1e-5
# Given the forward's lse the plain backward differs from the one that
# recomputes it by the f32 rounding of lse (a few ulps of |lse| ~ 5).
RECOMPUTE_TOL = 1e-6
# bf16 inputs through the lse flow against autograd of the f32 reference on
# the same (rounded) inputs: each gradient is rounded once to bf16 (2^-9).
BF16_GRAD_TOL = 1e-2


def _bf16(*shape, seed=0, gain=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * gain).to(BF16)


def _five(b, h, kv, s, t, hd, dtype=BF16):
    q, k, v = _bf16(b, h, s, hd, seed=1), _bf16(b, kv, t, hd, seed=2), _bf16(b, kv, t, hd, seed=3)
    out, dout = _bf16(b, h, s, hd, seed=4), _bf16(b, h, s, hd, seed=5)
    return tuple(x.to(dtype) for x in (q, k, v, out, dout))


def _model_layout(b, heads, s, hd, seed):
    return _bf16(b, s, heads, hd, seed=seed).transpose(1, 2)


def _misaligned_stride(b, heads, s, hd, seed):
    """[B, heads, S, hd] whose position stride is hd + 4 (not a multiple of 8)."""
    return _bf16(b, heads, s, hd + 4, seed=seed)[..., :hd]


def _misaligned_base(b, heads, s, hd, seed):
    """Dense [B, heads, S, hd] starting 2 bytes past a 16-byte boundary."""
    flat = _bf16(b * heads * s * hd + 1, seed=seed)
    return flat[1:].view(b, heads, s, hd)


def _route_case(name):
    b, h, kv, s, t = 1, 4, 2, 40, 40
    if name == "bf16 64":
        return _five(b, h, kv, s, t, 64)
    if name == "bf16 128":
        return _five(b, h, kv, s, t, 128)
    if name == "model layout":
        return (_model_layout(b, h, s, 128, 1), _model_layout(b, kv, t, 128, 2),
                _model_layout(b, kv, t, 128, 3), _model_layout(b, h, s, 128, 4),
                _model_layout(b, h, s, 128, 5))
    if name == "f32 128":
        return _five(b, h, kv, s, t, 128, torch.float32)
    if name in ("bf16 256", "bf16 32", "bf16 16"):
        return _five(b, h, kv, s, t, int(name.split()[1]))
    if name == "bf16 256 misaligned":
        five = list(_five(b, h, kv, s, t, 256))
        five[0] = _misaligned_stride(b, h, s, 256, 9)
        return tuple(five)
    if name == "mla 192/128":
        q, k, _, _, _ = _five(b, h, kv, s, t, 192)
        _, _, v, out, dout = _five(b, h, kv, s, t, 128)
        return q, k, v, out, dout
    five = list(_five(b, h, kv, s, t, 128))
    which, kind = name.split(" ", 1)
    i = ("q", "k", "v", "out", "dout").index(which)
    make = _misaligned_stride if kind == "misaligned stride" else _misaligned_base
    heads, rows = (kv, t) if which in ("k", "v") else (h, s)
    five[i] = make(b, heads, rows, 128, 9)
    return tuple(five)


@pytest.mark.parametrize("name,want", [
    ("bf16 64", "tc"), ("bf16 128", "tc"), ("model layout", "tc"),
    ("f32 128", "simt"), ("bf16 256", "tc"), ("mla 192/128", "tc"), ("bf16 32", "simt"),
    ("bf16 16", "simt"),
    ("q misaligned stride", "simt"), ("k misaligned stride", "simt"),
    ("dout misaligned stride", "simt"), ("v misaligned base", "simt"),
    ("out misaligned base", "simt"), ("dout misaligned base", "simt"),
])
def test_bwd_route(name, want):
    five = _route_case(name)
    assert all(x.stride(-1) == 1 for x in five)
    assert fab.bwd_route(*five) == want


@pytest.mark.parametrize("hd,hd_v,want", [
    (64, 64, {"dq": (128, 64), "dkdv": (128, 64)}),
    (128, 128, {"dq": (128, 64), "dkdv": (128, 64)}),
    (256, 256, {"dq": (64, 64), "dkdv": (64, 64)}),
    (192, 128, {"dq": (128, 64), "dkdv": (64, 64)}),
])
def test_tc_plan_fits_shared_memory(hd, hd_v, want):
    assert (hd, hd_v) in LSE_HEAD_PAIRS  # the forward writes the lse the route reads
    plan = fab.plan_bwd_tc_blocks(hd, hd_v)
    assert plan == want
    for kernel, pairs in fab.BWD_TC_BLOCKS[(hd, hd_v)].items():
        for rows, block in pairs:
            assert fab.bwd_tc_smem_bytes(kernel, rows, block, hd, hd_v) <= SMEM_LIMIT == 232_448
            fab.check_bwd_tc_blocks(kernel, rows, block, hd, hd_v)
    # Q (hd) and dO (hd_v) of the dq rows, two stages of K (hd) and V (hd_v), 7
    # mbarriers, the slack.
    rows, block = plan["dq"]
    assert (fab.bwd_tc_smem_bytes("dq", rows, block, hd, hd_v)
            == 1024 + 2 * rows * (hd + hd_v) + 4 * block * (hd + hd_v) + 56)
    rows, block = plan["dkdv"]
    exchange = 64 * block * 4 if rows == 64 else 0  # dkdv_wg's P^T
    assert (fab.bwd_tc_smem_bytes("dkdv", rows, block, hd, hd_v)
            == 1024 + 2 * rows * (hd + hd_v) + 4 * block * (hd + hd_v) + 4 * block * 4
            + exchange + 56)
    if hd == 256:  # 128 query rows of dq, or dK and dV of 128 keys, would not fit
        assert fab.bwd_tc_smem_bytes("dq", 128, 64, 256) > SMEM_LIMIT


@pytest.mark.parametrize("hd,hd_v", [(16, 16), (256, 128), (32, 32), (128, 64)])
def test_tc_plan_refuses_other_widths(hd, hd_v):
    with pytest.raises(ValueError, match="tensor-core backward"):
        fab.plan_bwd_tc_blocks(hd, hd_v)
    assert (hd, hd_v) not in fab.BWD_TC_HEAD_PAIRS


@pytest.mark.parametrize("kernel,rows,block", [("dq", 64, 64), ("dq", 128, 128),
                                               ("dkdv", 64, 64), ("dkdv", 128, 128)])
def test_tc_blocks_outside_the_table_are_refused(kernel, rows, block):
    with pytest.raises(ValueError, match="tensor-core backward"):
        fab.check_bwd_tc_blocks(kernel, rows, block, 128, 128)


def _jax_lse(case, arrays):
    """jax.nn.logsumexp over the keys of repro's masked, scaled and capped
    scores, [B, H, S], on the port's layout."""
    q, k, _, _ = arrays
    b, h, kv, s, t, hd, _, window, _, softcap, _ = cases.CASES[case]
    q_pos, kv_pos = cases._positions(case)
    kj = jnp.repeat(jnp.asarray(k), h // kv, axis=1)
    sc = jnp.einsum("bhsd,bhtd->bhst", jnp.asarray(q), kj) * (1.0 / math.sqrt(hd))
    if softcap:
        sc = jnp.tanh(sc / softcap) * softcap
    mask = jattn._mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), window)[:, None]
    return np.asarray(jax.nn.logsumexp(jnp.where(mask, sc, -jnp.inf), axis=-1))


@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_plain_lse_matches_jax_logsumexp(case):
    arrays, mask = cases._inputs(case)
    q, k, v = (torch.from_numpy(x) for x in arrays[:3])
    out, lse = flash_attention_plain(q, k, v, **mask, return_lse=True)
    assert torch.equal(out, flash_attention_plain(q, k, v, **mask))
    want = _jax_lse(case, arrays)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert cases._rel(lse, want) <= LSE_TOL, cases._rel(lse, want)
    np.testing.assert_allclose(lse.numpy(), want, rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_plain_backward_with_the_forward_lse_equals_the_recompute(case):
    arrays, mask = cases._inputs(case)
    q, k, v, do = (torch.from_numpy(x) for x in arrays)
    out, lse = flash_attention(q, k, v, **mask, return_lse=True)
    given = fab.flash_attention_bwd_plain(q, k, v, out, do, **mask, lse=lse)
    recomputed = fab.flash_attention_bwd_plain(q, k, v, out, do, **mask)
    for g, r in zip(given, recomputed):
        assert cases._rel(g, r.double().numpy()) <= RECOMPUTE_TOL
    assert fab.flash_attention_bwd(q, k, v, out, do, lse=lse, **mask)[0].equal(given[0])


@pytest.mark.parametrize("case", ["causal", "prefix", "window", "cross"])
def test_planted_fault_lse_one_row_off_misses_the_f32_bound(case):
    arrays, mask = cases._inputs(case)
    q, k, v, do = (torch.from_numpy(x) for x in arrays)
    out, lse = flash_attention(q, k, v, **mask, return_lse=True)
    want = cases._jax_grads(case, arrays, jnp.float32)
    good = fab.flash_attention_bwd_plain(q, k, v, out, do, **mask, lse=lse)
    assert max(cases._rel(g, w) for g, w in zip(good, want)) <= cases.F32_TOL
    shifted = torch.roll(lse, 1, dims=2)
    bad = fab.flash_attention_bwd_plain(q, k, v, out, do, **mask, lse=shifted)
    worst = max(cases._rel(g, w) for g, w in zip(bad, want))
    assert worst > 10 * cases.F32_TOL, worst


def _spy_lse(monkeypatch):
    """Records whether each plain backward was handed the forward's lse."""
    seen, plain = [], fab.flash_attention_bwd_plain

    def spy(*args, **kwargs):
        seen.append(kwargs.get("lse") is not None)
        return plain(*args, **kwargs)

    monkeypatch.setattr(fab, "flash_attention_bwd_plain", spy)
    return seen


def _reference_grads(q, k, v, do, mask):
    qs, ks, vs = (x.detach().float().requires_grad_() for x in (q, k, v))
    if mask["window"]:
        ref = flash_attention_plain(qs, ks, vs, **mask)
    else:
        ref = flash_attention_ref(qs, ks, vs, prefix=mask["prefix"], softcap=mask["softcap"])
    return torch.autograd.grad(ref, (qs, ks, vs), do.float())


@pytest.mark.parametrize("case", ["causal", "window", "prefix", "cross", "softcap"])
def test_function_takes_the_lse_flow_in_bf16(case, monkeypatch):
    """bf16 at hd 64 routes ``tc``: the forward returns its lse and the
    backward is handed it; the gradients match autograd of the f32
    reference on the same inputs within one bf16 rounding."""
    arrays, mask = cases._inputs(case)
    rng = np.random.default_rng(7)
    b, h, kv, s, t = cases.CASES[case][:5]
    gain = cases.CASES[case][10]
    q = torch.from_numpy(rng.standard_normal((b, h, s, 64)).astype(np.float32) * gain).to(BF16)
    k, v = (torch.from_numpy(rng.standard_normal((b, kv, t, 64)).astype(np.float32)).to(BF16)
            for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((b, h, s, 64)).astype(np.float32)).to(BF16)
    assert fab.bwd_route(q, k, v, q, do) == "tc"
    seen = _spy_lse(monkeypatch)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = remop_flash_attention(qg, kg, vg, **mask)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    assert seen == [True]
    for g, w in zip(got, _reference_grads(q, k, v, do, mask)):
        assert g.dtype == BF16
        assert cases._rel(g.float(), w.double().numpy()) <= BF16_GRAD_TOL


@pytest.mark.parametrize("case", ["causal", "window", "prefix", "cross", "softcap"])
def test_function_lse_flow_matches_autograd_of_the_reference_in_f32(case, monkeypatch):
    """The same flow in f32 (the route rule bent to ``tc``) against autograd
    of the reference, at the f32 bound; the simt flow recomputes lse."""
    arrays, mask = cases._inputs(case)
    q, k, v, do = (torch.from_numpy(x) for x in arrays)
    want = _reference_grads(q, k, v, do, mask)
    seen = _spy_lse(monkeypatch)
    for route in ("simt", "tc"):
        monkeypatch.setattr(fab, "bwd_route", lambda *xs, route=route: route)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        got = torch.autograd.grad(remop_flash_attention(qg, kg, vg, **mask), (qg, kg, vg), do)
        for g, w in zip(got, want):
            assert cases._rel(g, w.double().numpy()) <= cases.F32_TOL
    assert seen == [False, True]


# -- the CUDA branches through a stand-in library ------------------------------------
# (the forward's entry without an lse keeps its arguments: test_torch_prefix.py)

class _FakeLibrary:
    def __init__(self, tc_error=0):
        self.calls, self.tc_error = [], tc_error

    def remop_flash_attention_bwd_tc(self, *args):
        self.calls.append(("bwd_tc", args))
        self.strides = ctypes.cast(args[11], ctypes.POINTER(ctypes.c_longlong))[:24]
        return self.tc_error

    def remop_flash_attention_bwd_kv_reduce(self, *args):
        self.calls.append(("kv_reduce", args))
        self.reduce_strides = ctypes.cast(args[3], ctypes.POINTER(ctypes.c_longlong))[:24]
        return 0

    def remop_flash_attention_bwd_bf16(self, *args):
        self.calls.append(("bwd_bf16", args))
        return 0

    def remop_flash_attention_bwd_f32(self, *args):
        self.calls.append(("bwd_f32", args))
        return 0

    def remop_flash_attention_tc(self, *args):
        self.calls.append(("fwd_tc", args))
        return 0

    def remop_flash_attention_tc_lse(self, *args):
        self.calls.append(("fwd_tc_lse", args))
        return 0

    def remop_flash_attention_bf16(self, *args):
        self.calls.append(("fwd_bf16", args))
        return 0

    def remop_flash_attention_bwd_error_string(self, err):
        return b"an illegal memory access was encountered"


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(runtime, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(runtime, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    runtime.reset_launches()

    def install(lib):
        monkeypatch.setattr(runtime, "library", lambda name: lib)
        return lib

    yield install
    runtime.reset_launches()


def test_tc_calls_go_to_the_tc_entry_point_and_count(fake_card):
    lib = fake_card(_FakeLibrary())
    q, k, v, out, dout = _five(2, 16, 8, 300, 300, 128)
    lse = torch.zeros(2, 16, 300)
    dq, dk, dv = fab.flash_attention_bwd(q, k, v, out, dout, lse=lse)
    (name, args), = lib.calls
    assert name == "bwd_tc"
    assert args[8] == lse.data_ptr() and args[10] is None  # no split: no partials
    assert lib.strides == [st for x in (q, k, v, out, dout, dq, dk, dv) for st in x.stride()[:3]]
    # b h kv s t hd hd_v, the blocks, kv_split
    assert args[12:24] == (2, 16, 8, 300, 300, 128, 128, 128, 64, 128, 64, 1)
    assert args[24] == pytest.approx(1 / math.sqrt(128))
    assert dict(runtime.launches) == {"flash_attention_bwd": 1, "flash_attention_bwd_tc": 1}
    with pytest.raises(ValueError, match="log-sum-exp"):
        fab.flash_attention_bwd(q, k, v, out, dout)
    with pytest.raises(ValueError, match="lse must be"):
        fab.flash_attention_bwd(q, k, v, out, dout, lse=lse[:, :, 1:])


@pytest.mark.parametrize("name,entry", [("f32 128", "bwd_f32"), ("bf16 256 misaligned", "bwd_bf16"),
                                        ("dout misaligned stride", "bwd_bf16")])
def test_other_calls_go_to_the_cuda_core_entry_point(fake_card, name, entry):
    lib = fake_card(_FakeLibrary())
    fab.flash_attention_bwd(*_route_case(name), lse=torch.zeros(1, 4, 40))
    (called, _), = lib.calls
    assert called == entry
    assert dict(runtime.launches) == {"flash_attention_bwd": 1, "flash_attention_bwd_simt": 1}


def test_a_failed_tc_call_raises_and_never_reroutes(fake_card):
    lib = fake_card(_FakeLibrary(tc_error=700))
    five = _five(1, 4, 2, 64, 64, 64)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fab.flash_attention_bwd(*five, lse=torch.zeros(1, 4, 64))
    assert [name for name, _ in lib.calls] == ["bwd_tc"]
    assert sum(runtime.launches.values()) == 0


@pytest.mark.parametrize("hd,lse_written", [(128, True), (64, True), (256, True)])
def test_the_forward_writes_lse_only_ahead_of_a_tc_backward(fake_card, hd, lse_written):
    lib = fake_card(_FakeLibrary())
    q, k, v = (_model_layout(1, n, 256, hd, seed) for n, seed in ((8, 1), (2, 2), (2, 3)))
    qg, kg, vg = (x.requires_grad_() for x in (q, k, v))
    out = remop_flash_attention(qg, kg, vg)
    (name, args), = lib.calls
    assert name == ("fwd_tc_lse" if lse_written else "fwd_tc")
    if lse_written:
        assert len(args) == 21 and args[-2] is not None  # the lse pointer, before the stream
    torch.autograd.grad(out, (qg, kg, vg), torch.ones_like(out))
    # 2 KV heads of 256 keys leave most SMs idle: dkdv_wg (hd 256) splits and
    # its sum follows; dkdv_tc (64, 128) never splits.
    assert [n for n, _ in lib.calls[1:]] == ["bwd_tc"] + (["kv_reduce"] if hd == 256 else [])
    assert lib.calls[1][1][8] == args[-2]  # the forward's lse, handed on


def test_capped_plan_avoids_the_spilling_instantiation():
    """The capped dkdv at hd 128 spills at 64 query rows a block: the plan
    takes 32 there, and keeps 64 everywhere else."""
    assert fab.plan_bwd_tc_blocks(128, 128, capped=True) == {"dq": (128, 64), "dkdv": (128, 32)}
    assert fab.plan_bwd_tc_blocks(64, 64, capped=True) == {"dq": (128, 64), "dkdv": (128, 64)}
    for kernel, hd, capped, blocks in fab.BWD_TC_SPILLS:
        assert blocks in fab.BWD_TC_BLOCKS[(hd, hd)][kernel]
        assert fab.plan_bwd_tc_blocks(hd, hd, capped)[kernel] != blocks


def test_a_capped_tc_call_takes_the_capped_plan(fake_card):
    lib = fake_card(_FakeLibrary())
    q, k, v, out, dout = _five(1, 4, 2, 64, 64, 128)
    fab.flash_attention_bwd(q, k, v, out, dout, softcap=50.0, lse=torch.zeros(1, 4, 64))
    (name, args), = lib.calls
    assert name == "bwd_tc" and args[19:23] == (128, 64, 128, 32)


@pytest.mark.parametrize("hd,hd_v", [(32, 32), (16, 16)])
def test_the_forward_writes_lse_at_the_backward_widths_only(fake_card, hd, hd_v):
    """The tensor-core forward is built to write lse at the backward's
    widths (64, 128, 256 and (192, 128)) only: a CUDA call elsewhere that
    asks for it raises before any launch."""
    lib = fake_card(_FakeLibrary())
    q, k = _bf16(1, 4, 128, hd, seed=1), _bf16(1, 2, 128, hd, seed=2)
    v = _bf16(1, 2, 128, hd_v, seed=3)
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention(q, k, v, bq=64, bk=64, return_lse=True)
    assert lib.calls == []


# -- dkdv split over CTAs where KV heads are few ---------------------------------------

@pytest.mark.parametrize("name,shape,keys,want", [
    # (b, kv, t, group): 4 x 8 x 16 = 512 CTAs of 128 keys fill the card alone.
    ("qwen3-0.6b train", (4, 8, 2048, 2), 128, 1),
    # one KV head: 32, 64 and 12 CTAs of 64 keys, split as far as two waves hold
    ("gemma-2b", (1, 1, 2048, 8), 64, 8),
    ("recurrentgemma window", (1, 1, 4096, 10), 64, 4),
    ("paligemma prefix", (1, 1, 768, 8), 64, 16),
    # 16 KV heads of MLA: 512 CTAs
    ("mla 192/128", (1, 16, 2048, 1), 64, 1),
])
def test_kv_split_plan(name, shape, keys, want):
    b, kv, t, group = shape
    got = fab.plan_bwd_kv_split(b, kv, t, group, keys)
    assert got == want, (name, got)
    # A pure function of its arguments: the same answer again, and the SM
    # count an argument (a card of 66 SMs splits half as far).
    assert fab.plan_bwd_kv_split(b, kv, t, group, keys) == got
    assert fab.plan_bwd_kv_split(b, kv, t, group, keys, sms=132) == got
    ctas = b * kv * -(-t // keys)
    assert fab.plan_bwd_kv_split(b, kv, t, group, keys, sms=66) == (
        1 if ctas >= 66 else min(132 // ctas, fab.BWD_KV_SPLIT_MAX))
    if want > 1:  # two waves' worth of CTAs, short of the cap
        assert want * ctas <= 264 < (want + 1) * ctas or want == fab.BWD_KV_SPLIT_MAX


def test_kv_split_plan_caps_the_scratch_and_refuses_nonsense():
    assert fab.plan_bwd_kv_split(1, 1, 64, 16, 64) == fab.BWD_KV_SPLIT_MAX
    with pytest.raises(ValueError, match="positive sizes"):
        fab.plan_bwd_kv_split(1, 0, 64, 16, 64)


def _split_grads(case, kv_split, runs=None, scale=None):
    """dk, dv through the split's plain partials (blocks of 16 keys and 16
    query rows, so that runs end inside a head's query blocks) and the plain
    fixed-order sum of the first ``runs`` of them (default all)."""
    arrays, mask = cases._inputs(case)
    q, k, v, do = (torch.from_numpy(x) for x in arrays)
    out, lse = flash_attention(q, k, v, **mask, return_lse=True)
    delta = (do * out).sum(-1)
    part = fab.kv_split_partials_plain(q, k, v, do, lse, delta, kv_split, **mask, keys=16,
                                       rows=16)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    scale = 1 / math.sqrt(q.shape[3]) if scale is None else scale
    fab.kv_reduce(part, dk, dv, runs or kv_split, scale)
    return arrays, (dk, dv)


@pytest.mark.parametrize("kv_split", [1, 3, 8])
@pytest.mark.parametrize("case", ["G 8", "window", "prefix", "cross", "softcap"])
def test_split_sum_matches_jax_vjp(case, kv_split):
    """The split's fixed-order sum (each run's f32 partial dK and dV, then
    part[0] + part[1] + ..., dK times scale) in PyTorch against jax.vjp of
    full_attention (f32, ``F32_TOL``)."""
    arrays, (dk, dv) = _split_grads(case, kv_split)
    _, dk_want, dv_want = cases._jax_grads(case, arrays, jnp.float32)
    assert cases._rel(dk, dk_want) <= cases.F32_TOL, cases._rel(dk, dk_want)
    assert cases._rel(dv, dv_want) <= cases.F32_TOL, cases._rel(dv, dv_want)


@pytest.mark.parametrize("fault", ["the last run dropped", "dK's scale dropped"])
def test_split_sum_planted_faults_miss_the_f32_bound(fault):
    """Planted faults of the sum, G 8 on one KV head in 3 runs: the last
    run's partial left out, or dK's scale; each must miss the bound by far."""
    if fault == "the last run dropped":
        arrays, (dk, dv) = _split_grads("G 8", 3, runs=2)
    else:
        arrays, (dk, dv) = _split_grads("G 8", 3, scale=1.0)
    _, dk_want, dv_want = cases._jax_grads("G 8", arrays, jnp.float32)
    assert cases._rel(dk, dk_want) > 10 * cases.F32_TOL
    if fault == "the last run dropped":
        assert cases._rel(dv, dv_want) > 10 * cases.F32_TOL


def test_the_plain_sum_adds_in_split_order():
    """kv_reduce's plain version: ((part[0] + part[1]) + part[2]) in f32, dK
    times scale, each rounded once to dk's dtype; the runs past kv_split unread."""
    g = torch.Generator().manual_seed(3)
    part = torch.randn(4, 1, 2, 5, 12, generator=g) * torch.tensor([1e8, 1.0, -1e8, 1e-3])[
        :, None, None, None, None]
    dk, dv = torch.empty(1, 2, 5, 8, dtype=BF16), torch.empty(1, 2, 5, 4, dtype=BF16)
    fab.kv_reduce(part, dk, dv, 3, 0.125)
    total = (part[0] + part[1]) + part[2]
    assert torch.equal(dk, (total[..., :8] * 0.125).to(BF16))
    assert torch.equal(dv, total[..., 8:].to(BF16))
    with pytest.raises(ValueError, match="does not hold"):
        fab.kv_reduce(part, dk, dv, 5, 0.125)


@pytest.mark.parametrize("hd,hd_v,kv,split", [(256, 256, 1, 8), (192, 128, 16, 1)])
def test_wide_calls_go_to_the_tc_entry_point(fake_card, hd, hd_v, kv, split):
    """hd 256 (gemma-2b's one KV head: dkdv split 8 ways, then summed) and
    (192, 128) (MLA's 16 KV heads: no split) take the tensor-core entry."""
    lib = fake_card(_FakeLibrary())
    q, k = _bf16(1, 8 if kv == 1 else 16, 2048, hd, seed=1), _bf16(1, kv, 2048, hd, seed=2)
    v = _bf16(1, kv, 2048, hd_v, seed=3)
    out, dout = (_bf16(*q.shape[:3], hd_v, seed=s) for s in (4, 5))
    h = q.shape[1]
    lse = torch.zeros(1, h, 2048)
    dq, dk, dv = fab.flash_attention_bwd(q, k, v, out, dout, lse=lse)
    names = [name for name, _ in lib.calls]
    assert names == (["bwd_tc", "kv_reduce"] if split > 1 else ["bwd_tc"])
    args = lib.calls[0][1]
    plan = fab.plan_bwd_tc_blocks(hd, hd_v)
    assert args[12:24] == (1, h, kv, 2048, 2048, hd, hd_v, *plan["dq"], *plan["dkdv"], split)
    assert (args[10] is None) == (split == 1)
    if split > 1:
        part, rdk, rdv, _, *rest = lib.calls[1][1]
        assert part == args[10] and (rdk, rdv) == (dk.data_ptr(), dv.data_ptr())
        assert tuple(rest[:6]) == (1, kv, 2048, hd, hd_v, split)
        assert rest[6] == pytest.approx(1 / math.sqrt(hd))
        assert lib.reduce_strides[18:] == [st for x in (dk, dv) for st in x.stride()[:3]]
    assert dict(runtime.launches) == {"flash_attention_bwd": 1, "flash_attention_bwd_tc": 1}


@pytest.mark.parametrize("hd", [128, 64])
def test_long_dkdv_tc_walks_split_then_sum(fake_card, hd):
    """8 heads on one KV head of 2048 keys: a walk of 16,384 (head, query)
    rows a key block, so dkdv_tc flushes every BWD_FLUSH_ROWS rows and, its
    16 key blocks leaving most SMs idle, takes each key block in 16 CTAs
    of its own (the occupancy split), then the sum."""
    lib = fake_card(_FakeLibrary())
    q, k, v = _bf16(1, 8, 2048, hd, seed=1), _bf16(1, 1, 2048, hd, seed=2), _bf16(1, 1, 2048,
                                                                                 hd, seed=3)
    out, dout = (_bf16(1, 8, 2048, hd, seed=s) for s in (4, 5))
    dq, dk, dv = fab.flash_attention_bwd(q, k, v, out, dout, softcap=50.0,
                                         lse=torch.zeros(1, 8, 2048))
    assert [name for name, _ in lib.calls] == ["bwd_tc", "kv_reduce"]
    args = lib.calls[0][1]
    plan = fab.plan_bwd_tc_blocks(hd, hd, capped=True)
    assert args[12:24] == (1, 8, 1, 2048, 2048, hd, hd, *plan["dq"], *plan["dkdv"], 16)
    assert args[-2] * plan["dkdv"][1] == fab.BWD_FLUSH_ROWS  # flush_steps, before the stream
    part, rdk, rdv, _, *rest = lib.calls[1][1]
    assert part == args[10] and (rdk, rdv) == (dk.data_ptr(), dv.data_ptr())
    assert tuple(rest[:6]) == (1, 1, 2048, hd, hd, 16)
    assert dict(runtime.launches) == {"flash_attention_bwd": 1, "flash_attention_bwd_tc": 1}


@pytest.mark.parametrize("hd,hd_v,s,prefix", [
    (256, 256, 128, 0), (192, 128, 128, 0),       # 1,024-row walks: no flush
    (256, 256, 2048, 256), (192, 128, 2048, 2048),  # prefix, every key: FLUSH instantiations
])
def test_a_failed_wide_tc_call_raises_and_never_reroutes(fake_card, hd, hd_v, s, prefix):
    """A failed dkdv_wg launch, G 8 on one KV head, flushing or not: the
    error raises, the tc entry was the one call (no kv_reduce, no CUDA-core
    route), no launch is counted; a call without the lse raises before any."""
    lib = fake_card(_FakeLibrary(tc_error=700))
    q, k = _bf16(1, 8, s, hd, seed=1), _bf16(1, 1, s, hd, seed=2)
    v = _bf16(1, 1, s, hd_v, seed=3)
    out, dout = (_bf16(1, 8, s, hd_v, seed=seed) for seed in (4, 5))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fab.flash_attention_bwd(q, k, v, out, dout, prefix=prefix, lse=torch.zeros(1, 8, s))
    (name, args), = lib.calls
    assert name == "bwd_tc"
    assert args[-2] == (fab.BWD_FLUSH_ROWS // 64 if prefix else 0)  # flush_steps
    assert sum(runtime.launches.values()) == 0
    with pytest.raises(ValueError, match="log-sum-exp"):
        fab.flash_attention_bwd(q, k, v, out, dout, prefix=prefix)
    assert [name for name, _ in lib.calls] == ["bwd_tc"]


@pytest.mark.parametrize("b,h,kv,s,t,hd,hd_v,want", [
    (1, 8, 1, 2048, 2048, 256, 256, 8),     # gemma-2b: dkdv_wg on one KV head
    (1, 16, 16, 2048, 2048, 192, 128, 1),   # MLA: 512 CTAs
    (1, 16, 8, 2048, 2048, 128, 128, 2),    # qwen3 at batch 1: 128 CTAs, flushing
    (4, 16, 8, 2048, 2048, 128, 128, 1),    # qwen3's training shape: 512 CTAs
    (1, 16, 16, 300, 200, 64, 64, 1),       # cross-attention: 32 CTAs, dkdv_tc
    (1, 8, 1, 2048, 2048, 128, 128, 16),    # G 8: 16,384 rows a key block, 16 key blocks
    (4, 64, 8, 2048, 2048, 64, 64, 1),      # G 8 on 512 CTAs: no split
    (1, 48, 1, 2048, 2048, 128, 128, 16),   # granite-20b's 48 heads: at the cap
    (4, 64, 8, 2048, 2048, 256, 256, 1),    # hd 256 G 8 on 1024 CTAs: no split
    (1, 10, 1, 4096, 4096, 256, 256, 10),   # recurrentgemma's 10 heads: 40,960-row walks
    (2, 10, 1, 4096, 4096, 256, 256, 10),   # its training shape: 128 CTAs, 10 of 4,096 rows
    (4, 8, 1, 2048, 2048, 256, 256, 4),     # paligemma-3b's: 128 CTAs, 4 of 4,096 rows
])
def test_only_the_two_warpgroup_dkdv_splits(b, h, kv, s, t, hd, hd_v, want):
    """The occupancy split is dkdv_wg's (256 and (192, 128)) and, at hd 64
    and 128, that of a call that flushes (a walk past BWD_RUN_ROWS (head,
    query) rows); a flushing call that splits takes CTAs of at most
    BWD_CTA_ROWS rows of the longest walk; at qwen3-0.6b's training shape
    one CTA a key block, and MLA's without a flush."""
    assert fab.bwd_tc_kv_split(b, h, kv, s, t, hd, hd_v) == want
    flushes = fab.bwd_flushes(h // kv, s)
    assert flushes == (h // kv * s > fab.BWD_RUN_ROWS)
    keys = fab.plan_bwd_tc_blocks(hd, hd_v)["dkdv"][0]
    occupancy = fab.plan_bwd_kv_split(b, kv, t, h // kv, keys)
    if not flushes:
        assert want == (occupancy if (hd, hd_v) in fab.BWD_TC_WG_PAIRS else 1)
    elif occupancy == 1:
        assert want == 1
    else:
        walk = -(-h // kv * s // fab.BWD_CTA_ROWS)
        assert want == min(max(occupancy, walk), fab.BWD_KV_SPLIT_MAX)


def test_run_split_refuses_nonsense():
    with pytest.raises(ValueError, match="positive sizes"):
        fab.plan_bwd_flush_steps(0, 2048, 64)
    with pytest.raises(ValueError, match="positive sizes"):
        fab.bwd_flushes(8, 0)
