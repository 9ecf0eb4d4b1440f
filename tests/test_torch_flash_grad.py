"""The flash kernel's gradient against JAX's autodiff, on the CPU.

``flash_attention_bwd_plain`` (the backward kernel's arithmetic, which a
CPU tensor takes) is held to ``jax.vjp`` of ``repro``'s ``full_attention``
on the same numpy inputs, at every mask the forward takes: causal, a
window, a prefix (``repro``'s ``mask_pos``), every key, cross-attention
(``q_pos = 10**9``, S != T), a softcap, S < T, GQA groups of 1, 2 and 8,
ragged lengths and the MLA widths (q/k wider than v).  In f32 the bound is
``F32_TOL`` relative L2 per gradient (JAX keeps P in f32 for f32 inputs;
both sum in f32 in other orders).  In bf16 it is ``BF16_TOL``: ``repro``
rounds its scores and P to bf16 and its autodiff rounds dP and dS in bf16
too, where the port keeps them in f32 and rounds each gradient once.  Each
bound is shown sharp by four planted faults (D dropped, dK and dV from head
0 of each group only, the mask one key off, the cap's derivative left out),
each of which must miss it.  ``FlashAttentionFn`` under autograd equals the
plain backward and autograd of ``flash_attention_ref`` (f32, ``F32_TOL``);
its forward equals the no-grad forward bit for bit; without grad no graph
is built.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention.flash_attention import (
    SMEM_LIMIT, flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import remop_flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

F32_TOL = 1e-5
# bf16: repro's scores, P, dP and dS are rounded to bf16 (about 2^-9
# relative each) and summed over up to 77 keys; measured 2.5e-3..4.4e-3.
# The planted faults read 0.15 and more.
BF16_TOL = 1e-2

# (name, b, h, kv, s, t, hd, hd_v, window, prefix, softcap, q gain)
CASES = {
    "causal": (2, 4, 2, 37, 37, 16, 16, 0, 0, 0.0, 1.0),
    "window": (1, 4, 2, 40, 40, 16, 16, 7, 0, 0.0, 1.0),
    "prefix": (1, 4, 2, 30, 30, 16, 16, 0, 9, 0.0, 1.0),
    "every key": (1, 4, 4, 33, 33, 16, 16, 0, 33, 0.0, 1.0),
    "cross": (1, 4, 2, 30, 20, 16, 16, 0, 20, 0.0, 1.0),
    "softcap": (1, 4, 2, 40, 40, 16, 16, 0, 0, 0.5, 2.0),
    "G 1": (1, 4, 4, 36, 36, 16, 16, 0, 0, 0.0, 1.0),
    "G 8": (1, 8, 1, 36, 36, 16, 16, 0, 0, 0.0, 1.0),
    "ragged": (1, 2, 1, 77, 77, 32, 32, 0, 0, 0.0, 1.0),
    "S < T": (1, 4, 2, 20, 45, 16, 16, 0, 0, 0.0, 1.0),
    "mla widths": (1, 4, 4, 33, 33, 24, 16, 0, 0, 0.0, 1.0),
}


def _inputs(case, seed=0):
    b, h, kv, s, t, hd, hd_v, window, prefix, softcap, gain = CASES[case]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, s, hd)) * gain).astype(np.float32)
    k = rng.standard_normal((b, kv, t, hd)).astype(np.float32)
    v = rng.standard_normal((b, kv, t, hd_v)).astype(np.float32)
    do = rng.standard_normal((b, h, s, hd_v)).astype(np.float32)
    return (q, k, v, do), dict(window=window, prefix=prefix, softcap=softcap)


def _positions(case):
    """repro's q_pos and kv_pos for the case's mask."""
    b, _, _, s, t, _, _, _, prefix, _, _ = CASES[case]
    if case == "cross":
        return np.full((b, s), 10 ** 9, np.int32), np.zeros((b, t), np.int32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    if prefix:  # repro's mask_pos: max(pos - P + 1, 0), zeros over every key
        pos = np.maximum(pos - prefix + 1, 0)
    return pos[:, t - s:], pos


def _jax_grads(case, arrays, dtype):
    """jax.vjp of full_attention on the port's [B, H, S, hd] layout."""
    q, k, v, do = arrays
    b, h, kv, s, t, hd, hd_v, window, _, softcap, _ = CASES[case]
    g = h // kv
    q_pos, kv_pos = _positions(case)
    qj = jnp.asarray(q.reshape(b, kv, g, s, hd).transpose(0, 3, 1, 2, 4), dtype)
    kj, vj = (jnp.asarray(x.transpose(0, 2, 1, 3), dtype) for x in (k, v))
    doj = jnp.asarray(do.reshape(b, kv, g, s, hd_v).transpose(0, 3, 1, 2, 4), dtype)

    def attend(q_, k_, v_):
        return jattn.full_attention(q_, k_, v_, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                    window, softcap)

    _, vjp = jax.vjp(attend, qj, kj, vj)
    dq, dk, dv = (np.asarray(x.astype(jnp.float32)) for x in vjp(doj))
    return (dq.transpose(0, 2, 3, 1, 4).reshape(b, h, s, hd), dk.transpose(0, 2, 1, 3),
            dv.transpose(0, 2, 1, 3))


def _port_grads(arrays, mask, dtype, **fault):
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in arrays)
    with torch.no_grad():
        out = flash_attention(q, k, v, **mask)
    if fault.get("no_delta"):
        out = torch.zeros_like(out)
    return fab.flash_attention_bwd_plain(q, k, v, out, do, **mask), (q, k, v, out, do)


def _rel(got, want):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp(case, dtype):
    arrays, mask = _inputs(case)
    want = _jax_grads(case, arrays, getattr(jnp, dtype))
    got, _ = _port_grads(arrays, mask, getattr(torch, dtype))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == getattr(torch, dtype)
        assert _rel(g.float(), w) <= tol, (case, name, _rel(g.float(), w))


def _head0_only(arrays, mask):
    """dK and dV from head 0 of each GQA group only (dq as it should be)."""
    (dq, _, _), (q, k, v, out, do) = _port_grads(arrays, mask, torch.float32)
    g = q.shape[1] // k.shape[1]
    _, dk, dv = fab.flash_attention_bwd_plain(q[:, ::g], k, v, out[:, ::g], do[:, ::g], **mask)
    return dq, dk, dv


def _cap_grad_dropped(arrays, mask, monkeypatch):
    monkeypatch.setattr(fab, "cap_grad", lambda capped, softcap: torch.ones_like(capped))
    return _port_grads(arrays, mask, torch.float32)[0]


@pytest.mark.parametrize("fault", ["drops D", "head 0 only", "mask one key off",
                                   "no cap derivative"])
def test_planted_faults_miss_the_f32_bound(fault, monkeypatch):
    case = {"drops D": "causal", "head 0 only": "G 8", "mask one key off": "prefix",
            "no cap derivative": "softcap"}[fault]
    arrays, mask = _inputs(case)
    want = _jax_grads(case, arrays, jnp.float32)
    if fault == "drops D":
        got = _port_grads(arrays, mask, torch.float32, no_delta=True)[0]
    elif fault == "head 0 only":
        got = _head0_only(arrays, mask)
    elif fault == "mask one key off":
        got = _port_grads(arrays, {**mask, "prefix": mask["prefix"] + 1}, torch.float32)[0]
    else:
        got = _cap_grad_dropped(arrays, mask, monkeypatch)
    worst = max(_rel(g, w) for g, w in zip(got, want))
    assert worst > 10 * F32_TOL and worst > BF16_TOL, (fault, worst)


def test_softcap_case_makes_the_cap_bite():
    """The softcap case's scores pass well into the cap's bend: its
    derivative is below 0.9 for a tenth of the visible scores or more."""
    (q, k, _, _), mask = _inputs("softcap")
    s = np.einsum("bhsd,bhtd->bhst", q, np.repeat(k, 2, axis=1)) / math.sqrt(16)
    capped = np.tanh(s / mask["softcap"])
    visible = np.tril(np.ones((40, 40), bool))
    assert ((1 - capped ** 2)[..., visible] < 0.9).mean() > 0.1


@pytest.mark.parametrize("case", ["causal", "window", "prefix", "cross", "softcap",
                                  "mla widths"])
def test_function_backward_matches_autograd_of_the_reference(case):
    """Through ``remop_flash_attention`` under autograd (FlashAttentionFn,
    the plain backward on the CPU) against autograd of
    ``flash_attention_ref`` (one dense softmax) or, with a window or
    unequal widths (which it does not take), of the plain forward; f32,
    ``F32_TOL``."""
    arrays, mask = _inputs(case)
    q, k, v, do = (torch.from_numpy(x).requires_grad_() for x in arrays)
    out = remop_flash_attention(q, k, v, **mask)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, (q, k, v), do.detach())
    if mask["window"] or q.shape[3] != v.shape[3]:
        ref = flash_attention_plain(q, k, v, **mask)
    else:
        ref = flash_attention_ref(q, k, v, prefix=mask["prefix"], softcap=mask["softcap"])
    want = torch.autograd.grad(ref, (q, k, v), do.detach())
    for g, w in zip(got, want):
        assert _rel(g.detach(), w.detach().double().numpy()) <= F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_forward_equals_the_no_grad_forward(dtype):
    arrays, mask = _inputs("window")
    q, k, v, _ = (torch.from_numpy(x).to(dtype) for x in arrays)
    with torch.no_grad():
        plain = remop_flash_attention(q, k, v, **mask)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    through = remop_flash_attention(qg, kg, vg, **mask)
    assert through.grad_fn is not None
    assert torch.equal(through.detach().view(torch.int16 if dtype == torch.bfloat16
                                             else torch.int32),
                       plain.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_no_graph_without_grad():
    arrays, mask = _inputs("causal")
    q, k, v, _ = (torch.from_numpy(x) for x in arrays)
    assert remop_flash_attention(q, k, v, **mask).grad_fn is None  # nothing requires grad
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert remop_flash_attention(qg, k, v, **mask).grad_fn is None
    with torch.inference_mode():
        assert remop_flash_attention(qg, k, v, **mask).grad_fn is None


def test_backward_blocks_fit_a_cta_and_widths_are_checked():
    for hd, hd_v in fab.BWD_HEAD_PAIRS:
        for dtype_bytes in (2, 4):
            blk = fab.plan_bwd_blocks(hd, hd_v, dtype_bytes)
            assert blk == (32 if (dtype_bytes, hd) == (4, 256) else 64)
            assert all(fab.bwd_smem_bytes(kind, blk, blk, hd, hd_v, dtype_bytes) <= SMEM_LIMIT
                       for kind in fab.BWD_KERNELS)
    for hd, hd_v in ((48, 48), (24, 24), (128, 64)):
        with pytest.raises(ValueError, match="backward kernel takes"):
            fab.check_bwd_widths(hd, hd_v)


def test_split_p_probe_raises_under_grad():
    q = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16, requires_grad=True)
    k = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="probe"):
        flash_attention(q, k, k, split_p=False)
    with torch.no_grad():
        flash_attention(q, k, k, split_p=False)


def test_kernels_without_a_backward_refuse_grad():
    """The CUDA branches of the kernels without a backward call
    ``runtime.refuse_grad``: under grad with an input requiring it, it
    raises naming what is missing; without grad, or with nothing requiring
    it, it lets the launch go."""
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="gather_rows has no backward"):
        runtime.refuse_grad("gather_rows", "its backward (a scatter-add kernel)", x)
    runtime.refuse_grad("gather_rows", "its backward (a scatter-add kernel)", x.detach())
    with torch.no_grad():
        runtime.refuse_grad("gather_rows", "its backward (a scatter-add kernel)", x)
