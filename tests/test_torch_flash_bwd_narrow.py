"""The flash backward at the reduced configs' widths, on the CPU.

``configs.reduced`` gives every config attention heads of 16 (MLA: q/k 24
= nope 16 + rope 8, v 16), which the tensor-core route does not take.  On
the card the CUDA-core kernels take them: hd 16 and 32 as they are, (24,
16) as (32, 16) on q and k zero-padded to 32 (``PADDED_HEAD_PAIRS``).

1. ``flash_attention_bwd_plain`` (what a CPU tensor takes) at (16, 16),
   (32, 32) and (24, 16), under the masks the reduced configs train with
   (causal; recurrentgemma's window of 32; paligemma's prefix of 8 patch
   rows; seamless's every-key encoder and its cross-attention, S != T; a
   softcap), against ``jax.vjp`` of ``repro``'s ``full_attention`` on the
   same numpy inputs: relative L2 per gradient within ``F32_TOL`` in f32
   and ``BF16_TOL`` in bf16 (``tests/test_torch_flash_grad.py``'s bounds and
   reasons: JAX rounds its scores, P, dP and dS to bf16 where the port
   keeps them in f32).
2. The padding: the plain forward and backward on q and k zero-padded to
   32 with the scale of 24, cut back to 24, equal the unpadded ones bit for
   bit.
3. Widths and routes: ``check_bwd_widths`` takes the reduced widths and
   refuses others; ``bwd_route`` sends them to ``"simt"``;
   ``BWD_TC_HEAD_PAIRS`` is the tensor-core set it was; every reduced
   config's attention widths lie in ``BWD_HEAD_PAIRS`` and the forward's
   ``HEAD_PAIRS``.
4. The CUDA branches against stand-in libraries: at (24, 16) the forward
   and the backward launch the CUDA-core entry at width 32 with the scale
   of 24, on padded copies of q and k, and hand back dq and dk at 24 in
   their inputs' layouts; the launches counted under ``simt``.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention.ops import remop_flash_attention

F32_TOL = 1e-5
BF16_TOL = 1e-2

# (b, h, kv, s, t, hd, hd_v, window, prefix, softcap, q gain): the reduced
# configs' 4 heads on 1, 2 or (MLA) 4 KV heads over 64 positions.
CASES = {
    "hd 16 causal": (2, 4, 2, 64, 64, 16, 16, 0, 0, 0.0, 1.0),
    "hd 16 window 32": (2, 4, 1, 64, 64, 16, 16, 32, 0, 0.0, 1.0),
    "hd 16 prefix 8": (2, 4, 1, 64, 64, 16, 16, 0, 8, 0.0, 1.0),
    "hd 16 every key": (2, 4, 2, 64, 64, 16, 16, 0, 64, 0.0, 1.0),
    "hd 16 cross": (2, 4, 2, 40, 64, 16, 16, 0, 64, 0.0, 1.0),
    "hd 16 softcap": (1, 4, 2, 64, 64, 16, 16, 0, 0, 5.0, 4.0),
    "hd 32 causal": (2, 4, 2, 64, 64, 32, 32, 0, 0, 0.0, 1.0),
    "hd 32 window 32": (2, 4, 1, 64, 64, 32, 32, 32, 0, 0.0, 1.0),
    "hd 32 prefix 8": (2, 4, 1, 64, 64, 32, 32, 0, 8, 0.0, 1.0),
    "mla 24/16 causal": (2, 4, 4, 64, 64, 24, 16, 0, 0, 0.0, 1.0),
    "mla 24/16 q gain 8": (1, 4, 4, 64, 64, 24, 16, 0, 0, 0.0, 8.0),
}
NARROW = ((16, 16), (32, 32), (24, 16))
TC = ((64, 64), (128, 128), (256, 256), (192, 128))


def _inputs(case, seed=0):
    b, h, kv, s, t, hd, hd_v, window, prefix, softcap, gain = CASES[case]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, s, hd)) * gain).astype(np.float32)
    k = rng.standard_normal((b, kv, t, hd)).astype(np.float32)
    v = rng.standard_normal((b, kv, t, hd_v)).astype(np.float32)
    do = rng.standard_normal((b, h, s, hd_v)).astype(np.float32)
    return (q, k, v, do), dict(window=window, prefix=prefix, softcap=softcap)


def _positions(case):
    """repro's q_pos and kv_pos for the case's mask: cross-attention's
    ``q_pos = 10**9`` over ``kv_pos = 0``; a prefix as ``mask_pos``."""
    b, _, _, s, t, _, _, _, prefix, _, _ = CASES[case]
    if case.endswith("cross"):
        return np.full((b, s), 10 ** 9, np.int32), np.zeros((b, t), np.int32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    if prefix:
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


def _rel(got, want):
    got = got.double().numpy()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# At q 8 times the unit scale JAX's bf16 scores (about 2^-9 of |s|, which
# reaches 20) move its P by a percent or more: past BF16_TOL, a reading of
# JAX's rounding and not of the port.  That case is held in f32 only.
PAIRS = [(case, dtype) for case in sorted(CASES) for dtype in ("float32", "bfloat16")
         if dtype == "float32" or "q gain" not in case]


@pytest.mark.parametrize("case,dtype", PAIRS)
def test_plain_backward_matches_jax_vjp_at_reduced_widths(case, dtype):
    arrays, mask = _inputs(case)
    want = _jax_grads(case, arrays, getattr(jnp, dtype))
    q, k, v, do = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrays)
    with torch.no_grad():
        out = fa.flash_attention(q, k, v, **mask)
    got = fab.flash_attention_bwd(q, k, v, out, do, **mask)  # a CPU tensor: the plain version
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert _rel(g.float(), w) <= tol, (case, name, _rel(g.float(), w))


def test_softcap_case_makes_the_cap_bite():
    """The softcap case's scores pass into the cap's bend: its derivative is
    below 0.9 for a tenth of the visible scores or more."""
    (q, k, _, _), mask = _inputs("hd 16 softcap")
    s = np.einsum("bhsd,bhtd->bhst", q, np.repeat(k, 2, axis=1)) / math.sqrt(16)
    capped = np.tanh(s / mask["softcap"])
    visible = np.tril(np.ones((64, 64), bool))
    assert ((1 - capped ** 2)[..., visible] < 0.9).mean() > 0.1


def test_plain_check_rejects_a_backward_without_d():
    """The bf16 bound is sharp at the reduced widths: D dropped misses it."""
    arrays, mask = _inputs("hd 16 causal")
    want = _jax_grads("hd 16 causal", arrays, jnp.bfloat16)
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays)
    got = fab.flash_attention_bwd_plain(q, k, v, torch.zeros_like(do), do, **mask)
    assert max(_rel(g.float(), w) for g, w in zip(got, want)) > 10 * BF16_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mla 24/16 causal", "mla 24/16 q gain 8"])
def test_padded_plain_path_equals_the_unpadded_one(case, dtype):
    """q and k zero-padded to 32, the scale of 24: the forward and the
    backward's dq, dk (cut back to 24) and dv equal the unpadded ones."""
    arrays, mask = _inputs(case)
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in arrays)
    width, hd_v = fa.kernel_widths(24, 16)
    assert (width, hd_v) == (32, 16)
    qp, kp = fa.pad_heads(q, width), fa.pad_heads(k, width)
    assert qp.shape[-1] == kp.shape[-1] == 32 and not qp[..., 24:].any()
    scale = 1 / math.sqrt(24)
    out = fa.flash_attention_plain(q, k, v, **mask)
    assert torch.equal(fa.flash_attention_plain(qp, kp, v, scale=scale, **mask), out)
    want = fab.flash_attention_bwd_plain(q, k, v, out, do, **mask)
    got = fab.flash_attention_bwd_plain(qp, kp, v, out, do, scale=scale, **mask)
    for g, w in zip(got, want):
        assert torch.equal(g[..., :w.shape[-1]], w)


def test_widths_and_routes():
    assert fab.BWD_TC_HEAD_PAIRS == TC
    assert set(fab.BWD_HEAD_PAIRS) == set(TC) | set(NARROW)
    assert fa.PADDED_HEAD_PAIRS == {(24, 16): (32, 16)}
    for hd, hd_v in NARROW:
        fab.check_bwd_widths(hd, hd_v)
        assert (hd, hd_v) in fa.HEAD_PAIRS
        assert fa.kernel_widths(hd, hd_v)[0] % 16 == 0
        five = (torch.zeros(1, 4, 64, hd, dtype=torch.bfloat16),
                torch.zeros(1, 2, 64, hd, dtype=torch.bfloat16),
                torch.zeros(1, 2, 64, hd_v, dtype=torch.bfloat16),
                torch.zeros(1, 4, 64, hd_v, dtype=torch.bfloat16),
                torch.zeros(1, 4, 64, hd_v, dtype=torch.bfloat16))
        assert fab.bwd_route(*five) == "simt"
        assert fab.plan_bwd_blocks(*fa.kernel_widths(hd, hd_v), 2) == 64
    for hd, hd_v in ((48, 48), (24, 24), (128, 64), (8, 8)):
        with pytest.raises(ValueError, match="backward kernel takes"):
            fab.check_bwd_widths(hd, hd_v)


@pytest.mark.parametrize("arch", sorted(a for a, c in ARCHS.items() if c.attn_type != "none"))
def test_every_reduced_config_trains_at_a_width_the_kernels_take(arch):
    cfg = reduced(ARCHS[arch])
    pair = ((cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim) if cfg.attn_type == "mla"
            else (cfg.head_dim, cfg.head_dim))
    assert pair in fab.BWD_HEAD_PAIRS and pair in fa.HEAD_PAIRS
    assert pair not in fab.BWD_TC_HEAD_PAIRS  # the CUDA cores take them


class _FakeLibrary:
    """Stands in for a built kernel library: records each entry point's
    name and arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("remop_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers take their CUDA branch on CPU tensors, against a
    stand-in library."""
    lib = _FakeLibrary()
    monkeypatch.setattr(runtime, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(runtime, "stream_of", lambda t: 0)
    monkeypatch.setattr(runtime, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    runtime.reset_launches()
    yield lib
    runtime.reset_launches()


def _model_layout(b, heads, s, hd, dtype=torch.bfloat16):
    return torch.randn(b, s, heads, hd).to(dtype).transpose(1, 2)


@pytest.mark.parametrize("hd,hd_v", NARROW)
def test_cuda_backward_launches_the_simt_entry_at_the_kernel_width(fake_card, hd, hd_v):
    b, h, kv, s = 2, 4, 2, 64
    q, k = _model_layout(b, h, s, hd), _model_layout(b, kv, s, hd)
    v, out, dout = _model_layout(b, kv, s, hd_v), _model_layout(b, h, s, hd_v), \
        _model_layout(b, h, s, hd_v)
    dq, dk, dv = fab.flash_attention_bwd(q, k, v, out, dout)
    (name, args), = fake_card.calls
    assert name == "remop_flash_attention_bwd_bf16"
    width = fa.kernel_widths(hd, hd_v)[0]
    # q k v o do dq dk dv lse delta strides, b h kv s t hd bq bk scale hd_v ...
    assert args[11:17] == (b, h, kv, s, s, width) and args[20] == hd_v
    assert args[19] == pytest.approx(1 / math.sqrt(hd))
    padded = width != hd
    assert (args[0] != q.data_ptr() and args[1] != k.data_ptr()) == padded
    assert args[2:5] == (v.data_ptr(), out.data_ptr(), dout.data_ptr())
    for g, x in zip((dq, dk, dv), (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype and g.stride() == x.stride()
    assert (args[5] != dq.data_ptr() and args[6] != dk.data_ptr()) == padded
    assert args[7] == dv.data_ptr()
    assert dict(runtime.launches) == {"flash_attention_bwd": 1, "flash_attention_bwd_simt": 1}


def test_cuda_forward_at_24_16_pads_q_and_k_and_counts_its_pair(fake_card):
    b, h, s = 1, 4, 64
    q, k, v = _model_layout(b, h, s, 24), _model_layout(b, h, s, 24), _model_layout(b, h, s, 16)
    out = remop_flash_attention(q, k, v)
    (name, args), = fake_card.calls
    assert name == "remop_flash_attention_bf16"
    # q k v out strides, b h kv s t hd bq bk scale hd_v window prefix softcap stream
    assert args[5:11] == (b, h, h, s, s, 32) and args[14] == 16
    assert args[13] == pytest.approx(1 / math.sqrt(24))
    assert args[0] != q.data_ptr() and args[1] != k.data_ptr() and args[2] == v.data_ptr()
    assert args[3] == out.data_ptr() and out.shape == (b, h, s, 16)
    assert dict(runtime.launches) == {"flash_attention": 1, "flash_attention_simt": 1,
                                      "flash_attention_simt_24x16": 1}
