"""The flash kernel's ``prefix``: keys every query sees, against the JAX package.

``repro`` gets its prefix-LM, bidirectional and cross-attention masks by
bending the positions its causal mask compares (``mask_pos``); the port's
flash kernel takes one integer instead: key ``k`` is seen by the query at
position ``q`` iff ``k <= q`` or ``k < prefix``.  Here the plain version
(what a CPU tensor runs) at ``prefix`` is held to ``repro``'s
``attention.full_attention`` under each ``mask_pos`` that ``repro`` builds:
paligemma's ``max(pos - P + 1, 0)``, the encoder's zeros, and
cross-attention's ``q_pos = 1e9`` over ``kv_pos = 0`` (S > T included).
Inputs are numpy draws from a seed handed to both.  Tolerances are the JAX
kernel tests': 2e-5 in f32 and 3e-2 in bf16 (``full_attention`` rounds the
scores and P to bf16 there, the plain version keeps them in f32), absolute
and relative.

The CUDA branch is checked through a stand-in library (the kernels build and
run only on the card, ``chip_smoke.py`` phases 5e and 5f): ``prefix``
reaches both C entry points as the argument before the stream and is
counted, and a call without it passes what it passed before.
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import remop_flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

KERNEL_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(seed, b, h, kv, s, t, hd, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, h, s, hd), (b, kv, t, hd), (b, kv, t, hd))]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _jax(q, k, v, q_pos, kv_pos):
    """``repro``'s ``full_attention`` on the kernel's layout (q [B, H, S,
    hd], k/v [B, KV, T, hd]) under the mask positions ``q_pos`` [S] and
    ``kv_pos`` [T]."""
    b, h, s, hd = q.shape
    kv, t = k.shape[1], k.shape[2]
    out = jattn.full_attention(
        q.transpose(0, 2, 1, 3).reshape(b, s, kv, h // kv, hd), k.transpose(0, 2, 1, 3),
        v.transpose(0, 2, 1, 3), jnp.broadcast_to(jnp.asarray(q_pos, jnp.int32), (b, s)),
        jnp.broadcast_to(jnp.asarray(kv_pos, jnp.int32), (b, t)))
    return np.asarray(out.reshape(b, s, h, hd).transpose(0, 2, 1, 3), np.float32)


def _mask_pos(kind, s, t, p):
    """(q_pos, kv_pos, prefix) as ``repro`` builds them for ``kind``, the
    queries at positions ``t - s .. t - 1`` (the kernel's offset)."""
    q = np.arange(t - s, t)
    k = np.arange(t)
    if kind == "vlm":  # transformer._embed_inputs: the image prefix mutually visible
        return np.maximum(q - p + 1, 0), np.maximum(k - p + 1, 0), p
    if kind == "encoder":  # block_forward's "enc": all mask positions equal
        return np.zeros(s), np.zeros(t), t
    assert kind == "cross"  # gqa_forward(xa=...): q_pos 1e9, kv_pos 0
    return np.full(s, 10 ** 9), np.zeros(t), t


CASES = {
    # kind, b, h, kv, s, t, hd, P, bk
    "vlm_p32_aligned": ("vlm", 1, 8, 1, 80, 80, 16, 32, 16),
    "vlm_p13_unaligned": ("vlm", 2, 4, 2, 50, 50, 16, 13, 16),
    "vlm_p_past_the_rows_offset": ("vlm", 1, 4, 1, 20, 60, 32, 45, 16),
    "vlm_text_of_one": ("vlm", 1, 8, 1, 33, 33, 16, 32, 32),
    "encoder_aligned": ("encoder", 1, 4, 4, 64, 64, 16, None, 16),
    "encoder_unaligned": ("encoder", 2, 4, 4, 37, 37, 16, None, 16),
    "cross_s_below_t": ("cross", 1, 4, 4, 10, 70, 16, None, 32),
    "cross_s_above_t": ("cross", 2, 4, 4, 45, 19, 16, None, 16),
    "cross_one_query": ("cross", 1, 4, 2, 1, 23, 16, None, 16),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_plain_matches_jax_mask_pos(dtype, case):
    kind, b, h, kv, s, t, hd, p, bk = CASES[case]
    q_pos, kv_pos, prefix = _mask_pos(kind, s, t, p)
    (jq, jk, jv), (q, k, v) = _qkv(s * 7 + t, b, h, kv, s, t, hd, dtype)
    want = _jax(jq, jk, jv, q_pos, kv_pos)
    tol = KERNEL_TOL[dtype]
    got = fa.flash_attention(q, k, v, bq=min(32, s), bk=bk, prefix=prefix)
    assert got.dtype == q.dtype and got.shape == (b, h, s, hd)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    # The entry point plans its own blocks and computes the same function.
    planned = remop_flash_attention(q, k, v, prefix=prefix)
    np.testing.assert_allclose(planned.float().numpy(), want, rtol=tol, atol=tol)
    # The dense oracle too.
    np.testing.assert_allclose(flash_attention_ref(q, k, v, prefix=prefix).float().numpy(),
                               want, rtol=tol, atol=tol)
    if s <= t and t - s < min(prefix, t) - 1:  # the prefix binds: the causal kernel differs
        causal = fa.flash_attention_plain(q, k, v, bk)
        assert float((causal.float() - got.float()).abs().max()) > 5 * tol


def test_prefix_edge_classes_decide_their_rows():
    """Keys planted to dominate their rows' scores at P - 1 (in the prefix:
    seen by every row) and at P (past it: seen only by rows at q >= P),
    P = 37 unaligned to bk 16.  Both classes occur and decide their rows,
    so a prefix off by one (P - 1 or P + 1) fails the reference."""
    b, h, kv, s, hd, p = 1, 2, 1, 90, 16, 37
    rng = np.random.default_rng(4)
    q = rng.standard_normal((b, h, s, hd)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, kv, s, hd)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, kv, s, hd)).astype(np.float32)
    # Every row scores 20 on the key at P - 1; rows 5, 20, 30 (q < P) and
    # 50, 70 (q >= P) also score 40 on the key at P, which decides them
    # where it is seen: the rows before P must not see it.
    q[0, :, :, 0] = 4.0
    k[0, 0, p - 1] = 0.0
    k[0, 0, p - 1, 0] = 20.0
    v[0, 0, p - 1] = 10.0
    k[0, 0, p] = 0.0
    k[0, 0, p, 1] = 40.0
    v[0, 0, p] = -10.0
    before, after = [5, 20, 30], [50, 70]
    for r in before + after:
        q[0, :, r] = 0.0
        q[0, :, r, :2] = 4.0
    q_pos, kv_pos, _ = _mask_pos("vlm", s, s, p)
    want = _jax(*(jnp.asarray(a) for a in (q, k, v)), q_pos, kv_pos)
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), bq=32, bk=16,
                             prefix=p).numpy()
    np.testing.assert_allclose(got, want, rtol=KERNEL_TOL["float32"], atol=KERNEL_TOL["float32"])
    seen_by_all = [r for r in range(s) if r not in before + after]
    assert len(seen_by_all) > 50
    # Key P - 1 decides every row that does not favour key P, before P too.
    assert all(np.abs(got[0, :, r] - 10.0).max() < 1e-3 for r in seen_by_all if r < p)
    assert all(np.abs(got[0, :, r] - (-10.0)).max() < 1e-3 for r in after)  # key P seen
    assert all(np.abs(got[0, :, r] - 10.0).max() < 1e-3 for r in before)  # key P hidden
    for wrong in (p - 1, p + 1):
        off = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), bq=32, bk=16,
                                 prefix=wrong).numpy()
        assert np.abs(off - want).max() > 1.0


def test_prefix_zero_is_the_causal_kernel_bit_for_bit():
    (_, _, _), (q, k, v) = _qkv(9, 1, 4, 2, 40, 56, 16)
    causal = fa.flash_attention_plain(q, k, v, 16)
    torch.testing.assert_close(fa.flash_attention_plain(q, k, v, 16, prefix=0), causal,
                               rtol=0, atol=0)
    # A prefix no key reaches past the causal limit changes nothing either.
    torch.testing.assert_close(fa.flash_attention_plain(q, k, v, 16, prefix=10), causal,
                               rtol=0, atol=0)


def test_prefix_refusals():
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, k, window=4, prefix=2)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_plain(q, k, k, window=4, prefix=2)
    with pytest.raises(ValueError, match="prefix"):
        fa.flash_attention(q, k, k, prefix=-1)
    # More queries than keys: only where every key is seen.
    short = torch.zeros(1, 1, 5, 16)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, short, short)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, short, short, prefix=4)
    assert fa.flash_attention(q, short, short, prefix=5).shape == (1, 2, 8, 16)
    assert fa.flash_attention(q, short, short, prefix=1000).shape == (1, 2, 8, 16)


# -- the CUDA branch, through a stand-in library -------------------------------------------


class _FakeLibrary:
    """Stands in for the built ``flash_attention`` library: records each
    entry point's arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("remop_flash_attention"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(runtime, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(runtime, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    lib = _FakeLibrary()
    monkeypatch.setattr(runtime, "library", lambda name: lib)
    runtime.reset_launches()
    yield lib
    runtime.reset_launches()


def test_prefix_reaches_both_entry_points_and_is_counted(fake_card):
    """paligemma's prefill in the model's layout (256 patches and 200 text
    tokens, 8 heads on one KV head of 256) takes the tensor-core entry with
    the prefix between the window and the stream; f32 the CUDA-core entry;
    a prefix covering every key also counts as full, S > T included."""
    lib = fake_card
    b, s, h, p = 1, 456, 8, 256
    q = torch.zeros(b, s, h, 256, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(b, s, 1, 256, dtype=torch.bfloat16).transpose(1, 2)
    remop_flash_attention(q, k, k, prefix=p)
    (name, args), = lib.calls
    assert name == "remop_flash_attention_tc"
    assert args[5:13] == (b, h, 1, s, s, 256, 128, 64)  # b h kv s t hd bq bk
    assert args[14:19] == (1, 256, 0, p, 0)  # split, hd_v, window, prefix, stream
    assert dict(runtime.launches) == {"flash_attention": 1, "flash_attention_tc": 1,
                                      "flash_attention_prefix": 1}
    fa.flash_attention(q.float(), k.float(), k.float(), bq=32, bk=48, prefix=100)
    name, args = lib.calls[-1]
    assert name == "remop_flash_attention_f32" and args[14:18] == (256, 0, 100, 0)
    assert runtime.launches["flash_attention_prefix"] == 2
    # Cross-attention at seamless's widths: 300 decoder rows over 200 frames.
    xq = torch.zeros(1, 300, 16, 64, dtype=torch.bfloat16).transpose(1, 2)
    xk = torch.zeros(1, 200, 16, 64, dtype=torch.bfloat16).transpose(1, 2)
    remop_flash_attention(xq, xk, xk, prefix=200)
    name, args = lib.calls[-1]
    assert name == "remop_flash_attention_tc" and args[5:11] == (1, 16, 16, 300, 200, 64)
    assert args[16:18] == (0, 200)
    assert runtime.launches["flash_attention_full"] == 1
    assert runtime.launches["flash_attention_prefix"] == 3


def test_prefix_zero_calls_pass_what_they_passed_before(fake_card):
    """Without a prefix both entry points get the arguments of a causal
    call, with 0 where the prefix goes (and 0.0 where the cap goes), and no
    prefix counter moves."""
    lib = fake_card
    q = torch.zeros(1, 8, 2048, 256, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 2048, 256, dtype=torch.bfloat16)
    out = remop_flash_attention(q, k, k)
    (name, args), = lib.calls
    scale = 1.0 / 16.0
    assert name == "remop_flash_attention_tc"
    assert args[:4] == (q.data_ptr(), k.data_ptr(), k.data_ptr(), out.data_ptr())
    assert args[5:] == (1, 8, 1, 2048, 2048, 256, 128, 64, scale, 1, 256, 0, 0, 0.0, 0)
    fa.flash_attention(q.float(), k.float(), k.float(), bq=64, bk=64, window=512)
    name, args = lib.calls[-1]
    assert name == "remop_flash_attention_f32"
    assert args[5:] == (1, 8, 1, 2048, 2048, 256, 64, 64, scale, 256, 512, 0, 0.0, 0)
    assert dict(runtime.launches) == {"flash_attention": 2, "flash_attention_tc": 1,
                                      "flash_attention_simt": 1, "flash_attention_windowed": 1}


def _c_entries(source: str):
    """Each ``extern "C"`` entry point of a CUDA source: name -> its
    parameter types as ctypes would pass them."""
    import re

    text = source[source.index('extern "C"'):]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}
    out = {}
    for name, params in re.findall(r"^\S[^\n(]*?\b(remop_\w+)\(([^)]*)\)\s*\{", text, re.M):
        out[name] = [ctypes.c_void_p if "*" in p else kinds[" ".join(p.split()[:-1])]
                     for p in (x.strip() for x in params.split(",")) if p]
    return out


@pytest.mark.parametrize("lib", sorted(runtime.SIGNATURES))
def test_ctypes_signatures_match_the_c_entry_points(lib):
    """Every entry point's ctypes argument types equal its C parameters, in
    number and kind (a pointer, an int, a float), so an argument added to a
    C entry (the flash kernel's ``prefix``) cannot be passed as another."""
    entries = _c_entries((runtime.CSRC / f"{lib}.cu").read_text())
    assert set(entries) == set(runtime.SIGNATURES[lib])  # the paged int8 entry among them
    for name, (argtypes, _) in runtime.SIGNATURES[lib].items():
        assert entries[name] == list(argtypes), name
