"""The int8 KV cache in the port against the JAX package, on the CPU.

``repro``'s int8 cache is ``(k_q, v_q, k_scale, v_scale)``: int8 ``[B, S,
KV, hd]`` values and bf16 ``[B, S, KV, 1]`` scales, ``max|x| / 127`` with a
1e-6 floor, the values rounded half to even against the f32 scale and
clipped to ±127.  ``quantize_kv`` and ``dequantize_kv`` are held to
``repro``'s byte for byte, on rows that hold ties at .5, rows of zeros and
±max (each asserted to occur).  ``gqa_decode`` over an int8 cache is held
to ``repro``'s at one layer (the same x, so the same k and v reach
``quantize_kv``: every written entry byte for byte, the output within
``BF16_TOL``) on a linear cache and on a ring across its wrap;
``repro``'s ``tests/test_attention_unit.py:80-100`` flow runs at reduced
gemma-2b (logits within ``BF16_TOL`` = 1e-2 of their scale over 4 steps;
the first layer's written entries byte for byte, where both models hand
``quantize_kv`` the same k and v; later layers' k and v differ by bf16
roundings of the attention before them).  The paged kernel's int8 route is
checked on its plain version (the dequantized caches, then the bf16
route's plain version) and through a stand-in library; it runs on the card
in ``chip_smoke.py``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.models import attention as jattn
from repro.models import transformer as jtf

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import runtime
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention.ops import remop_paged_attention_int8
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax

BF16_TOL = 1e-2
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _close(got: torch.Tensor, want, tol: float = BF16_TOL) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, err
    return err


def _bits(x) -> np.ndarray:
    """A tensor or JAX array's bytes (bf16 and int8 alike)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _classes_rows(rng, rows: int, hd: int) -> np.ndarray:
    """Rows of ``hd`` values in f32 (exact in bf16): some all zero, some
    scaled by a power of two with 127 at the max so the scale is exactly
    that power and x / scale lands on .5 ties, the rest random."""
    x = rng.standard_normal((rows, hd)).astype(np.float32)
    x[0] = 0.0
    for r in range(1, rows, 3):
        a = np.float32(2.0 ** int(rng.integers(-8, 3)))
        vals = rng.choice([2.5, -2.5, 3.5, -3.5, 10.5, -100.5, 0.5, -0.5, 1.0, 64.0], hd)
        x[r] = vals * a
        x[r, int(rng.integers(hd))] = 127.0 * a * rng.choice([-1.0, 1.0])
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_are_repros_bytes(dtype):
    rng = np.random.default_rng(0)
    x = _classes_rows(rng, 40, 64).reshape(2, 20, 1, 64)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    jq, js = jattn.quantize_kv(jnp.asarray(x).astype(jdt))
    q, s = attn.quantize_kv(torch.from_numpy(x).to(tdt))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16 and s.shape == (2, 20, 1, 1)
    np.testing.assert_array_equal(_bits(q), _bits(jq))
    np.testing.assert_array_equal(_bits(s), _bits(js))
    for out in (jnp.bfloat16, jnp.float32):
        tout = torch.bfloat16 if out == jnp.bfloat16 else torch.float32
        np.testing.assert_array_equal(_bits(attn.dequantize_kv(q, s, tout)),
                                      _bits(jattn.dequantize_kv(jq, js, out)))
    # The classes the comparison decides on occur: ties at .5 (rounded half
    # to even, so some tie rounds down), rows of zeros, and both extremes.
    xf = torch.from_numpy(x).to(tdt).float()
    ratio = xf / (torch.clamp_min(xf.abs().amax(-1, keepdim=True), 1e-6) / 127.0)
    ties = (ratio - ratio.floor()) == 0.5
    assert int(ties.sum()) >= 10
    assert bool((q.float()[ties] == torch.round(ratio[ties])).all())
    assert bool((q.float()[ties].abs() < ratio[ties].abs()).any())  # a tie rounded down
    assert bool((xf == 0).all(-1).any()) and bool((q == 0).all(-1).any())
    assert bool((q == 127).any()) and bool((q == -127).any())


def _layer(seed=0):
    jcfg, cfg = jax_reduced(JAX_ARCHS["gemma-2b"]), reduced(ARCHS["gemma-2b"])
    jp = jattn.init_gqa(jax.random.key(seed), jcfg)
    p = {k: {"w": torch.from_numpy(np.array(v["w"])).to(torch.bfloat16)} for k, v in jp.items()}
    return jcfg, cfg, jp, p


def _bf16(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("window", [0, 8])
def test_gqa_decode_writes_repros_int8_entries(window):
    """At one layer, decode over an int8 cache (linear of 16 slots, or a
    ring of 8 across its wrap): each step's output within ``BF16_TOL`` and
    the four cache tensors byte for byte, the new rows included."""
    jcfg, cfg, jp, p = _layer(3)
    rng = np.random.default_rng(4)
    s = window or 16
    _, k = _bf16(rng, 2, s, cfg.n_kv_heads, cfg.head_dim)
    _, v = _bf16(rng, 2, s, cfg.n_kv_heads, cfg.head_dim)
    (kq, ks), (vq, vs) = attn.quantize_kv(k), attn.quantize_kv(v)
    cache = (kq.clone(), vq.clone(), ks.clone(), vs.clone())
    jcache = tuple(jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
                   if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy())
                   for t in cache)
    for pos in range(5, 5 + 12):  # a ring of 8 wraps at 8 and 16
        jx, x = _bf16(rng, 2, 1, cfg.d_model)
        jout, jcache = jattn.gqa_decode(jp, jcfg, jx, jcache, jnp.asarray(pos, jnp.int32),
                                        window=window)
        out, cache = attn.gqa_decode(p, cfg, x, cache, pos, window=window)
        _close(out, jout)
        for got, want in zip(cache, jcache):
            np.testing.assert_array_equal(_bits(got), _bits(want))


def _jax_quantized(caches):
    """``repro``'s test flow: each layer's (k, v) to (k_q, v_q, k_scale, v_scale)."""
    out = []
    for seg in caches:
        qseg = {}
        for name, (k, v) in seg.items():
            (kq, ks), (vq, vs) = jattn.quantize_kv(k), jattn.quantize_kv(v)
            qseg[name] = (kq, vq, ks, vs)
        out.append(qseg)
    return out


def _torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.fixture
def jax_kv_quant():
    jattn.set_kv_quant(True)
    yield
    jattn.set_kv_quant(False)


def test_repros_int8_decode_flow_at_reduced_gemma(jax_kv_quant):
    """``tests/test_attention_unit.py:80-100`` at reduced gemma-2b: prefill
    11 tokens, pad to 16, quantize every layer's cache, decode; here 4
    steps teacher-forced on JAX's tokens from one int8 cache given to both.
    Logits within ``BF16_TOL`` each step (and within the reference test's
    0.25 of the bf16 cache's logits at the first); the prompt's rows stay
    as they were; the first layer's new rows byte for byte; the caches stay
    int8 and bf16."""
    jcfg, cfg = jax_reduced(JAX_ARCHS["gemma-2b"]), reduced(ARCHS["gemma-2b"])
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    _, jcaches = jtf.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :11])})
    jcaches = jtf.pad_caches(jcfg, jcaches, 16)
    want_bf16, _ = jtf.decode_step(jparams, jcfg, jcaches, jnp.asarray(tokens[:, 11]),
                                   jnp.asarray(11, jnp.int32))
    jq = _jax_quantized(jcaches)
    seg = jq[0]["b0_attn"]
    caches = [tuple(_torch(a[layer]) for a in seg) for layer in range(cfg.n_layers)]
    start = [tuple(t.clone() for t in c) for c in caches]
    assert [tuple((tuple(t.shape), t.dtype) for t in c) for c in caches] == [
        tuple((tuple(s), d) for s, d in spec) for spec in _quant_struct(cfg, 2, 16)]
    token = jnp.asarray(tokens[:, 11])
    for pos in range(11, 15):
        jlogits, jq = jtf.decode_step(jparams, jcfg, jq, token, jnp.asarray(pos, jnp.int32))
        logits, caches = tf.decode_step(params, cfg, caches, torch.from_numpy(np.array(token)),
                                        pos)
        _close(logits, jlogits)
        if pos == 11:
            np.testing.assert_allclose(logits.float().numpy(), np.asarray(want_bf16, np.float32),
                                       atol=0.25)
        token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    seg = jq[0]["b0_attn"]
    for layer, (cache, first) in enumerate(zip(caches, start)):
        for got, was, want in zip(cache, first, seg):
            assert got.dtype in (torch.int8, torch.bfloat16)
            np.testing.assert_array_equal(_bits(got[:, :11]), _bits(was[:, :11]))
            if layer == 0:
                np.testing.assert_array_equal(_bits(got), _bits(want[layer]))
    assert jax.tree.leaves(jq)[0].dtype == jnp.int8


def _quant_struct(cfg, batch, seq):
    attn.set_kv_quant(True)
    try:
        return tf.cache_struct(cfg, batch, seq)
    finally:
        attn.set_kv_quant(False)


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-2b", "granite-moe-3b-a800m",
                                  "seamless-m4t-large-v2", "deepseek-v2-lite-16b"])
def test_cache_struct_under_kv_quant_matches_jax(arch, jax_kv_quant):
    """``"attn"``, ``"moe"`` and ``"attn_local"`` caches turn int8 with bf16
    scales; cross, MLA, SSM and RG-LRU caches do not, as in ``repro``
    (whose specs carry a stacked layer axis the port's list has not)."""
    jcfg, cfg = jax_reduced(JAX_ARCHS[arch]), reduced(ARCHS[arch])
    jspec = jtf.cache_struct(jcfg, 2, 24)
    want = []
    for (kinds, repeats), seg in zip(tf.decoder_segments(cfg), jspec):
        for _ in range(repeats):
            for i, kind in enumerate(kinds):
                leaf = seg[f"b{i}_{kind}"]
                one = lambda s: (torch.Size(s.shape[1:]), _DT[s.dtype])  # noqa: E731
                want.append({k: tuple(map(one, v)) for k, v in leaf.items()}
                            if isinstance(leaf, dict) else tuple(map(one, leaf)))
    got = _quant_struct(cfg, 2, 24)
    assert got == want
    assert any(len(c) == 4 for c in got if not isinstance(c, dict)) == (arch not in (
        "seamless-m4t-large-v2", "deepseek-v2-lite-16b"))
    assert tf.cache_struct(cfg, 2, 24) != got or arch in ("seamless-m4t-large-v2",
                                                          "deepseek-v2-lite-16b")


_DT = {jnp.dtype(jnp.int8): torch.int8, jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.float32): torch.float32}


def test_quantized_ring_decodes_across_the_wrap_at_reduced_recurrentgemma(monkeypatch):
    """Reduced recurrentgemma (window 32): prefill 40 tokens, quantize every
    ring (the RG-LRU states stay), decode 30 steps past the wrap, JAX run
    unrolled on the same caches: logits within ``BF16_TOL`` each step; the
    first ring's new rows byte for byte after the steps."""
    monkeypatch.setattr(jtf, "_UNROLL", True)
    jcfg, cfg = jax_reduced(JAX_ARCHS["recurrentgemma-2b"]), reduced(ARCHS["recurrentgemma-2b"])
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 40), dtype=np.int32)
    jlogits, jcaches = jtf.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    jq = []
    for seg in jcaches:
        jq.append({name: (tuple(jattn.quantize_kv(a)[0] for a in c)
                          + tuple(jattn.quantize_kv(a)[1] for a in c))
                   if "attn_local" in name else c for name, c in seg.items()})
    layers = []
    for (kinds, repeats), seg in zip(tf.stack_plan(cfg), jq):
        for r in range(repeats):
            for i, kind in enumerate(kinds):
                layers.append(tuple(_torch(a[r]) for a in seg[f"b{i}_{kind}"]))
    caches = layers
    assert [len(c) for c in caches] == [4 if k == "attn_local" else 2
                                        for k in tf.layer_kinds(cfg)]
    token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    for pos in range(40, 70):
        jlogits, jq = jtf.decode_step(jparams, jcfg, jq, token, jnp.asarray(pos, jnp.int32))
        logits, caches = tf.decode_step(params, cfg, caches, torch.from_numpy(np.array(token)),
                                        pos)
        _close(logits, jlogits)
        token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    first = tf.layer_kinds(cfg).index("attn_local")
    seg_first = jq[0][f"b{first}_attn_local"]
    for got, want in zip(caches[first], seg_first):
        np.testing.assert_array_equal(_bits(got), _bits(want[0]))


def test_pad_caches_grows_int8_caches():
    cfg = reduced(ARCHS["gemma-2b"])
    kq = torch.ones(2, 5, cfg.n_kv_heads, cfg.head_dim, dtype=torch.int8)
    ks = torch.ones(2, 5, cfg.n_kv_heads, 1, dtype=torch.bfloat16)
    grown = tf.pad_caches(cfg, [(kq, kq, ks, ks)] * cfg.n_layers, 9)
    for c in grown:
        assert [tuple(t.shape) for t in c] == [(2, 9, cfg.n_kv_heads, cfg.head_dim)] * 2 + [
            (2, 9, cfg.n_kv_heads, 1)] * 2
        assert [t.dtype for t in c] == [torch.int8] * 2 + [torch.bfloat16] * 2
        assert all(bool((t[:, :5] == 1).all()) and not t[:, 5:].any() for t in c)


def test_cross_and_mla_caches_are_never_int8():
    """``repro`` never quantizes a cross or an MLA cache: a 4-tuple raises."""
    cfg = reduced(ARCHS["gemma-2b"])
    _, _, _, p = _layer()
    x = torch.zeros(1, 1, cfg.d_model, dtype=torch.bfloat16)
    four = tuple(torch.zeros(1, 8, cfg.n_kv_heads, cfg.head_dim) for _ in range(4))
    with pytest.raises(ValueError, match="never quantizes"):
        attn.cross_decode(p, cfg, x, four)
    mcfg = reduced(ARCHS["deepseek-v2-lite-16b"])
    mp = attn.init_mla(mcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="never quantizes"):
        attn.mla_decode(mp, mcfg, torch.zeros(1, 1, mcfg.d_model), four, 3)
    with pytest.raises(ValueError, match="a decode cache is"):
        attn.gqa_decode(p, cfg, x, four[:3], 3)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("g,hd,s,lengths", [(8, 256, 300, (300, 129)), (3, 64, 200, (1, 77)),
                                            (1, 16, 40, (40, 40))])
def test_int8_plain_is_the_bf16_plain_on_dequantized_caches(g, hd, s, lengths, softcap):
    """The int8 route's plain version equals the bf16 route's on the
    dequantized caches bit for bit (the kernel's contract on the card), and
    ``repro``'s dequantize-then-attend within ``KERNEL_TOL`` bf16."""
    rng = np.random.default_rng(g * 1000 + hd)
    q = torch.from_numpy(rng.standard_normal((2, 2, g, hd)).astype(np.float32) * 4).bfloat16()
    k = torch.from_numpy(rng.standard_normal((2, s, 2, hd)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((2, s, 2, hd)).astype(np.float32)).bfloat16()
    (kq, ks), (vq, vs) = attn.quantize_kv(k), attn.quantize_kv(v)
    ln = torch.tensor(lengths, dtype=torch.int32)
    got = remop_paged_attention_int8(q, kq, vq, ks, vs, ln, softcap=softcap)
    page = min(s, 128)
    pad = (-s) % page
    kd, vd = (torch.nn.functional.pad(attn.dequantize_kv(a, b), (0, 0, 0, 0, 0, pad))
              for a, b in ((kq, ks), (vq, vs)))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(pa.paged_attention_plain(q, kd, vd, ln, page,
                                                                 softcap=softcap)))
    # repro: dequantize, then full_attention at q_pos = length - 1.
    jk, jv = (jattn.dequantize_kv(jnp.asarray(a.numpy()), jnp.asarray(
        b.view(torch.int16).numpy()).view(jnp.bfloat16)) for a, b in ((kq, ks), (vq, vs)))
    qg = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)[:, None]
    idx = np.arange(s)
    kv_pos = np.where(idx[None] < np.asarray(lengths)[:, None], idx[None], 10 ** 9)
    want = jattn.full_attention(qg, jk, jv, jnp.asarray(np.asarray(lengths)[:, None] - 1),
                                jnp.asarray(kv_pos), softcap=softcap)[:, 0]
    _close(got, want, KERNEL_TOL["bfloat16"])


class _FakeLibrary:
    """Stands in for the built ``paged_attention`` library: records each
    entry point's arguments and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("remop_paged_attention"):
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


def test_int8_cuda_branch_launches_its_entry_with_the_bf16_plan(fake_card):
    """gemma-2b's decode shape: one launch of the int8 entry, the six
    tensors' pointers, the bf16 route's split plan and scale, the cap, and
    its counters; no cache is copied or dequantized."""
    lib = fake_card
    q = torch.zeros(1, 1, 8, 256, dtype=torch.bfloat16)
    kq = torch.zeros(1, 4096, 1, 256, dtype=torch.int8)
    ks = torch.zeros(1, 4096, 1, 1, dtype=torch.bfloat16)
    ln = torch.tensor([2077], dtype=torch.int32)
    out = pa.paged_attention_int8(q, kq, kq, ks, ks, ln, softcap=5.0)
    (name, args), = lib.calls
    splits, gc = pa.plan(1, 1, 8, 4096)
    assert name == "remop_paged_attention_int8_bf16"
    assert args[:7] == (q.data_ptr(), kq.data_ptr(), kq.data_ptr(), ks.data_ptr(), ks.data_ptr(),
                        ln.data_ptr(), out.data_ptr())
    assert args[8:] == (1, 1, 8, 4096, 256, splits, gc, 1 / 16, 5.0, 0)
    assert dict(runtime.launches) == {"paged_attention_int8": 1, "paged_attention_softcap": 1}
    with pytest.raises(TypeError, match="bf16 q"):
        pa.paged_attention_int8(q.float(), kq, kq, ks, ks, ln)
    with pytest.raises(TypeError, match="int8 caches"):
        pa.paged_attention_int8(q, kq.bfloat16(), kq, ks, ks, ln)
    with pytest.raises(ValueError, match="scales must be"):
        pa.paged_attention_int8(q, kq, kq, ks[:, :10], ks, ln)
