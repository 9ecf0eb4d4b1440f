"""recurrentgemma (RG-LRU + local attention) against the JAX package.

The reduced recurrentgemma here: the pattern ``(rec, rec, attn_local)`` at 3
layers, and at 5 (``reduced(..., n_layers=5)``, which adds ``repro``'s
remainder segment of two ``rec`` blocks), d_model 64, lru_width 64, 4 query
heads on 1 KV head of 16, window 32.  Inputs are made with numpy from a seed
and handed to both frameworks; the JAX model runs on the CPU without a
``Sharder``, unrolled (``_UNROLL``) so that its RG-LRU scan runs op by op
as the port's does.

Tolerances, as a share of the reference's largest magnitude: the kernels'
plain versions against ``repro``'s jnp attention at the JAX kernel tests'
2e-5 (f32) and 3e-2 (bf16); layers and the model at 1e-2 in bf16 (JAX's
``full_attention`` rounds scores and P to bf16, the port's kernels keep them
in f32; an ulp of the f32 state flips a bf16 rounding now and then); the
final-normed hidden state of a decode step at 2e-2, three bf16 ulps at its
largest magnitude (it lies in [2, 4), an ulp 2^-6 there): over 5 layers and
20 steps the two attentions' roundings reach 1.1-1.3% of it, the logits stay
under 1e-2.  Ring
packing moves values and is held bit for bit.  The CUDA branch of the
windowed flash kernel is checked through a stand-in library: the kernels
build and run only on the card (``chip_smoke.py`` phase 5d).
"""

import contextlib

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.runtime.serve_loop import Request as JaxRequest, ServeEngine as JaxServeEngine

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import remop_flash_attention
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.serve_loop import Request, ServeEngine

ARCH = "recurrentgemma-2b"
BF16_TOL = 1e-2
HIDDEN_TOL = 2e-2
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _cfgs(**over):
    return jax_reduced(JAX_ARCHS[ARCH], **over), reduced(ARCHS[ARCH], **over)


def _close(got: torch.Tensor, want, tol: float) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, err
    return err


def _bf16(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


# -- the flash kernel's window, in its plain version ----------------------------------


def _jax_local(q, k, v, window, chunk=None):
    """``repro``'s ``full_attention(window=W)`` (or its chunked oracle) on the
    kernel's layout: q [B, H, S, hd], k/v [B, KV, T, hd], offset T - S."""
    b, h, s, hd = q.shape
    kv, t = k.shape[1], k.shape[2]
    args = (q.transpose(0, 2, 1, 3).reshape(b, s, kv, h // kv, hd), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), jnp.broadcast_to(jnp.arange(s) + t - s, (b, s)),
            jnp.broadcast_to(jnp.arange(t), (b, t)))
    out = (jattn.full_attention(*args, window=window) if chunk is None
           else jattn.chunked_attention(*args, window=window, chunk=chunk))
    return np.asarray(out.reshape(b, s, h, hd).transpose(0, 2, 1, 3), np.float32)


def _qkv(seed, b, h, kv, s, t, hd, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, h, s, hd), (b, kv, t, hd), (b, kv, t, hd))]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


WINDOW_CASES = {
    # b, h, kv, s, t, hd, window, bk
    "s_below_w": (1, 4, 1, 24, 24, 16, 32, 16),
    "s_equals_w": (1, 4, 1, 32, 32, 16, 32, 16),
    "s_above_w_g4": (2, 4, 1, 100, 100, 16, 32, 16),
    "w_not_multiple_of_bk_g1": (1, 4, 4, 90, 90, 32, 20, 16),
    "offset_t_minus_s_g3": (2, 6, 2, 70, 130, 16, 50, 32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_windowed_flash_plain_matches_jax_local_attention(dtype, case):
    b, h, kv, s, t, hd, window, bk = WINDOW_CASES[case]
    (jq, jk, jv), (q, k, v) = _qkv(s + window, b, h, kv, s, t, hd, dtype)
    want = _jax_local(jq, jk, jv, window)
    got = fa.flash_attention(q, k, v, bq=min(32, s), bk=bk, window=window)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=KERNEL_TOL[dtype],
                               atol=KERNEL_TOL[dtype])
    # The entry point plans its own blocks and computes the same function,
    # as does JAX's chunked oracle.
    planned = remop_flash_attention(q, k, v, window=window)
    np.testing.assert_allclose(planned.float().numpy(), want, rtol=KERNEL_TOL[dtype],
                               atol=KERNEL_TOL[dtype])
    np.testing.assert_allclose(got.float().numpy(), _jax_local(jq, jk, jv, window, chunk=16),
                               rtol=KERNEL_TOL[dtype], atol=KERNEL_TOL[dtype])
    if window < t:  # the window binds somewhere: causal attention differs
        causal = _jax_local(jq, jk, jv, 0)
        assert np.abs(causal - want).max() > 10 * KERNEL_TOL[dtype]


def test_rows_whose_first_block_is_fully_masked():
    """W 20 in blocks of 16: in each query block of 32 rows the kernel starts
    at the first row's first visible block, which later rows see nothing of.
    Their m stays NEG_INF there and p = 1 is wiped at their first live key:
    the rows agree with JAX, and bit for bit with the same rows computed
    alone (whose walk starts later and never meets the masked block)."""
    b, h, kv, s, hd, window, bq, bk = 1, 2, 1, 100, 16, 20, 32, 16
    rows = [r for r in range(s)
            if r - window + 1 >= (fa.first_block(r // bq * bq, window, bk) + 1) * bk]
    assert len(rows) >= 20  # the class occurs, in several query blocks
    assert len({r // bq for r in rows}) >= 3
    (jq, jk, jv), (q, k, v) = _qkv(11, b, h, kv, s, s, hd)
    got = fa.flash_attention(q, k, v, bq=bq, bk=bk, window=window)
    want = _jax_local(jq, jk, jv, window)
    np.testing.assert_allclose(got.numpy()[:, :, rows], want[:, :, rows],
                               rtol=KERNEL_TOL["float32"], atol=KERNEL_TOL["float32"])
    tail = 36  # rows 64..99 alone (offset 64): their walk starts at block 2
    assert fa.first_block(s - tail, window, bk) == 2 and fa.first_block(0, window, bk) == 0
    alone = fa.flash_attention(q[:, :, s - tail:], k, v, bq=bq, bk=bk, window=window)
    torch.testing.assert_close(alone, fa.flash_attention_plain(q, k, v, bk, window=window)
                               [:, :, s - tail:], rtol=0, atol=0)


def test_window_edge_is_w_keys():
    """Keys planted to dominate their row's scores at distance exactly W
    (outside the window: not seen) and W - 1 (inside: seen), on rows far
    apart; both classes decide their rows, so a window off by one (W - 1 or
    W + 1) fails the reference."""
    b, h, kv, s, hd, window = 1, 1, 1, 400, 16, 32
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, h, s, hd)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, kv, s, hd)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, kv, s, hd)).astype(np.float32)
    outside, inside = [], []
    for i, r in enumerate(range(40, s, 90)):
        d = window if i % 2 == 0 else window - 1
        unit = q[0, 0, r] / np.linalg.norm(q[0, 0, r])
        k[0, 0, r - d] = 20.0 * np.sqrt(hd) * unit / np.linalg.norm(q[0, 0, r])
        v[0, 0, r - d] = 10.0  # a value far from every other
        (outside if d == window else inside).append(r)
    want = _jax_local(*(jnp.asarray(a) for a in (q, k, v)), window)
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), bq=32, bk=16,
                             window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=KERNEL_TOL["float32"], atol=KERNEL_TOL["float32"])
    assert len(inside) >= 2 and len(outside) >= 2
    assert all(np.abs(got[0, 0, r] - 10.0).max() < 1e-3 for r in inside)  # seen: it dominates
    assert all(np.abs(got[0, 0, r]).max() < 5.0 for r in outside)  # not seen
    for wrong in (window - 1, window + 1):
        off = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), bq=32, bk=16,
                                 window=wrong).numpy()
        assert np.abs(off - want).max() > 1.0


def test_first_block_and_negative_window():
    assert [fa.first_block(p, 0, 64) for p in (0, 5000)] == [0, 0]
    assert [fa.first_block(p, 2048, 64) for p in (0, 2047, 2048, 2111, 2112, 4095)] == \
        [0, 0, 0, 1, 1, 32]
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, window=-1)


# -- local attention and the ring --------------------------------------------------------


@pytest.mark.parametrize("s", [5, 32, 80])
def test_ring_pack_matches_jax(s):
    rng = np.random.default_rng(s)
    k, v = (rng.standard_normal((2, s, 1, 8)).astype(np.float32) for _ in range(2))
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    jk, jv = jtf._ring_pack((jnp.asarray(k), jnp.asarray(v)), jnp.asarray(positions), 32)
    rk, rv = attn.ring_pack((torch.from_numpy(k), torch.from_numpy(v)),
                            torch.from_numpy(positions.copy()), 32)
    np.testing.assert_array_equal(rk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(rv.numpy(), np.asarray(jv))
    for p in range(max(0, s - 32), s):  # the last W positions, each at slot p % W
        np.testing.assert_array_equal(rk[:, p % 32].numpy(), k[:, p])


def test_cache_slot_and_length_rules():
    assert [attn.cache_slot(p, 32, 32) for p in (0, 31, 32, 33, 95)] == [0, 31, 0, 1, 31]
    assert [attn.cache_slot(p, 32, 0) for p in (0, 31, 32, 95)] == [0, 31, 31, 31]
    assert [attn.cache_length(p, 32) for p in (0, 30, 31, 32, 95)] == [1, 31, 32, 32, 32]


def test_gqa_local_attention_matches_jax_through_wraps():
    """A prompt of 80 at window 32, then 40 decode steps (two more wraps):
    the prefill's output and packed ring, every step's output and ring."""
    jcfg, cfg = _cfgs()
    window = cfg.window
    assert window == 32
    jp = jattn.init_gqa(jax.random.key(2), jcfg)
    p = {name: {"w": torch.from_numpy(np.array(w["w"])).to(torch.bfloat16)}
         for name, w in jp.items()}
    rng = np.random.default_rng(2)
    s = 80
    jx, x = _bf16(rng, 2, s, cfg.d_model)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    jout, jkv = jattn.gqa_forward(jp, jcfg, jx, jnp.asarray(positions), window=window,
                                  return_kv=True)
    out, kv = attn.gqa_forward(p, cfg, x, torch.from_numpy(positions.copy()), window=window,
                               return_kv=True)
    _close(out, jout, BF16_TOL)
    jcache = jtf._ring_pack(jkv, jnp.asarray(positions), window)
    cache = attn.ring_pack(kv, torch.from_numpy(positions.copy()), window)
    for ring, jring in zip(cache, jcache):
        assert ring.shape == (2, window, 1, cfg.head_dim)
        _close(ring, jring, BF16_TOL)
    buffers = [a.data_ptr() for a in cache]
    for pos in range(s, s + 40):
        jx1, x1 = _bf16(rng, 2, 1, cfg.d_model)
        jout, jcache = jattn.gqa_decode(jp, jcfg, jx1, jcache, jnp.asarray(pos, jnp.int32),
                                        window=window)
        out, cache = attn.gqa_decode(p, cfg, x1, cache, pos, window=window)
        _close(out, jout, BF16_TOL)
        for ring, jring in zip(cache, jcache):
            _close(ring, jring, BF16_TOL)
    assert [a.data_ptr() for a in cache] == buffers  # written in place
    with pytest.raises(ValueError, match="ring of 32"):
        attn.gqa_decode(p, cfg, x1, tuple(a[:, :16] for a in cache), s + 40, window=window)


# -- the model ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,over", [
    (ARCH, {}), (ARCH, {"n_layers": 1}), (ARCH, {"n_layers": 2}), (ARCH, {"n_layers": 5}),
    (ARCH, {"n_layers": 7}), (ARCH, {"n_layers": 26}),
    (ARCH, {"n_layers": 5, "block_pattern": ("rec", "attn_local", "rec")}),
    ("gemma-2b", {}), ("mamba2-370m", {}), ("granite-moe-3b-a800m", {"first_k_dense": 1}),
    ("deepseek-v2-lite-16b", {}),
])
def test_stack_plan_and_layer_kinds_match_jax(arch, over):
    jcfg, cfg = jax_reduced(JAX_ARCHS[arch], **over), reduced(ARCHS[arch], **over)
    want = tuple((seg.kinds, seg.repeats) for seg in jtf.stack_plan(jcfg))
    assert tf.stack_plan(cfg) == want
    kinds = tf.layer_kinds(cfg)
    assert len(kinds) == cfg.n_layers
    assert kinds == [k for ks, n in want for _ in range(n) for k in ks]


def test_full_size_layout():
    cfg = ARCHS[ARCH]
    assert tf.stack_plan(cfg) == ((("rec", "rec", "attn_local"), 8), (("rec",), 2))
    kinds = tf.layer_kinds(cfg)
    assert kinds.count("rec") == 18 and kinds.count("attn_local") == 8
    assert [i for i, k in enumerate(kinds) if k == "attn_local"] == list(range(2, 24, 3))
    spec = tf.cache_struct(cfg, 1, 4160)
    ring = spec[2]
    assert ring == ((torch.Size((1, 2048, 1, 256)), torch.bfloat16),) * 2
    assert spec[0] == ((torch.Size((1, 3, 2560)), torch.bfloat16),
                       (torch.Size((1, 2560)), torch.float32))
    ring_bytes = sum(2 * 2048 * 256 * 2 for k in kinds if k == "attn_local")
    assert ring_bytes == 8 * 2 * 2048 * 256 * 2 == 16_777_216  # 16 MB a request


def test_check_supported_admits_the_hybrid():
    """The hybrid at both sizes, and with the attention softcap, which
    raised before it was ported: one local-attention layer with a cap that
    bites (0.5 on ``wq`` times 2; at least 10% of the visible scores above
    it) equals ``repro``'s windowed layer within ``BF16_TOL`` and differs
    from the uncapped layer by more than 10 ``BF16_TOL``."""
    jcfg, cfg = _cfgs(attn_softcap=0.5)
    tf.check_supported(cfg)
    tf.check_supported(ARCHS[ARCH])
    jp = jattn.init_gqa(jax.random.key(4), jcfg)
    jp["wq"]["w"] = jp["wq"]["w"] * 2
    p = {name: {"w": torch.from_numpy(np.array(w["w"])).to(torch.bfloat16)}
         for name, w in jp.items()}
    s, w = 50, cfg.window
    jx, x = _bf16(np.random.default_rng(4), 2, s, cfg.d_model)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    tpos = torch.from_numpy(positions.copy())
    want = jattn.gqa_forward(jp, jcfg, jx, jnp.asarray(positions), window=w)
    _close(attn.gqa_forward(p, cfg, x, tpos, window=w), want, BF16_TOL)
    q, k, _ = attn._gqa_qkv(p, cfg, x, tpos)
    scores = torch.einsum("bshd,btkd->bhst", q.float(), k.float()) / cfg.head_dim ** 0.5
    rows, cols = torch.arange(s)[:, None], torch.arange(s)[None, :]
    seen = (cols <= rows) & (rows - cols < w)
    assert float((scores.abs() > 0.5)[:, :, seen].float().mean()) >= 0.1
    uncapped = attn.gqa_forward(p, dataclasses.replace(cfg, attn_softcap=0.0), x, tpos, window=w)
    assert float((uncapped.float() - torch.from_numpy(np.asarray(want, np.float32))).abs()
                 .max()) > 10 * BF16_TOL * float(np.abs(np.asarray(want, np.float32)).max())
    with pytest.raises(NotImplementedError, match="pattern"):
        tf.check_supported(reduced(ARCHS[ARCH], block_pattern=("rec", "ssm")))


def _models(**over):
    jcfg, cfg = _cfgs(**over)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module", params=[3, 5], ids=["3layers", "5layers"])
def models(request):
    return _models(n_layers=request.param)


@pytest.fixture
def unrolled(monkeypatch):
    monkeypatch.setattr(jtf, "_UNROLL", True)


def _jax_layers(jcfg, seg_caches):
    """JAX's caches (one stacked pytree per segment) in the port's layer
    order; of ``ShapeDtypeStruct``s, each layer's (shape, dtype) pairs."""
    def one(a, layer):
        if isinstance(a, jax.ShapeDtypeStruct):
            return tuple(a.shape[1:]), TORCH_DTYPES[a.dtype.type]
        return a[layer]

    return [tuple(one(a, layer) for a in seg[f"b{i}_{kind}"])
            for (kinds, repeats), seg in zip(tf.stack_plan(jcfg), seg_caches)
            for layer in range(repeats) for i, kind in enumerate(kinds)]


def _jax_prefill(jp, jcfg, tokens):
    """(last hidden state, its logits, caches) of ``repro``'s prefill."""
    x, positions, mask_positions = jtf._embed_inputs(jp, jcfg, {"tokens": tokens})
    caches = []
    for i, seg in enumerate(jtf.stack_plan(jcfg)):
        x, _, c = jtf.segment_forward(jp[f"seg{i}"], jcfg, seg, x, positions, mask_positions,
                                      want_cache=True)
        caches.append(c)
    x = jlayers.rmsnorm(jp["final_norm"], x, jcfg.norm_eps)[:, -1]
    return x, jlayers.unembed(jp["embed"], x, jcfg.logit_softcap), caches


def _jax_decode(jp, jcfg, caches, token, pos):
    """(hidden state, logits, caches) of ``repro``'s decode step."""
    x = jlayers.embed(jp["embed"], token[:, None], scale_by_sqrt_dim=True)
    new = []
    for i, seg in enumerate(jtf.stack_plan(jcfg)):
        x, c = jtf.segment_decode(jp[f"seg{i}"], jcfg, seg, x, caches[i],
                                  jnp.asarray(pos, jnp.int32))
        new.append(c)
    x = jlayers.rmsnorm(jp["final_norm"], x, jcfg.norm_eps)[:, 0]
    return x, jlayers.unembed(jp["embed"], x, jcfg.logit_softcap), new


def test_params_from_jax_interleaves_the_segments():
    """At 8 layers: seg0 (rec, rec, attn_local) twice, then seg1's two rec
    blocks; the port's layer i is repro's block at its place in that order."""
    jcfg, jparams, cfg, params = _models(n_layers=8)
    assert {k: sorted(v) for k, v in jparams.items() if k.startswith("seg")} == {
        "seg0": ["b0_rec", "b1_rec", "b2_attn_local"], "seg1": ["b0_rec"]}
    assert tf.param_count(params) == jtf.param_count(jparams)
    order = [("seg0", "b0_rec", 0), ("seg0", "b1_rec", 0), ("seg0", "b2_attn_local", 0),
             ("seg0", "b0_rec", 1), ("seg0", "b1_rec", 1), ("seg0", "b2_attn_local", 1),
             ("seg1", "b0_rec", 0), ("seg1", "b0_rec", 1)]
    for layer, (seg, block, rep) in zip(params["layers"], order):
        jlayer = jax.tree.map(lambda a, r=rep: a[r], jparams[seg][block])
        if block.endswith("rec"):
            assert set(layer) == {"norm1", "rec", "norm2", "mlp"}
            assert layer["rec"]["a_param"].dtype == torch.float32
            np.testing.assert_array_equal(layer["rec"]["a_param"].numpy(),
                                          np.asarray(jlayer["rec"]["a_param"]))
            w, jw = layer["rec"]["x_gate"]["w"], jlayer["rec"]["x_gate"]["w"]
        else:
            assert set(layer) == {"norm1", "attn", "norm2", "mlp"}
            w, jw = layer["attn"]["wq"]["w"], jlayer["attn"]["wq"]["w"]
        assert w.dtype == torch.bfloat16
        np.testing.assert_array_equal(w.float().numpy(),
                                      np.asarray(jw.astype(jnp.bfloat16), np.float32))
    fresh = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), fresh)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), params))
    # A tree of another shape is refused.
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="not the tree"):
        params_from_jax({**tree, "seg0": {k: v for k, v in tree["seg0"].items()
                                          if k != "b1_rec"}}, cfg, device="cpu")
    with pytest.raises(ValueError, match="not the tree"):
        params_from_jax(tree, reduced(ARCHS[ARCH], n_layers=9), device="cpu")


def test_cache_struct_and_pad_caches_match_jax(models):
    jcfg, jparams, cfg, params = models
    spec = tf.cache_struct(cfg, 2, 96)
    jspec = _jax_layers(jcfg, jtf.cache_struct(jcfg, 2, 96))
    assert [tuple((tuple(sh), dt) for sh, dt in layer) for layer in spec] == jspec
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40), dtype=np.int32)
    _, caches = tf.prefill(params, cfg, {"tokens": torch.from_numpy(prompt)})
    assert [tuple((a.shape, a.dtype) for a in c) for c in caches] == \
        [tuple(tuple(s) for s in layer) for layer in spec]
    padded = tf.pad_caches(cfg, caches, 96)
    assert all(p is c for layer, plain in zip(padded, caches) for p, c in zip(layer, plain))


def test_prefill_matches_jax(models, unrolled):
    """A prompt longer than the window: the last hidden state, its logits,
    and every layer's cache (rings, conv states, f32 RG-LRU states)."""
    jcfg, jparams, cfg, params = models
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 80), dtype=np.int32)
    jhidden, jlogits, jcaches = _jax_prefill(jparams, jcfg, jnp.asarray(prompt))
    logits, caches, hidden = tf.prefill(params, cfg, {"tokens": torch.from_numpy(prompt)},
                                        return_hidden=True)
    _close(hidden, jhidden, BF16_TOL)
    _close(logits, jlogits, BF16_TOL)
    _close(logits, jtf.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)})[0], BF16_TOL)
    jlayers_ = _jax_layers(jcfg, jcaches)
    assert len(caches) == len(jlayers_) == cfg.n_layers
    for kind, cache, jcache in zip(tf.layer_kinds(cfg), caches, jlayers_):
        for got, want in zip(cache, jcache):
            assert got.dtype == TORCH_DTYPES[want.dtype.type], kind
            _close(got, want, BF16_TOL)


@pytest.mark.parametrize("prompt_len", [20, 80])
def test_decode_through_the_wrap_matches_jax(models, unrolled, prompt_len):
    """Teacher-forced on JAX's greedy tokens: 20 steps from a prompt of 20
    (the ring wraps at 32) or of 80 (wrapped already): each step's hidden
    state and logits, and the caches at the end."""
    jcfg, jparams, cfg, params = models
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, prompt_len),
                                               dtype=np.int32)
    _, jlogits, jcaches = _jax_prefill(jparams, jcfg, jnp.asarray(prompt))
    _, caches = tf.prefill(params, cfg, {"tokens": torch.from_numpy(prompt)})
    jcaches = jtf.pad_caches(jcfg, jcaches, 128)
    caches = tf.pad_caches(cfg, caches, 128)
    token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    for pos in range(prompt_len, prompt_len + 20):
        jhidden, jlogits, jcaches = _jax_decode(jparams, jcfg, jcaches, token, pos)
        logits, caches, hidden = tf.decode_step(params, cfg, caches,
                                                torch.from_numpy(np.array(token)), pos,
                                                return_hidden=True)
        _close(hidden, jhidden, HIDDEN_TOL)
        _close(logits, jlogits, BF16_TOL)
        token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    for cache, jcache in zip(caches, _jax_layers(jcfg, jcaches)):
        for got, want in zip(cache, jcache):
            _close(got, want, BF16_TOL)


def test_serve_engine_matches_jax_with_unpadded_caches(models, monkeypatch):
    """Through ``ServeEngine.submit``, prompts longer and shorter than the
    window: every prefill's and decode step's logits against JAX's engine,
    the same tokens, and no cache grown by ``pad_caches``."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in (45, 7, 33)]
    jax_calls = []
    prefill = jtf.prefill

    def recording_prefill(p, c, batch):
        logits, caches = prefill(p, c, batch)
        jax_calls.append(logits[0])
        return logits, caches

    monkeypatch.setattr(jtf, "prefill", recording_prefill)
    jengine = JaxServeEngine(jcfg, jparams, max_len=96, batch_slots=2)
    decode = jengine._decode

    def recording_decode(p, c, t, pos):
        logits, c = decode(p, c, t, pos)
        jax_calls.append(logits[0])
        return logits, c

    jengine._decode = recording_decode
    jresults = jengine.submit(
        [JaxRequest(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])

    pads = []
    pad = tf.pad_caches

    def recording_pad(c, caches, target):
        out = pad(c, caches, target)
        pads.append(all(a is b for new, old in zip(out, caches) for a, b in zip(new, old)))
        return out

    monkeypatch.setattr(tf, "pad_caches", recording_pad)
    calls = []
    engine = ServeEngine(cfg, params, max_len=96, batch_slots=2, device="cpu",
                         on_step=lambda req, logits, hidden: calls.append(logits))
    runtime.reset_launches()
    results = engine.submit([Request(rid=i, prompt=p, max_new_tokens=6)
                             for i, p in enumerate(prompts)])
    assert sum(runtime.launches.values()) == 0
    assert results == jresults
    assert pads == [True] * 3
    assert len(calls) == len(jax_calls) == 3 * 6
    for logits, jlogits in zip(calls, jax_calls):
        _close(logits, jlogits, BF16_TOL)


def test_serve_cli_runs_reduced_recurrentgemma_on_the_cpu(capsys):
    results = serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                              "--prompt-len", "40", "--max-new-tokens", "3"])
    assert sorted(results) == [0, 1] and all(len(v) == 3 for v in results.values())
    assert "2 requests, 6 tokens" in capsys.readouterr().out


# -- the windowed flash kernel's CUDA branch, through a stand-in library ---------------------


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


def test_windowed_flash_passes_its_window_to_both_routes(fake_card):
    """recurrentgemma's prefill shape in the model's layout takes the
    tensor-core entry with the window before the stream; f32 the CUDA-core
    entry; each windowed launch also counts under its own name, a launch at
    window 0 does not."""
    lib = fake_card
    b, s, h = 1, 3000, 10
    q = torch.zeros(b, s, h, 256, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(b, s, 1, 256, dtype=torch.bfloat16).transpose(1, 2)
    remop_flash_attention(q, k, k, window=2048)
    (name, args), = lib.calls
    assert name == "remop_flash_attention_tc"
    assert args[5:13] == (b, h, 1, s, s, 256, 128, 64)  # b h kv s t hd bq bk
    assert args[14:18] == (1, 256, 2048, 0)  # split, hd_v, window, stream
    assert dict(runtime.launches) == {"flash_attention": 1, "flash_attention_tc": 1,
                                      "flash_attention_windowed": 1}
    fa.flash_attention(q.float(), k.float(), k.float(), bq=32, bk=48, window=1000)
    name, args = lib.calls[-1]
    assert name == "remop_flash_attention_f32" and args[14:17] == (256, 1000, 0)
    assert runtime.launches["flash_attention_windowed"] == 2
    remop_flash_attention(q, k, k)
    assert lib.calls[-1][1][16] == 0
    assert runtime.launches["flash_attention_windowed"] == 2
    assert runtime.launches["flash_attention"] == 3
