"""MLA (multi-head latent attention) and deepseek-v2-lite against the JAX package.

The reduced deepseek-v2-lite here: 2 layers (the first dense, then one
MLA-MoE block), d_model 64, 4 heads, nope 16, rope 8, v 16, kv_lora_rank
32, 8 experts top-2 and 1 shared expert.  Inputs are made with numpy from a
seed and handed to both frameworks; the JAX model runs on the CPU without a
``Sharder``.  Tolerances, as a share of the reference's largest magnitude:
1e-4 in f32 (the two compute the same f32 products in other orders) and
1e-2 in bf16 (JAX rounds the decode's two score terms and P to bf16, the
port's latent route keeps them in f32).  The kernels' plain versions at
MLA's widths (flash at 192 / 128, the latent route at 576 / 512) are held to
``repro``'s jnp attention within the JAX kernel tests' 2e-5 (f32) and 3e-2
(bf16).  The CUDA branches are checked through stand-in libraries: the
kernels build and run only on the card (``chip_smoke.py``).
"""

import contextlib
import ctypes
import dataclasses
import math

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
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import plan_blocks, remop_flash_attention
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention.ops import remop_latent_decode
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.serve_loop import Request, ServeEngine

ARCH = "deepseek-v2-lite-16b"
OVER = {"n_experts": 8}
F32_TOL = 1e-4
BF16_TOL = 1e-2
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(**over):
    over = {**OVER, **over}
    return jax_reduced(JAX_ARCHS[ARCH], **over), reduced(ARCHS[ARCH], **over)


def _close(got: torch.Tensor, want, tol: float) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, err
    return err


def _tree(params, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in params.items()}


def _mla_params(jcfg, dtype, seed=0):
    """JAX's ``init_mla`` weights, and the same as torch tensors (matrices in
    ``dtype``, the norm scale in f32)."""
    jp = jattn.init_mla(jax.random.key(seed), jcfg)

    def leaf(a):
        t = torch.from_numpy(np.array(a, np.float32))
        return t if t.dim() == 1 else t.to(dtype)

    return jp, _tree(jp, leaf)


def _inputs(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


# -- the MLA layer ----------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_mla_forward_matches_jax(dtype, tol):
    jcfg, cfg = _cfgs()
    jp, p = _mla_params(jcfg, DTYPES[dtype][1])
    rng = np.random.default_rng(0)
    jx, x = _inputs(rng, (2, 12, cfg.d_model), dtype)
    positions = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    jout, (jc, jr) = jattn.mla_forward(jp, jcfg, jx, jnp.asarray(positions), return_cache=True)
    out, (c, r) = attn.mla_forward(p, cfg, x, torch.from_numpy(positions.copy()),
                                   return_cache=True)
    assert out.dtype == x.dtype
    _close(out, jout, tol)
    _close(c, jc, tol)
    _close(r, jr, tol)
    assert attn.mla_latent((c, r)).shape == (2, 12, cfg.kv_lora_rank + cfg.rope_head_dim)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_mla_decode_matches_jax(dtype, tol):
    """Absorbed decode from JAX's own prefill cache: the output of every step
    and the cache rows it writes."""
    jcfg, cfg = _cfgs()
    jdt, tdt = DTYPES[dtype]
    jp, p = _mla_params(jcfg, tdt, seed=1)
    rng = np.random.default_rng(1)
    jx, _ = _inputs(rng, (2, 8, cfg.d_model), dtype)
    positions = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (2, 8))
    _, (jc, jr) = jattn.mla_forward(jp, jcfg, jx, positions, return_cache=True)
    jc, jr = (jnp.pad(a, ((0, 0), (0, 8), (0, 0))) for a in (jc, jr))
    cache = attn.mla_cache(torch.from_numpy(np.asarray(jc, np.float32)).to(tdt),
                           torch.from_numpy(np.asarray(jr, np.float32)).to(tdt))
    buffer = attn.mla_latent(cache)
    for pos in range(8, 13):
        jx1, x1 = _inputs(rng, (2, 1, cfg.d_model), dtype)
        jout, (jc, jr) = jattn.mla_decode(jp, jcfg, jx1, (jc, jr), jnp.asarray(pos, jnp.int32))
        out, cache = attn.mla_decode(p, cfg, x1, cache, pos)
        _close(out, jout, tol)
        _close(cache[0], jc, tol)
        _close(cache[1], jr, tol)
    assert attn.mla_latent(cache).data_ptr() == buffer.data_ptr()  # written in place


def test_mla_cache_views_share_one_buffer():
    _, cfg = _cfgs()
    c, r = torch.randn(2, 5, cfg.kv_lora_rank), torch.randn(2, 5, cfg.rope_head_dim)
    cache = attn.mla_cache(c, r)
    latent = attn.mla_latent(cache)
    torch.testing.assert_close(latent, torch.cat([c, r], dim=-1), rtol=0, atol=0)
    grown = attn.mla_pad(cache, 9)
    assert attn.mla_latent(grown).shape == (2, 9, cfg.kv_lora_rank + cfg.rope_head_dim)
    torch.testing.assert_close(grown[0][:, :5], c, rtol=0, atol=0)
    assert not grown[0][:, 5:].any() and not grown[1][:, 5:].any()
    grown[1][0, 7] = 3.0  # the views write into the one buffer
    assert attn.mla_latent(grown)[0, 7, cfg.kv_lora_rank:].eq(3.0).all()
    assert attn.mla_pad(grown, 4)[0].data_ptr() == grown[0].data_ptr()  # long enough: kept
    with pytest.raises(ValueError, match="views of one"):
        attn.mla_latent((c, r))
    with pytest.raises(ValueError, match="views of one"):
        attn.mla_decode(attn.init_mla(cfg, torch.Generator().manual_seed(0), "cpu"), cfg,
                        torch.zeros(2, 1, cfg.d_model), (c, r), 3)


def test_unported_variants_still_raise_on_mla():
    """The softcap, which raised before it was ported, follows ``repro``:
    ``mla_forward`` with a cap that bites (0.5 on ``wq`` times 2: at least
    10% of the scores above it) equals ``repro``'s within ``F32_TOL`` and
    differs from the uncapped forward by more than 10 ``F32_TOL``;
    ``mla_decode`` ignores the cap, bit for bit, in both packages.
    ``cfg.window`` is ignored by MLA, as by ``repro``'s ``mla_forward`` and
    ``mla_decode`` (only ``"attn_local"`` blocks apply it)."""
    jcfg, cfg = _cfgs()
    jcap, cap = (dataclasses.replace(c, attn_softcap=0.5) for c in (jcfg, cfg))
    jp, p = _mla_params(jcfg, torch.float32)
    jp["wq"]["w"], p["wq"]["w"] = jp["wq"]["w"] * 2, p["wq"]["w"] * 2
    jx, x = _inputs(np.random.default_rng(8), (2, 12, cfg.d_model), "float32")
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    tpos = torch.from_numpy(pos.copy())
    want = jattn.mla_forward(jp, jcap, jx, jnp.asarray(pos))
    got, got_cache = attn.mla_forward(p, cap, x, tpos, return_cache=True)
    _close(got, want, F32_TOL)
    q_nope, q_rope = attn._mla_q(p, cfg, x, tpos)
    c_kv, k_rope = attn._mla_ckv(p, cfg, x, tpos)
    k_nope = (c_kv @ p["w_uk"]["w"]).view(2, 12, cfg.n_heads, cfg.nope_head_dim)
    scores = (torch.einsum("bshn,bthn->bhst", q_nope, k_nope)
              + torch.einsum("bshr,btr->bhst", q_rope, k_rope)) / math.sqrt(
                  cfg.nope_head_dim + cfg.rope_head_dim)
    causal = torch.ones(12, 12, dtype=torch.bool).tril()
    assert float((scores.abs() > 0.5)[:, :, causal].float().mean()) >= 0.1
    uncapped = attn.mla_forward(p, cfg, x, tpos)
    assert float((uncapped - torch.from_numpy(np.asarray(want))).abs().max()) > (
        10 * F32_TOL * float(np.abs(np.asarray(want)).max()))
    # Decode: the same step with and without the cap, bit for bit, in both.
    _, jcache = jattn.mla_forward(jp, jcfg, jx[:, :11], jnp.asarray(pos[:, :11]),
                                  return_cache=True)
    jcache = tuple(jnp.pad(a, ((0, 0), (0, 5), (0, 0))) for a in jcache)
    jsteps = [jattn.mla_decode(jp, c, jx[:, 11:], jcache, jnp.asarray(11, jnp.int32))[0]
              for c in (jcfg, jcap)]
    np.testing.assert_array_equal(np.asarray(jsteps[1]), np.asarray(jsteps[0]))
    _, prefix_cache = attn.mla_forward(p, cfg, x[:, :11], tpos[:, :11], return_cache=True)
    steps = [attn.mla_decode(p, c, x[:, 11:], attn.mla_pad(prefix_cache, 16), 11)[0]
             for c in (cfg, cap)]
    torch.testing.assert_close(steps[1], steps[0], rtol=0, atol=0)
    _close(steps[1], jsteps[1], F32_TOL)
    # A window is ignored by MLA's forward and decode.
    want_w, want_cache = attn.mla_forward(p, cfg, x, tpos, return_cache=True)
    got_w, got_cache = attn.mla_forward(p, dataclasses.replace(cfg, window=8), x, tpos,
                                        return_cache=True)
    torch.testing.assert_close(got_w, want_w, rtol=0, atol=0)
    stepped = [attn.mla_decode(p, c, x[:, 11:], attn.mla_pad(got_cache, 16), 12)[0]
               for c in (cfg, dataclasses.replace(cfg, window=8))]
    torch.testing.assert_close(stepped[1], stepped[0], rtol=0, atol=0)
    tf.check_supported(cap)
    tf.check_supported(cfg)
    tf.check_supported(ARCHS[ARCH])


def _absorbed_check(cfg, p, x, fault=None):
    """mla_decode at each position against mla_forward's row: the relative
    L2 error of every row (as chip_smoke's layer check reads it)."""
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32)[None]
    want, (c, r) = attn.mla_forward(p, cfg, x, positions, return_cache=True)
    errs = []
    for pos in range(s):
        cache = attn.mla_pad(attn.mla_cache(c[:, :pos], r[:, :pos]), s)
        step = pos + 1 if fault == "position" else pos
        got, _ = attn.mla_decode(p, cfg, x[:, pos:pos + 1], cache, step)
        errs.append(float((got[0, 0].double() - want[0, pos].double()).norm()
                          / want[0, pos].double().norm()))
    return errs


def test_absorbed_decode_equals_forward_rows_and_rejects_a_wrong_position():
    """In f32 the absorbed decode is the forward pass reassociated: every row
    within 1e-5; a decode that ropes at the next position fails every row
    past the first by far more."""
    _, cfg = _cfgs()
    p = attn.init_mla(cfg, torch.Generator().manual_seed(3), "cpu")
    p = _tree(p, lambda t: t.float())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 16, cfg.d_model))
                         .astype(np.float32))
    assert max(_absorbed_check(cfg, p, x)) <= 1e-5
    assert min(_absorbed_check(cfg, p, x, fault="position")[1:]) > 1e-3


# -- the kernels' plain versions at MLA's widths ------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,t", [(1, 4, 64, 64), (2, 2, 100, 130)])
def test_flash_plain_at_192_128_matches_jax_attention(dtype, b, h, s, t):
    """q/k of 192 and v of 128 against ``repro``'s ``full_attention`` (the
    jnp attention MLA's prefill runs), causal with offset T - S."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(s + t)
    arrays = [rng.standard_normal(sh).astype(np.float32)
              for sh in ((b, h, s, 192), (b, h, t, 192), (b, h, t, 128))]
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    want = jattn.full_attention(jq.transpose(0, 2, 1, 3)[:, :, :, None], jk.transpose(0, 2, 1, 3),
                                jv.transpose(0, 2, 1, 3),
                                jnp.broadcast_to(jnp.arange(s) + t - s, (b, s)),
                                jnp.broadcast_to(jnp.arange(t), (b, t)))
    want = np.asarray(want[:, :, :, 0].transpose(0, 2, 1, 3), np.float32)
    got = remop_flash_attention(q, k, v)
    assert got.shape == (b, h, s, 128) and got.dtype == tdt
    assert fa.route(q, k, v) == ("tc" if dtype == "bfloat16" else "simt")
    np.testing.assert_allclose(got.float().numpy(), want, rtol=KERNEL_TOL[dtype],
                               atol=KERNEL_TOL[dtype])
    # JAX's chunked oracle (which MLA's prefill takes past 8192 keys) agrees too.
    chunked = jattn.chunked_attention(
        jq.transpose(0, 2, 1, 3)[:, :, :, None], jk.transpose(0, 2, 1, 3),
        jv.transpose(0, 2, 1, 3), jnp.broadcast_to(jnp.arange(s) + t - s, (b, s)),
        jnp.broadcast_to(jnp.arange(t), (b, t)), chunk=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(chunked[:, :, :, 0].transpose(0, 2, 1, 3), np.float32),
                               rtol=KERNEL_TOL[dtype], atol=KERNEL_TOL[dtype])


def _jax_latent(q, latent, lengths, scale, v_dim):
    """``repro``'s ``mla_decode`` attention in jnp: the scores' latent and
    rope terms, the scale, the mask, the softmax in f32, the context."""
    lora = v_dim
    s_lat = jnp.einsum("bhl,bsl->bhs", q[..., :lora], latent[..., :lora])
    s_rope = jnp.einsum("bhr,bsr->bhs", q[..., lora:], latent[..., lora:])
    scores = (s_lat + s_rope).astype(jnp.float32) * scale
    mask = jnp.arange(latent.shape[1])[None, None, :] < lengths[:, None, None]
    probs = jax.nn.softmax(jnp.where(mask, scores, -1e30), axis=-1).astype(q.dtype)
    return jnp.einsum("bhs,bsl->bhl", probs, latent[..., :lora])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,lengths", [(64, (64, 1)), (200, (200, 77)), (300, (129, 256))])
def test_latent_plain_matches_jax_absorbed_attention(dtype, s, lengths):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(s)
    b, h = len(lengths), 16
    qa = rng.standard_normal((b, h, 576)).astype(np.float32)
    la = rng.standard_normal((b, s, 576)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    scale = 1.0 / math.sqrt(192)
    want = _jax_latent(jnp.asarray(qa).astype(jdt), jnp.asarray(la).astype(jdt),
                       jnp.asarray(ln), scale, 512)
    got = remop_latent_decode(torch.from_numpy(qa).to(tdt), torch.from_numpy(la).to(tdt),
                              torch.from_numpy(ln), scale)
    assert got.shape == (b, h, 512) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=KERNEL_TOL[dtype], atol=KERNEL_TOL[dtype])


@pytest.mark.parametrize("splits", [1, 3, 32])
def test_latent_plain_never_reads_past_lengths(splits):
    """A NaN tail past ``lengths`` leaves the output what a zero tail gives,
    at any split count; the split plan's answer equals one chunk's."""
    rng = np.random.default_rng(splits)
    q = torch.from_numpy(rng.standard_normal((2, 16, 576)).astype(np.float32))
    latent = torch.from_numpy(rng.standard_normal((2, 512, 576)).astype(np.float32))
    ln = torch.tensor([300, 129], dtype=torch.int32)
    clean = latent.clone()
    for i, n in enumerate(ln.tolist()):
        latent[i, n:] = float("nan")
        clean[i, n:] = 0.0
    scale = 1.0 / math.sqrt(192)
    got = pa.latent_decode_plain(q, latent, ln, scale, splits=splits)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, pa.latent_decode_plain(q, clean, ln, scale, splits=splits),
                               rtol=0, atol=0)
    torch.testing.assert_close(got, pa.latent_decode_plain(q, clean, ln, scale, splits=1),
                               rtol=2e-6, atol=2e-6)


def test_latent_scale_and_rope_term_decide_the_output():
    """The two faults chip_smoke plants are far outside the kernel rule here
    too: the scale 1/sqrt(576) for 1/sqrt(192), and scores without the rope
    term (its 64 columns zeroed in q)."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 16, 576)).astype(np.float32))
    latent = torch.from_numpy(rng.standard_normal((1, 256, 576)).astype(np.float32))
    ln = torch.tensor([256], dtype=torch.int32)
    want = remop_latent_decode(q, latent, ln, 1.0 / math.sqrt(192))
    no_rope = q.clone()
    no_rope[..., 512:] = 0
    for fault in (remop_latent_decode(q, latent, ln, 1.0 / math.sqrt(576)),
                  remop_latent_decode(no_rope, latent, ln, 1.0 / math.sqrt(192))):
        assert float((fault - want).abs().max()) > 100 * KERNEL_TOL["float32"]


# -- host rules of the new instantiations ---------------------------------------------


def test_flash_192_128_plans_within_shared_memory():
    assert fa.MLA_HEAD_PAIR in fa.TC_HEAD_PAIRS and fa.MLA_HEAD_PAIR in fa.HEAD_PAIRS
    # 1024 + bq hd 2 + 2 bk (hd + hd_v) 2 + 56
    assert fa.smem_bytes(128, 128, 192, 2, "tc", 128) == 214_072 <= fa.SMEM_LIMIT
    assert fa.smem_bytes(64, 64, 192, 2, "tc", 128) == 1024 + 64 * 192 * 2 + 2 * 64 * 320 * 2 + 56
    assert plan_blocks(2048, 2048, 192, 2, hd_v=128) == (128, 128)
    for s, t in ((1, 4096), (64, 64), (777, 777), (32768, 32768)):
        bq, bk = plan_blocks(s, t, 192, 2, hd_v=128)
        assert bq in fa.TC_BLOCKS and bk in fa.TC_BLOCKS
        fa.check_blocks("tc", bq, bk, 192, 128)
    # Without a value width, 192 is no tensor-core pair: the CUDA-core plan.
    assert plan_blocks(2048, 2048, 192, 2) == (64, 64)
    # deepseek-v2-lite's prefill, as the model hands it to the kernel.
    q = torch.zeros(1, 2048, 16, 192, dtype=torch.bfloat16).transpose(1, 2)
    v = torch.zeros(1, 2048, 16, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert fa.route(q, q, v) == "tc"
    assert fa.route(q.float(), q.float(), v.float()) == "simt"
    assert fa.route(q, q, torch.zeros(1, 16, 2048, 96, dtype=torch.bfloat16)) == "simt"


def test_flash_checks_value_shapes():
    q = torch.zeros(1, 4, 8, 192)
    with pytest.raises(ValueError, match="hd_v"):
        fa.flash_attention(q, q, torch.zeros(1, 4, 9, 128))
    out = fa.flash_attention(q, q, torch.zeros(1, 4, 8, 128), scale=0.5)
    assert out.shape == (1, 4, 8, 128)


def test_latent_split_cap_keeps_partials_small():
    """Chunks of at least LATENT_MIN_CHUNK positions: at deepseek's decode (16
    heads, a 4096-slot cache) and length 2048, 16 live chunks of 128 and
    526,336 bytes of f32 partials against 2,359,296 bytes of cache (22.3%),
    where the GQA rule's 132 chunks of 16 would write 4.3 MB."""
    splits, gc = pa.latent_plan(1, 16, 4096)
    assert (splits, gc) == (32, 16) and pa.LATENT_MIN_CHUNK == 128
    for length in (1, 64, 127, 128, 129, 1000, 2048, 2049, 4095, 4096):
        c = pa.chunk_len(length, splits, pa.LATENT_MIN_CHUNK)
        bounds = pa.chunk_bounds(length, splits, pa.LATENT_MIN_CHUNK)
        assert c >= 128 and c % 16 == 0
        assert bounds[0][0] == 0 and bounds[-1][1] == length
        assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
        live = sum(hi > lo for lo, hi in bounds)
        partial = live * gc * (512 + 2) * 4
        # At most 22.3% of the chunks' cache bytes; the chunks hold the
        # length and at most one chunk's slack.
        assert partial <= 0.224 * live * c * 576 * 2 and (live - 1) * c < length
    live = sum(hi > lo for lo, hi in pa.chunk_bounds(2048, splits, pa.LATENT_MIN_CHUNK))
    assert live == 16 and live * 16 * 514 * 4 == 526_336
    assert pa.scratch_floats(1, 1, 16, 512, splits) == 32 * 16 * 514
    gqa_splits = pa.plan(1, 1, 16, 4096)[0]
    assert gqa_splits * 16 * 514 * 4 > 4e6  # what the GQA rule would plan
    # The GQA route's rule is unchanged by the floor.
    for length in range(1, 4097, 37):
        assert pa.chunk_len(length, 132) == pa.chunk_len(length, 132, pa.MIN_CHUNK)
    assert pa.latent_plan(4, 16, 64) == (1, 16) and pa.latent_plan(1, 40, 4096) == (32, 16)


# -- the CUDA branches through stand-in libraries -------------------------------------


def _strides(args):
    return ctypes.cast(args[4], ctypes.POINTER(ctypes.c_longlong))[:12]


class _FakeLibrary:
    """Stands in for a built kernel library: records each entry point's
    arguments and returns ``error``."""

    def __init__(self, error=0):
        self.calls = []
        self.error = error

    def __getattr__(self, name):
        if name.endswith("_error_string"):
            return lambda err: b"an illegal memory access was encountered"
        if not name.startswith("remop_"):
            raise AttributeError(name)

        def entry(*args):
            if name.startswith("remop_flash"):  # the strides live for the call only
                args = (*args[:4], _strides(args), *args[5:])
            self.calls.append((name, args))
            return self.error

        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """Makes the wrappers take their CUDA branch on CPU tensors with a
    stand-in library; records the buffers ``torch.empty`` allocates."""
    monkeypatch.setattr(runtime, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(runtime, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    allocated = []
    empty = torch.empty

    def recording_empty(*args, **kwargs):
        out = empty(*args, **kwargs)
        allocated.append(out)
        return out

    monkeypatch.setattr(torch, "empty", recording_empty)
    runtime.reset_launches()

    def install(lib):
        monkeypatch.setattr(runtime, "library", lambda name: lib)
        return lib

    yield install, allocated
    runtime.reset_launches()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_latent_cuda_branch_launches_once_with_its_plan(fake_card, dtype):
    install, allocated = fake_card
    lib = install(_FakeLibrary())
    q = torch.zeros(1, 16, 576, dtype=dtype)
    latent = torch.zeros(1, 4096, 576, dtype=dtype)
    ln = torch.tensor([2048], dtype=torch.int32)
    out = remop_latent_decode(q, latent, ln, 1.0 / math.sqrt(192))
    (entry, args), = lib.calls
    assert entry == f"remop_latent_decode_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
    # q, latent, lengths, out, scratch, b, h, s, splits, gc, min_chunk, scale, stream
    assert args[:4] == (q.data_ptr(), latent.data_ptr(), ln.data_ptr(), out.data_ptr())
    assert args[5:11] == (1, 16, 4096, 32, 16, 128)
    assert args[11] == pytest.approx(192 ** -0.5)
    assert out.shape == (1, 16, 512) and out.dtype == dtype
    scratch, = [t for t in allocated if t.data_ptr() == args[4]]
    assert scratch.dtype == torch.float32 and scratch.numel() == 32 * 16 * 514
    assert dict(runtime.launches) == {"paged_attention_latent": 1}


def test_latent_cuda_branch_refuses_what_the_kernel_does_not_take(fake_card):
    install, _ = fake_card
    lib = install(_FakeLibrary())
    ln = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="576, 512"):
        remop_latent_decode(torch.zeros(1, 4, 40), torch.zeros(1, 16, 40), ln, 0.2, v_dim=32)
    with pytest.raises(ValueError, match="contiguous"):
        pa.latent_decode(torch.zeros(1, 4, 1152)[..., :576], torch.zeros(1, 16, 576), ln, 0.2)
    with pytest.raises(TypeError, match="int32"):
        pa.latent_decode(torch.zeros(1, 4, 576), torch.zeros(1, 16, 576), ln.long(), 0.2)
    assert lib.calls == [] and sum(runtime.launches.values()) == 0
    lib.error = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        pa.latent_decode(torch.zeros(1, 4, 576), torch.zeros(1, 16, 576), ln, 0.2)
    assert len(lib.calls) == 1 and sum(runtime.launches.values()) == 0


def test_flash_192_128_takes_the_tc_entry_point_and_counts_its_pair(fake_card):
    install, _ = fake_card
    lib = install(_FakeLibrary())
    b, s, h = 1, 777, 16
    q = torch.zeros(b, s, h, 192, dtype=torch.bfloat16).transpose(1, 2)
    v = torch.zeros(b, s, h, 128, dtype=torch.bfloat16).transpose(1, 2)
    out = remop_flash_attention(q, q, v)
    (name, args), = lib.calls
    assert name == "remop_flash_attention_tc"
    assert out.shape == (b, h, s, 128) and out.stride() == (s * h * 128, 128, h * 128, 1)
    assert args[4] == [*q.stride()[:3], *q.stride()[:3], *v.stride()[:3], *out.stride()[:3]]
    assert args[5:13] == (b, h, h, s, s, 192, 128, 128)  # b h kv s t hd bq bk
    assert args[13] == pytest.approx(192 ** -0.5) and args[14:16] == (1, 128)  # split, hd_v
    assert dict(runtime.launches) == {"flash_attention": 1, "flash_attention_tc": 1,
                                      "flash_attention_tc_192x128": 1}
    fa.flash_attention(q.float(), q.float(), v.float(), bq=32, bk=48, scale=0.25)
    name, args = lib.calls[-1]
    assert name == "remop_flash_attention_f32" and args[11] == 32 and args[13:15] == (0.25, 128)
    assert runtime.launches["flash_attention_simt_192x128"] == 1
    with pytest.raises(ValueError, match="value width"):
        fa.flash_attention(q, q, torch.zeros(b, h, s, 64, dtype=torch.bfloat16))


# -- the whole model --------------------------------------------------------------------


def _models(**over):
    jcfg, cfg = _cfgs(**over)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module", params=[{}, {"capacity_factor": 1.0}], ids=["cf4", "cf1"])
def models(request):
    return _models(**request.param)


def test_params_from_jax_carries_the_mla_tree(models):
    jcfg, jparams, cfg, params = models
    assert sorted(k for k in jparams if k.startswith("seg")) == ["seg0", "seg1"]
    assert list(jparams["seg0"]) == ["b0_mla"] and list(jparams["seg1"]) == ["b0_mla_moe"]
    assert tf.param_count(params) == jtf.param_count(jparams)
    dense, mla_moe = params["layers"]
    assert set(dense) == {"norm1", "attn", "norm2", "mlp"}
    assert set(mla_moe) == {"norm1", "attn", "norm2", "moe"} and "shared" in mla_moe["moe"]
    assert set(dense["attn"]) == {"wq", "w_dkv", "kv_norm", "w_uk", "w_uv", "w_kr", "wo"}
    jattn_last = jax.tree.map(lambda a: a[-1], jparams["seg1"]["b0_mla_moe"]["attn"])
    for name in ("wq", "w_dkv", "w_uk", "w_uv", "w_kr", "wo"):
        assert mla_moe["attn"][name]["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            mla_moe["attn"][name]["w"].float().numpy(),
            np.asarray(jattn_last[name]["w"].astype(jnp.bfloat16), np.float32))
    assert mla_moe["attn"]["kv_norm"]["scale"].dtype == torch.float32
    fresh = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), fresh)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), params))


def test_cache_struct_and_pad_caches_match_jax(models):
    jcfg, jparams, cfg, params = models
    spec = tf.cache_struct(cfg, 2, 24)
    jspec = jtf.cache_struct(jcfg, 2, 24)
    want = [(tuple(c.shape[1:]), tuple(r.shape[1:]))
            for seg in jspec for c, r in seg.values() for _ in range(c.shape[0])]
    assert [(tuple(c), tuple(r)) for (c, _), (r, _) in spec] == want
    assert want == [((2, 24, 32), (2, 24, 8))] * 2
    assert all(c[1] == r[1] == torch.bfloat16 for c, r in spec)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    _, caches = tf.prefill(params, cfg, {"tokens": torch.from_numpy(prompt)})
    _, jcaches = jtf.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)})
    padded = tf.pad_caches(cfg, caches, 24)
    jpadded = jtf.pad_caches(jcfg, jcaches, 24)
    jflat = [tuple(a[i] for a in seg[name]) for seg in jpadded for name in seg
             for i in range(seg[name][0].shape[0])]
    for (c, r), (jc, jr), (c0, _) in zip(padded, jflat, caches):
        assert (tuple(c.shape), tuple(r.shape)) == (jc.shape, jr.shape) == ((2, 24, 32), (2, 24, 8))
        assert attn.mla_latent((c, r)).shape == (2, 24, 40)
        torch.testing.assert_close(c[:, :12], c0, rtol=0, atol=0)
        _close(c, jc, BF16_TOL)
        _close(r, jr, BF16_TOL)


@pytest.fixture
def jax_routing(monkeypatch):
    """Runs the JAX model unrolled and records the ids of every
    ``jax.lax.top_k`` it calls, so each MoE call's routing can be read."""
    monkeypatch.setattr(jtf, "_UNROLL", True)
    calls = []
    top_k = jax.lax.top_k

    def recording(x, k):
        out = top_k(x, k)
        calls.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    return calls


@contextlib.contextmanager
def _recorded(log):
    dispatch = moe.dispatch_dense

    def recording(x, ids, n_experts, cap):
        out = dispatch(x, ids, n_experts, cap)
        log.append((ids, out[1]))
        return out

    moe.dispatch_dense = recording
    try:
        yield log
    finally:
        moe.dispatch_dense = dispatch


def _routed(fn):
    with _recorded([]) as log:
        out = fn()
    return out, [ids.numpy() for ids, _ in log], sum(int((~keep).sum()) for _, keep in log)


def test_prefill_and_teacher_forced_decode_match_jax(models, jax_routing):
    """Routing first (a near-tie goes where the router product's last bit
    puts it), then the logits, in prefill and over teacher-forced decode."""
    jcfg, jparams, cfg, params = models
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    jlogits, jcaches = jtf.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompt)})
    (logits, caches), ids, dropped = _routed(
        lambda: tf.prefill(params, cfg, {"tokens": torch.from_numpy(prompt)}))
    assert len(ids) == len(jax_routing) == 1
    np.testing.assert_array_equal(ids[0], jax_routing[0])
    assert (dropped > 0) == (cfg.capacity_factor < cfg.n_experts / cfg.experts_per_token)
    _close(logits, jlogits, BF16_TOL)
    max_len = 20
    jcaches = jtf.pad_caches(jcfg, jcaches, max_len)
    caches = tf.pad_caches(cfg, caches, max_len)
    token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    for pos in range(12, 17):
        jax_routing.clear()
        jlogits, jcaches = jtf.decode_step(jparams, jcfg, jcaches, token,
                                           jnp.asarray(pos, jnp.int32))
        (logits, caches), ids, dropped = _routed(lambda: tf.decode_step(
            params, cfg, caches, torch.from_numpy(np.array(token)), pos))
        assert dropped == 0 and len(ids) == len(jax_routing) == 1
        np.testing.assert_array_equal(ids[0], jax_routing[0])
        _close(logits, jlogits, BF16_TOL)
        token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)


def test_forward_matches_jax(models, jax_routing):
    jcfg, jparams, cfg, params = models
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 10), dtype=np.int32)
    jlogits, jaux, _ = jtf.forward(jparams, jcfg, {"tokens": jnp.asarray(prompt)})
    (logits, aux, _), ids, _ = _routed(
        lambda: tf.forward(params, cfg, {"tokens": torch.from_numpy(prompt)}))
    np.testing.assert_array_equal(ids[0], jax_routing[0])
    _close(logits, jlogits, BF16_TOL)
    assert abs(float(aux) - float(jaux)) <= 1e-3 * abs(float(jaux))


def test_serve_engine_decodes_as_prefill_does():
    """Through ``ServeEngine.submit``: the last decode step's logits equal a
    prefill of the same tokens to bf16 precision, and the slots keep their
    MLA caches apart."""
    _, cfg = _cfgs()
    params = tf.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in (9, 5, 13)]
    last = {}

    def keep_last(req, logits, hidden):
        last[req.rid] = logits.float().clone()

    engine = ServeEngine(cfg, params, max_len=32, batch_slots=2, device="cpu",
                         on_step=keep_last)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    results = engine.submit(reqs)
    assert sorted(results) == [0, 1, 2]
    for req in reqs:
        assert len(req.out_tokens) == 6
        tokens = np.concatenate([req.prompt, np.asarray(req.out_tokens[:-1], np.int32)])
        logits, _ = tf.prefill(params, cfg, {"tokens": torch.from_numpy(tokens[None])})
        _close(last[req.rid], logits[0].float(), 2 * BF16_TOL)


def test_serve_cli_runs_reduced_deepseek_on_the_cpu(capsys):
    results = serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                              "--max-new-tokens", "3"])
    assert sorted(results) == [0, 1] and all(len(v) == 3 for v in results.values())
    assert "2 requests, 6 tokens" in capsys.readouterr().out
