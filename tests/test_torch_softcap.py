"""The attention logit softcap in the port against the JAX package, on the CPU.

``repro`` caps the scaled scores before the mask, ``s = tanh(s / cap) *
cap``, in ``full_attention`` and ``chunked_attention`` (T > 8192), so in
every prefill path (causal, windowed, prefix-LM, bidirectional, cross) and
in ``gqa_decode``; its ``mla_decode`` and its cross-attention decode apply
no cap.  The port passes the cap to the flash and paged kernels; their
plain versions are held here to ``repro``'s jnp attention within the JAX
kernel tests' tolerances (``KERNEL_TOL``: 2e-5 f32, 3e-2 bf16, as a share
of the output's largest magnitude), and reduced gemma-2b, recurrentgemma,
paligemma, seamless and deepseek to ``repro``'s ``forward``, ``prefill``
and teacher-forced ``decode_step`` within ``BF16_TOL`` = 1e-2 of the
logits' scale.

A cap that does not bite checks nothing (a score of size 1 under a cap of
50 moves by 1e-4), so every check uses a cap that bites: 5 on q times 8 at
the kernels, 0.5 in the models (``MODEL_CAP``, with ``wq`` times 2).  Each asserts that at least
10% of the scores it caps exceed the cap (at the kernels the visible ones;
in the models all the scores handed to the cap, the masked ones among them
come from the same q and k), and that the capped output differs from the
uncapped one by more than 10 times the tolerance.
"""

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
from repro_torch.kernels.flash_attention.ops import remop_flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention.ops import remop_paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax

CAP = 5.0
GAIN = 8.0
# The models' cap and the gain on their wq: scores of a few units at random
# init, where repro's bf16 scores are as fine as the port's f32 ones (scores
# of 20 carry bf16 steps of 0.06 into its softmax, 4% of the logits); a cap
# of 0.5 bites most of them.  deepseek keeps gain 1: at 2 one of its 80
# routings flips on a near-tie (routing follows the router product's last
# bit, tests/test_torch_mla.py), which is not what this test reads.
MODEL_CAP = 0.5
MODEL_GAIN = {"deepseek-v2-lite-16b": 1.0}
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
BF16_TOL = 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got: torch.Tensor, want) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _close(got, want, tol: float) -> float:
    err = _rel(got, want)
    assert err <= tol, err
    return err


def _bites(scores: torch.Tensor, visible: torch.Tensor) -> float:
    share = float((scores.abs() > CAP)[visible.expand_as(scores)].float().mean())
    assert share >= 0.1, share
    return share


def _qkv(seed, b, h, kv, s, t, hd, dtype):
    """q [B, H, S, hd] times GAIN, k and v [B, KV, T, hd], as numpy f32
    exact in ``dtype``, and the port's tensors."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrays = [np.asarray(jnp.asarray(rng.standard_normal(shape).astype(np.float32) * g)
                         .astype(jdt).astype(jnp.float32))
              for shape, g in (((b, h, s, hd), GAIN), ((b, kv, t, hd), 1.0),
                               ((b, kv, t, hd), 1.0))]
    return arrays, [torch.from_numpy(a).to(tdt) for a in arrays]


def _jax_attention(arrays, dtype, q_pos, kv_pos, window=0, grouped=False):
    """``repro``'s ``full_attention`` (or ``grouped_attention``, which
    takes ``chunked_attention`` past 8192 keys) with the cap, in the
    port's layout [B, H, S, hd]."""
    q, k, v = (jnp.asarray(a).astype(DTYPES[dtype][0]) for a in arrays)
    b, h, s, hd = q.shape
    kv = k.shape[1]
    qg = q.transpose(0, 2, 1, 3).reshape(b, s, kv, h // kv, hd)
    fn = jattn.grouped_attention if grouped else jattn.full_attention
    out = fn(qg, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3), jnp.asarray(q_pos),
             jnp.asarray(kv_pos), window, CAP)
    return out.reshape(b, s, h, hd).transpose(0, 2, 1, 3)


def _scores(q, k):
    b, h, s, hd = q.shape
    kv = k.shape[1]
    qg = q.float().reshape(b, kv, h // kv, s, hd)
    return torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(hd)


# (b, h, kv, s, t, hd, window, prefix): causal, windowed, prefix-LM, every key (cross, S != T)
FLASH_CASES = {
    "causal": (2, 4, 2, 100, 100, 32, 0, 0),
    "windowed": (2, 4, 2, 100, 100, 32, 16, 0),
    "prefix": (1, 4, 1, 100, 100, 64, 0, 24),
    "bidirectional": (1, 2, 2, 70, 70, 16, 0, 70),
    "cross": (2, 4, 2, 30, 70, 32, 0, 70),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_with_a_cap_matches_jax_full_attention(dtype, case):
    b, h, kv, s, t, hd, window, prefix = FLASH_CASES[case]
    arrays, (q, k, v) = _qkv(len(case), b, h, kv, s, t, hd, dtype)
    if prefix >= t:  # every key: repro's cross-attention positions (q 1e9 over kv 0)
        q_pos = np.full((b, s), 10 ** 9, np.int32)
        kv_pos = np.zeros((b, t), np.int32)
    else:  # mask_pos: causal is pos, prefix-LM max(pos - P + 1, 0)
        pos = np.arange(t, dtype=np.int32)
        mask_pos = np.maximum(pos - prefix + 1, 0) if prefix else pos
        q_pos = kv_pos = np.broadcast_to(mask_pos, (b, t))
    want = _jax_attention(arrays, dtype, q_pos, kv_pos, window)
    got = fa.flash_attention_plain(q, k, v, bk=16, window=window, prefix=prefix, softcap=CAP)
    tol = KERNEL_TOL[dtype]
    _close(got, want, tol)
    _close(remop_flash_attention(q, k, v, window=window, prefix=prefix, softcap=CAP), want, tol)
    if not window:
        _close(flash_attention_ref(q, k, v, prefix=prefix, softcap=CAP), want, tol)
    qp = torch.arange(s)[:, None] + (t - s)
    kp = torch.arange(t)[None, :]
    visible = (kp <= qp) | (kp < prefix)
    if window:
        visible &= qp - kp < window
    _bites(_scores(q, k), visible)
    uncapped = fa.flash_attention_plain(q, k, v, bk=16, window=window, prefix=prefix)
    assert _rel(uncapped, want) > 10 * tol


def test_flash_plain_with_a_cap_matches_jax_chunked_attention():
    """T > 8192: ``repro`` streams the keys in chunks of 1024
    (``chunked_attention``) and caps there; 64 queries at the end of 8300
    keys, narrow heads, f32."""
    b, h, kv, s, t, hd = 1, 2, 1, 64, 8300, 16
    assert t > jattn._CHUNK_THRESHOLD
    arrays, (q, k, v) = _qkv(11, b, h, kv, s, t, hd, "float32")
    q_pos = np.broadcast_to(np.arange(t - s, t, dtype=np.int32), (b, s))
    kv_pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    want = _jax_attention(arrays, "float32", q_pos, kv_pos, grouped=True)
    got = fa.flash_attention_plain(q, k, v, softcap=CAP)
    _close(got, want, KERNEL_TOL["float32"])
    _bites(_scores(q, k), torch.arange(t)[None, :] <= torch.arange(t - s, t)[:, None])
    assert _rel(fa.flash_attention_plain(q, k, v), want) > 10 * KERNEL_TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,hd,s,lengths", [(8, 64, 300, (300, 129)), (3, 32, 200, (1, 77)),
                                            (10, 16, 64, (64, 40))])
def test_paged_plain_with_a_cap_matches_jax_decode(dtype, g, hd, s, lengths):
    """``repro``'s decode attention (``full_attention`` of one query at
    ``pos = length - 1`` over the positions up to it) with the cap, against
    the paged kernel's plain version, its entry point and the dense oracle."""
    rng = np.random.default_rng(g + hd)
    jdt, tdt = DTYPES[dtype]
    b, kv = len(lengths), 2
    arrays = [np.asarray(jnp.asarray(rng.standard_normal(shape).astype(np.float32) * gain)
                         .astype(jdt).astype(jnp.float32))
              for shape, gain in (((b, kv, g, hd), GAIN), ((b, s, kv, hd), 1.0),
                                  ((b, s, kv, hd), 1.0))]
    q, kc, vc = (torch.from_numpy(a).to(tdt) for a in arrays)
    ln = torch.tensor(lengths, dtype=torch.int32)
    idx = np.arange(s)
    kv_pos = np.where(idx[None] < np.asarray(lengths)[:, None], idx[None], 10 ** 9)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    want = jattn.full_attention(jq[:, None], jk, jv, jnp.asarray(np.asarray(lengths)[:, None] - 1),
                                jnp.asarray(kv_pos), softcap=CAP)[:, 0]
    tol = KERNEL_TOL[dtype]
    page = 64 if s % 64 == 0 else 100
    _close(pa.paged_attention_plain(q, kc, vc, ln, page, softcap=CAP), want, tol)
    _close(remop_paged_attention(q, kc, vc, ln, softcap=CAP), want, tol)
    _close(paged_attention_ref(q, kc, vc, ln, softcap=CAP), want, tol)
    scores = torch.einsum("bkgd,bskd->bkgs", q.float(), kc.float()) / math.sqrt(hd)
    _bites(scores, (torch.arange(s)[None, :] < ln[:, None])[:, None, None, :])
    assert _rel(remop_paged_attention(q, kc, vc, ln), want) > 10 * tol


def test_softcap_must_be_zero_or_positive():
    q = torch.zeros(1, 1, 4, 16)
    for bad in (-1.0, math.inf, math.nan):
        with pytest.raises(ValueError, match="softcap"):
            fa.flash_attention(q, q, q, bq=4, bk=4, softcap=bad)
        with pytest.raises(ValueError, match="softcap"):
            pa.paged_attention(q, q.transpose(1, 2), q.transpose(1, 2),
                               torch.tensor([4], dtype=torch.int32), page=4, softcap=bad)


# -- whole models ---------------------------------------------------------------------

# Reduced configs and their batches: (config overrides, prompt tokens, extra inputs).
MODEL_CASES = {
    "gemma-2b": {},
    "recurrentgemma-2b": {"n_layers": 3},  # rec, rec, attn_local; prompt past its window
    "paligemma-3b": {"n_layers": 2},
    "seamless-m4t-large-v2": {"n_layers": 2},
    "deepseek-v2-lite-16b": {"n_experts": 8},
}
SEQ = 40
FRAMES = 24


def _gained(jparams, gain: float):
    """Every attention's ``wq`` times ``gain`` (self and cross, GQA and MLA)."""
    def leaf(path, a):
        return a * gain if any(getattr(k, "key", None) == "wq" for k in path) else a

    return jax.tree_util.tree_map_with_path(leaf, jparams)


def _models(arch):
    over = {**MODEL_CASES[arch], "attn_softcap": MODEL_CAP}
    jcfg, cfg = jax_reduced(JAX_ARCHS[arch], **over), reduced(ARCHS[arch], **over)
    jparams = _gained(jtf.init_params(jax.random.key(0), jcfg), MODEL_GAIN.get(arch, 2.0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, seed):
    """The numpy batch (tokens; patches for the VLM, frames for the
    encoder-decoder) and the decode's first position."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (2, SEQ), dtype=np.int32)}
    start = SEQ
    if cfg.family == "vlm":
        arrays["patches"] = rng.standard_normal((2, cfg.frontend_seq, cfg.frontend_dim)).astype(
            np.float32)
        start += cfg.frontend_seq
    if cfg.family == "audio_encdec":
        arrays["frames"] = rng.standard_normal((2, FRAMES, cfg.frontend_dim)).astype(np.float32)
    return arrays, start


@pytest.fixture
def cap_shares(monkeypatch):
    """The share of each capped score block above the cap, recorded where
    the kernels' plain versions cap (flash and paged alike)."""
    shares = []
    cap = runtime.cap_scores

    def recording(scores, softcap):
        if softcap:
            shares.append(float((scores.abs() > softcap).float().mean()))
        return cap(scores, softcap)

    monkeypatch.setattr(runtime, "cap_scores", recording)
    monkeypatch.setattr(jtf, "_UNROLL", True)
    return shares


@pytest.mark.parametrize("arch", sorted(MODEL_CASES))
def test_models_with_a_biting_cap_match_jax(arch, cap_shares):
    """``forward``, ``prefill`` and 4 teacher-forced ``decode_step`` calls
    against ``repro``'s; seamless's cross decode and deepseek's MLA decode
    take no cap in either package."""
    jcfg, jparams, cfg, params = _models(arch)
    arrays, start = _batch(cfg, 5)
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    jlogits, _, _ = jtf.forward(jparams, jcfg, jbatch)
    logits, _, _ = tf.forward(params, cfg, batch)
    _close(logits, jlogits, BF16_TOL)
    assert cap_shares and min(cap_shares) >= 0.1, cap_shares
    uncapped, _, _ = tf.forward(params, dataclasses.replace(cfg, attn_softcap=0.0), batch)
    assert _rel(uncapped, jlogits) > 10 * BF16_TOL

    jlogits, jcaches = jtf.prefill(jparams, jcfg, jbatch)
    logits, caches = tf.prefill(params, cfg, batch)
    _close(logits, jlogits, BF16_TOL)
    max_len = start + 8
    jcaches = jtf.pad_caches(jcfg, jcaches, max_len)
    caches = tf.pad_caches(cfg, caches, max_len)
    token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    del cap_shares[:]
    for pos in range(start, start + 4):
        jlogits, jcaches = jtf.decode_step(jparams, jcfg, jcaches, token,
                                           jnp.asarray(pos, jnp.int32))
        logits, caches = tf.decode_step(params, cfg, caches, torch.from_numpy(np.array(token)),
                                        pos)
        _close(logits, jlogits, BF16_TOL)
        token = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    # Decode caps where repro's does: every GQA self-attention; neither MLA's
    # absorbed decode nor a cross-attention decode.
    assert bool(cap_shares) == (not tf.is_mla(cfg))
    assert min(cap_shares, default=1.0) >= 0.1, cap_shares


def test_cross_and_mla_decode_ignore_the_cap():
    """``repro``'s cross-attention decode (``block_decode``'s
    ``full_attention`` without ``cfg.attn_softcap``) and its ``mla_decode``
    apply no cap, though their forwards do; so with a cap that bites, the
    port's ``cross_decode`` and ``mla_decode`` give their uncapped results
    bit for bit and differ from the capped forward's row."""
    cfg = reduced(ARCHS["seamless-m4t-large-v2"])
    capped = dataclasses.replace(cfg, attn_softcap=CAP)
    p = attn.init_gqa(cfg, torch.Generator().manual_seed(0), "cpu")
    p["wq"]["w"] = p["wq"]["w"] * GAIN
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)).bfloat16()
    xa = torch.from_numpy(rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)).bfloat16()
    fwd, kv = attn.gqa_forward(p, capped, x, None, xa=xa, return_kv=True)
    dec = attn.cross_decode(p, capped, x, kv)
    torch.testing.assert_close(dec, attn.cross_decode(p, cfg, x, kv), rtol=0, atol=0)
    _close(dec, attn.gqa_forward(p, cfg, x, None, xa=xa).float().numpy(), BF16_TOL)
    assert _rel(dec, fwd.float().numpy()) > 10 * BF16_TOL

    mcfg = reduced(ARCHS["deepseek-v2-lite-16b"])
    mcapped = dataclasses.replace(mcfg, attn_softcap=CAP)
    mp = attn.init_mla(mcfg, torch.Generator().manual_seed(0), "cpu")
    mp["wq"]["w"] = mp["wq"]["w"] * GAIN
    xs = torch.from_numpy(rng.standard_normal((2, 12, mcfg.d_model)).astype(np.float32))
    pos = torch.arange(12)[None].expand(2, 12)
    fwd, cache = attn.mla_forward(mp, mcapped, xs, pos, return_cache=True)
    _, prefix_cache = attn.mla_forward(mp, mcapped, xs[:, :11], pos[:, :11], return_cache=True)
    steps = [attn.mla_decode(mp, c, xs[:, 11:], attn.mla_pad(prefix_cache, 16), 11)[0]
             for c in (mcfg, mcapped)]
    torch.testing.assert_close(steps[1], steps[0], rtol=0, atol=0)
    uncapped = attn.mla_forward(mp, mcfg, xs, pos)
    _close(steps[1], uncapped[:, 11:].numpy(), 1e-4)
    assert _rel(steps[1], fwd[:, 11:].numpy()) > 10 * 1e-4
