"""GQA/MQA and MLA attention over the flash (prefill) and paged (decode) kernels.

The JAX package's ``models/attention.py`` computes attention with a jnp
einsum softmax (``full_attention``) and keeps ``chunked_attention`` as the
kernels' pure-jnp oracle; here both paths go through the kernels:
``gqa_forward`` through :func:`remop_flash_attention` (causal, offset 0) and
``gqa_decode`` through :func:`remop_paged_attention` with
``lengths = min(pos + 1, S)``.  The kernels keep P in f32 where
``full_attention`` rounds scores and P to bf16, so the two agree to bf16
precision, not bit for bit.

Decode writes the new K/V row into the caller's cache in place (slot
``min(pos, S - 1)``, as JAX's ``dynamic_update_slice`` writes it), which
saves copying the cache every step.

Local attention (``window = W > 0``, recurrentgemma's ``"attn_local"``
blocks): the prefill passes ``window`` to the flash kernel, so a query at
position ``q`` sees keys ``q - W + 1 .. q``; the decode cache is a ring of
``W`` slots, position ``pos`` written at slot ``pos % W``
(:func:`cache_slot`).  The ring then holds exactly the positions ``pos - W
+ 1 .. pos``, every one inside the window, in slots ``0 .. min(pos + 1, W)
- 1`` (:func:`cache_length`); softmax does not depend on the slots' order,
so the paged kernel reads the ring as it reads any cache.  Only the callers
decide the window: ``cfg.window`` is ``repro``'s setting for its
``"attn_local"`` blocks and is ignored here, as ``repro``'s dense, MoE and
MLA blocks ignore it.

MLA (multi-head latent attention, DeepSeek-V2) keeps ``repro``'s parameter
names and math: one shared rope head, prefill through the flash kernel at
q/k width ``nope + rope`` (192) and v width ``v_head_dim`` (128), and the
absorbed-weight decode (``q_abs = q_nope W_uk^T``, ``out = ctx W_uv``) over
the compressed cache through the paged kernel's latent route.  The cache is
``repro``'s pair ``(c_kv [B, S, lora], k_rope [B, S, rope])``, held as
views of one ``[B, S, lora + rope]`` buffer (:func:`mla_cache`), the rows
the latent route reads once for scores and context.  The products outside
attention (projections, the absorption of ``W_uk`` and ``W_uv``) are
``torch.matmul``, as ``repro`` computes them outside any Pallas kernel.  The
latent route scores and weighs in f32 and rounds the context once; ``repro``
rounds the two score terms and P to bf16, so they agree to bf16 precision.

Prefix-LM and bidirectional masks: ``repro`` bends ``mask_pos`` (the
positions its causal mask compares) where the flash kernel takes one
integer, ``prefix``: key ``k`` is seen by the query at ``q`` iff ``k <= q``
or ``k < prefix``.  paligemma's ``mask_pos = max(pos - P + 1, 0)`` over its
``P`` image patches is ``prefix = P``; the encoder's all-zero ``mask_pos``
is ``prefix = S`` (every key).  Cross-attention (``gqa_forward(xa=...)``,
``repro``'s ``q_pos = 1e9`` over ``kv_pos = 0``) is the flash kernel at
``prefix = T_enc`` with q from ``x`` and k, v from ``xa``, none roped; its
decode (:func:`cross_decode`) is the paged kernel over the fixed ``[B,
T_enc, KV, hd]`` cross cache at ``lengths = T_enc``.

Attention logit softcap (``cfg.attn_softcap``, ``s = tanh(s / cap) * cap``
after the scale and before the mask) is a kernel argument, given where
``repro`` applies it: ``gqa_forward`` (every mask, cross-attention
included), ``mla_forward`` and ``gqa_decode``.  ``repro``'s ``mla_decode``
and its cross-attention decode (``block_decode``'s ``full_attention`` with
no cap) ignore it, and so do :func:`mla_decode` and :func:`cross_decode`.

int8 KV cache: ``repro``'s ``(k_q, v_q, k_scale, v_scale)``, int8 ``[B, S,
KV, hd]`` values and bf16 ``[B, S, KV, 1]`` scales (:func:`quantize_kv`,
:func:`dequantize_kv`, the ``KV_QUANT`` flag that :func:`cache_struct
<repro_torch.models.transformer.cache_struct>` reads).  :func:`gqa_decode`
takes such a cache: it quantizes the new row, writes it at the slot and
attends through the paged kernel's int8 route, which reads the int8 rows and
their scales.  As in ``repro``, nothing quantizes on its own (``prefill``
gives bf16 caches; a caller quantizes them), and cross and MLA caches are
never quantized.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import remop_flash_attention
from repro_torch.kernels.paged_attention.ops import (
    remop_latent_decode, remop_paged_attention, remop_paged_attention_int8)
from repro_torch.models.layers import (
    Params, apply_rope, dense, init_dense, init_rmsnorm, rmsnorm, rope_tables,
)

KVCache = Tuple[torch.Tensor, ...]  # (k, v), or (k_q, v_q, k_scale, v_scale) in int8

# int8 KV-cache quantization (decode), as in repro: per-(token, head) scales.
KV_QUANT = False


def set_kv_quant(flag: bool) -> None:
    global KV_QUANT
    KV_QUANT = flag


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., hd] -> (int8 values, bf16 scale [..., 1]): ``max(|x|, 1e-6) /
    127`` in f32, the values rounded half to even against that f32 scale and
    clipped to ±127, the scale stored rounded to bf16, as ``repro`` does."""
    xf = x.float()
    amax = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-6)
    # A tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which rounds some scales a bit off repro's division.
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``repro``'s ``dequantize_kv``: ``float(q) * float(scale)`` rounded to
    ``dtype`` once."""
    return (q.float() * scale.float()).to(dtype)


def _supported(cfg: ModelConfig) -> None:
    if cfg.attn_type not in ("gqa", "mla"):
        raise NotImplementedError(f"{cfg.attn_type} attention: not in the port")


def _pair(cache: KVCache, what: str) -> KVCache:
    if len(cache) != 2:
        raise ValueError(f"{what} takes a (k, v) cache; repro never quantizes it, got "
                         f"{len(cache)} tensors")
    return cache


def init_gqa(cfg: ModelConfig, generator: torch.Generator, device: torch.device) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init_dense(d, h * hd, generator, device),
        "wk": init_dense(d, kv * hd, generator, device),
        "wv": init_dense(d, kv * hd, generator, device),
        "wo": init_dense(h * hd, d, generator, device, scale=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, device)
        p["k_norm"] = init_rmsnorm(hd, device)
    return p


def _gqa_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(p["wq"], x).view(b, s, h, hd)
    k = dense(p["wk"], x).view(b, s, kv, hd)
    v = dense(p["wv"], x).view(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                window: int = 0, prefix: int = 0, xa: Optional[torch.Tensor] = None,
                return_kv: bool = False):
    """Causal self-attention over the whole sequence (positions 0 .. S-1),
    with ``window > 0`` over each query's last ``window`` keys, with
    ``prefix > 0`` also over every key below ``prefix`` (``repro``'s
    ``mask_pos``: paligemma's ``max(pos - P + 1, 0)`` is ``prefix = P``, the
    encoder's zeros ``prefix = S``).  With ``xa`` [B, T, d] it is
    cross-attention, as in ``repro``: q from ``x``, k and v from ``xa``, no
    RoPE, every key seen (``prefix = T``); ``positions`` and ``prefix`` are
    then unused.

    x: [B, S, d] -> [B, S, d]; with ``return_kv`` also (k, v), each
    [B, S, KV, hd] ([B, T, KV, hd] for cross-attention), from which
    :func:`gqa_decode` (:func:`cross_decode`) continues (a windowed caller
    packs them into a ring first).
    """
    _supported(cfg)
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if xa is None:
        q, k, v = _gqa_qkv(p, cfg, x, positions)
    else:
        q = dense(p["wq"], x).view(b, s, h, hd)
        k = dense(p["wk"], xa).view(b, xa.shape[1], kv, hd)
        v = dense(p["wv"], xa).view(b, xa.shape[1], kv, hd)
        prefix = xa.shape[1]
    # [B, S, heads, hd] viewed as the kernel's [B, heads, S, hd]; the output
    # comes back in q's memory layout, so the reshape below is free.
    out = remop_flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                window=window, prefix=prefix, softcap=cfg.attn_softcap)
    out = dense(p["wo"], out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim))
    return (out, (k, v)) if return_kv else out


def cache_slot(pos: int, size: int, window: int) -> int:
    """The slot decode writes position ``pos`` to in a cache of ``size``
    slots: ``pos % size`` in a ring (``window > 0``), else ``min(pos, size -
    1)``, as ``repro``'s ``gqa_decode`` writes it."""
    return pos % size if window else min(pos, size - 1)


def cache_length(pos: int, size: int) -> int:
    """The slots ``0 .. n - 1`` the step at ``pos`` attends to, after its own
    row is written: ``min(pos + 1, size)``, in a ring as in a linear cache."""
    return min(pos + 1, size)


def gqa_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: KVCache, pos: int,
               window: int = 0):
    """One-token decode. x: [B, 1, d]; cache (k, v): [B, S, KV, hd], a ring
    of ``S = window`` slots when ``window > 0``, or the int8 cache ``(k_q,
    v_q, k_scale, v_scale)`` of the same slots (the new row quantized by
    :func:`quantize_kv`, attended dequantized, as ``repro`` attends it);
    ``pos`` is the step's position.  Returns (out [B, 1, d], cache) with the
    cache written in place."""
    _supported(cfg)
    if len(cache) not in (2, 4):
        raise ValueError(f"a decode cache is (k, v) or (k_q, v_q, k_scale, v_scale), got "
                         f"{len(cache)} tensors")
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_t, v_t = _gqa_qkv(p, cfg, x, positions)
    s_cache = cache[0].shape[1]
    if window and s_cache != window:
        raise ValueError(f"a windowed decode takes a ring of {window} slots, got {s_cache}")
    slot = cache_slot(pos, s_cache, window)
    lengths = torch.full((b,), cache_length(pos, s_cache), dtype=torch.int32,
                         device=x.device)
    qg = q.view(b, kv, h // kv, hd)
    if len(cache) == 4:
        ckq, cvq, cks, cvs = cache
        (kq, ks), (vq, vs) = quantize_kv(k_t[:, 0]), quantize_kv(v_t[:, 0])
        ckq[:, slot], cvq[:, slot], cks[:, slot], cvs[:, slot] = kq, vq, ks, vs
        out = remop_paged_attention_int8(qg, ckq, cvq, cks, cvs, lengths,
                                         softcap=cfg.attn_softcap)
    else:
        ck, cv = cache
        ck[:, slot] = k_t[:, 0].to(ck.dtype)
        cv[:, slot] = v_t[:, 0].to(cv.dtype)
        out = remop_paged_attention(qg, ck, cv, lengths, softcap=cfg.attn_softcap)
    return dense(p["wo"], out.view(b, 1, h * hd)), cache


def cross_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """One token's cross-attention over the encoder's K/V: x [B, 1, d];
    cache (k, v) [B, T_enc, KV, hd] from ``gqa_forward(xa=...)``, read and
    never written.  The paged kernel at ``lengths = T_enc`` with q unroped,
    as ``repro``'s decode computes it (``full_attention`` with every key
    seen), with no softcap: ``repro``'s decode calls ``full_attention``
    without ``cfg.attn_softcap`` here, though its prefill caps.  Returns out
    [B, 1, d]."""
    _supported(cfg)
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ck, cv = _pair(cache, "cross_decode")
    q = dense(p["wq"], x).view(b, kv, h // kv, hd)
    lengths = torch.full((b,), ck.shape[1], dtype=torch.int32, device=x.device)
    out = remop_paged_attention(q, ck, cv, lengths)
    return dense(p["wo"], out.view(b, 1, h * hd))


def gqa_cache_shape(cfg: ModelConfig, batch: int, seq: int, window: int = 0):
    # Ring caches are always window-sized (slots = pos % window).
    s = window if window else seq
    return (batch, s, cfg.n_kv_heads, cfg.head_dim)


def ring_pack(kv: KVCache, positions: torch.Tensor, window: int) -> KVCache:
    """``repro``'s ``_ring_pack``: the last ``min(window, S)`` positions of
    (k, v) [B, S, KV, hd] at slots ``pos % window`` of new ``[B, window, KV,
    hd]`` rings (zeros elsewhere); ``positions`` [B, S], shared across the
    batch."""
    k, v = kv
    w = min(window, k.shape[1])
    slots = (positions[0, k.shape[1] - w:] % window).long()

    def pack(a):
        ring = a.new_zeros((a.shape[0], window) + tuple(a.shape[2:]))
        ring[:, slots] = a[:, a.shape[1] - w:]
        return ring

    return pack(k), pack(v)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(cfg: ModelConfig, generator: torch.Generator, device: torch.device) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    nope, rope_d, v_hd, lora = (cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim,
                                cfg.kv_lora_rank)
    return {
        "wq": init_dense(d, h * (nope + rope_d), generator, device),
        "w_dkv": init_dense(d, lora, generator, device),
        "kv_norm": init_rmsnorm(lora, device),
        "w_uk": init_dense(lora, h * nope, generator, device),
        "w_uv": init_dense(lora, h * v_hd, generator, device),
        "w_kr": init_dense(d, rope_d, generator, device),
        "wo": init_dense(h * v_hd, d, generator, device, scale=1.0 / math.sqrt(h * v_hd)),
    }


def _mla_q(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    h, nope, rope_d = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    q = dense(p["wq"], x).view(b, s, h, nope + rope_d)
    cos, sin = rope_tables(positions, rope_d, cfg.rope_theta)
    return q[..., :nope], apply_rope(q[..., nope:], cos, sin)


def _mla_ckv(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    c_kv = rmsnorm(p["kv_norm"], dense(p["w_dkv"], x), cfg.norm_eps)
    k_rope = dense(p["w_kr"], x)[:, :, None, :]  # single shared rope head
    cos, sin = rope_tables(positions, cfg.rope_head_dim, cfg.rope_theta)
    return c_kv, apply_rope(k_rope, cos, sin)[:, :, 0, :]


def mla_cache(c_kv: torch.Tensor, k_rope: torch.Tensor) -> KVCache:
    """``(c_kv, k_rope)`` as views of one new ``[B, S, lora + rope]`` buffer."""
    lora = c_kv.shape[-1]
    latent = torch.cat([c_kv, k_rope.to(c_kv.dtype)], dim=-1)
    return latent[..., :lora], latent[..., lora:]


def mla_latent(cache: KVCache) -> torch.Tensor:
    """The ``[B, S, lora + rope]`` buffer an MLA cache's two views share.

    Raises ``ValueError`` unless ``c_kv`` and ``k_rope`` are the two column
    ranges of one buffer with rows of ``lora + rope`` (as :func:`mla_cache`
    and :func:`mla_pad` make them)."""
    c_kv, k_rope = cache
    b, s, lora = c_kv.shape
    width = lora + k_rope.shape[-1]
    if s == 0:  # nothing to share
        return torch.cat([c_kv, k_rope], dim=-1)
    row = (s * width, width, 1)
    if (k_rope.shape[:2] != (b, s) or c_kv.dtype != k_rope.dtype or c_kv.device != k_rope.device
            or c_kv.stride() != row or k_rope.stride() != row
            or k_rope.untyped_storage().data_ptr() != c_kv.untyped_storage().data_ptr()
            or k_rope.storage_offset() != c_kv.storage_offset() + lora):
        raise ValueError("an MLA cache must be (c_kv, k_rope) views of one [B, S, lora + rope] "
                         "buffer; build it with mla_cache")
    return c_kv.as_strided((b, s, width), row)


def mla_pad(cache: KVCache, target_len: int) -> KVCache:
    """The cache grown to ``target_len`` positions with zeros: the shared
    buffer is padded, so the two views still alias one buffer."""
    latent = mla_latent(cache)
    if latent.shape[1] < target_len:
        latent = F.pad(latent, (0, 0, 0, target_len - latent.shape[1]))
    lora = cache[0].shape[-1]
    return latent[..., :lora], latent[..., lora:]


def mla_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                return_cache: bool = False):
    """Causal MLA over the whole sequence: x [B, S, d] -> [B, S, d]; with
    ``return_cache`` also the cache ``(c_kv, k_rope)`` that :func:`mla_decode`
    continues.  Per-head K is ``c_kv W_uk`` beside the shared rope head, V
    is ``c_kv W_uv``; the flash kernel attends at widths 192 / 128 with the
    scale ``1 / sqrt(nope + rope)``, capped by ``cfg.attn_softcap``.
    ``cfg.window`` is ignored, as in ``repro``."""
    _supported(cfg)
    b, s, _ = x.shape
    h, nope, rope_d, v_hd = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_ckv(p, cfg, x, positions)
    k_nope = dense(p["w_uk"], c_kv).view(b, s, h, nope)
    v = dense(p["w_uv"], c_kv).view(b, s, h, v_hd)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rope_d)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    # [B, S, heads, width] viewed as the kernel's [B, heads, S, width]; the
    # output comes back in q's memory layout, so the reshape below is free.
    out = remop_flash_attention(q_full.transpose(1, 2), k_full.transpose(1, 2),
                                v.transpose(1, 2), softcap=cfg.attn_softcap)
    out = dense(p["wo"], out.transpose(1, 2).reshape(b, s, h * v_hd))
    return (out, mla_cache(c_kv, k_rope)) if return_cache else out


def mla_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: KVCache, pos: int):
    """Absorbed-weight decode over the compressed cache. x: [B, 1, d]; cache
    ``(c_kv [B, S, lora], k_rope [B, S, rope])`` as :func:`mla_cache` makes
    it; ``pos`` is the step's position.  Returns (out [B, 1, d], cache) with
    the new row written in place, at slot ``min(pos, S - 1)``.  ``cfg.window``
    and ``cfg.attn_softcap`` are ignored, as in ``repro``'s ``mla_decode``
    (its forward caps)."""
    _supported(cfg)
    _pair(cache, "mla_decode")
    b = x.shape[0]
    h, nope, rope_d, v_hd, lora = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                                   cfg.v_head_dim, cfg.kv_lora_rank)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_t, kr_t = _mla_ckv(p, cfg, x, positions)
    latent = mla_latent(cache)
    s_cache = latent.shape[1]
    slot = cache_slot(pos, s_cache, 0)
    latent[:, slot, :lora] = c_t[:, 0].to(latent.dtype)
    latent[:, slot, lora:] = kr_t[:, 0].to(latent.dtype)
    # Absorb W_uk into q: q_abs[b, h, l] = sum_n q_nope[b, h, n] W_uk[l, (h, n)].
    w_uk = p["w_uk"]["w"].to(x.dtype).view(lora, h, nope)
    q_abs = torch.einsum("bhn,lhn->bhl", q_nope[:, 0], w_uk)
    q_lat = torch.cat([q_abs, q_rope[:, 0].to(q_abs.dtype)], dim=-1)  # [B, H, lora + rope]
    lengths = torch.full((b,), cache_length(pos, s_cache), dtype=torch.int32, device=x.device)
    ctx = remop_latent_decode(q_lat, latent.to(x.dtype), lengths,
                              scale=1.0 / math.sqrt(nope + rope_d), v_dim=lora)
    w_uv = p["w_uv"]["w"].to(x.dtype).view(lora, h, v_hd)
    out = torch.einsum("bhl,lhv->bhv", ctx, w_uv).reshape(b, 1, h * v_hd)
    return dense(p["wo"], out), cache


def mla_cache_shapes(cfg: ModelConfig, batch: int, seq: int):
    return (batch, seq, cfg.kv_lora_rank), (batch, seq, cfg.rope_head_dim)
