"""GQA/MQA attention over the flash (prefill) and paged (decode) kernels.

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

Only the dense decoder's attention is ported: windowed (ring) caches,
logit softcap, int8 KV quantization, cross-attention, prefix-LM masks and
MLA raise ``NotImplementedError`` naming the slice they wait for.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import remop_flash_attention
from repro_torch.kernels.paged_attention.ops import remop_paged_attention
from repro_torch.models.layers import (
    Params, apply_rope, dense, init_dense, init_rmsnorm, rmsnorm, rope_tables,
)

KVCache = Tuple[torch.Tensor, torch.Tensor]


def _unsupported(cfg: ModelConfig, window: int) -> None:
    if window or cfg.window:
        raise NotImplementedError("windowed (ring-cache) attention: later slice "
                                  "(recurrentgemma serving)")
    if cfg.attn_softcap:
        raise NotImplementedError("attention logit softcap: later slice")
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"{cfg.attn_type} attention: later slice (MLA, deepseek)")


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
                window: int = 0, mask_pos: Optional[torch.Tensor] = None,
                xa: Optional[torch.Tensor] = None, return_kv: bool = False):
    """Causal self-attention over the whole sequence (positions 0 .. S-1).

    x: [B, S, d] -> [B, S, d]; with ``return_kv`` also (k, v), each
    [B, S, KV, hd], the cache that :func:`gqa_decode` continues.
    """
    _unsupported(cfg, window)
    if xa is not None:
        raise NotImplementedError("cross-attention: later slice (enc-dec, seamless)")
    if mask_pos is not None:
        raise NotImplementedError("prefix-LM / bidirectional masks: later slice (vlm)")
    b, s, _ = x.shape
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    # [B, S, heads, hd] viewed as the kernel's [B, heads, S, hd]; the output
    # comes back in q's memory layout, so the reshape below is free.
    out = remop_flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    out = dense(p["wo"], out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim))
    return (out, (k, v)) if return_kv else out


def gqa_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: KVCache, pos: int,
               window: int = 0):
    """One-token decode. x: [B, 1, d]; cache (k, v): [B, S, KV, hd]; ``pos``
    is the step's position.  Returns (out [B, 1, d], cache) with the cache
    written in place."""
    _unsupported(cfg, window)
    if len(cache) != 2:
        raise NotImplementedError("int8 KV cache: later slice")
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_t, v_t = _gqa_qkv(p, cfg, x, positions)
    ck, cv = cache
    s_cache = ck.shape[1]
    slot = min(pos, s_cache - 1)
    ck[:, slot] = k_t[:, 0].to(ck.dtype)
    cv[:, slot] = v_t[:, 0].to(cv.dtype)
    lengths = torch.full((b,), min(pos + 1, s_cache), dtype=torch.int32, device=x.device)
    out = remop_paged_attention(q.view(b, kv, h // kv, hd), ck, cv, lengths)
    return dense(p["wo"], out.view(b, 1, h * hd)), (ck, cv)


def gqa_cache_shape(cfg: ModelConfig, batch: int, seq: int, window: int = 0):
    # Ring caches are always window-sized (slots = pos % window).
    s = window if window else seq
    return (batch, s, cfg.n_kv_heads, cfg.head_dim)
