"""RG-LRU recurrent block (RecurrentGemma / Griffin): prefill and decode.

As in the JAX package's ``models/rglru.py``:
``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` with
``a_t = sigmoid(a_param)^(c * r_t)``, ``r_t`` and ``i_t`` input-dependent
gates, ``c = 8``; a width-``conv_width`` causal depthwise convolution before
the gates and a GeLU gate branch after the recurrence.  Like ``repro``, the
block runs outside any kernel: elementwise work and products in PyTorch.

The arithmetic follows JAX's rounding step by step, as ``models/ssm.py``
does: the bf16 sigmoid and GeLU are written out (``jax.nn.sigmoid`` and
``jax.nn.gelu`` round every step to bf16; ``torch.sigmoid`` and ``F.gelu``
round once; :func:`~repro_torch.models.layers.gelu_tanh`), the convolution
sums its ``conv_width`` bf16 products in JAX's order, the gates and the
state are f32.

The prefill's linear recurrence is ``jax.lax.associative_scan`` in
``repro``; :func:`associative_scan` transcribes JAX's own recursion (combine
even/odd pairs, scan the half, fix up the evens, interleave), so the same
combines run in the same order: about 2S of them, depth log2(S), a few
launches a level instead of one a position.  On the CPU it equals JAX's scan
(outside ``jit``) bit for bit on the state; under ``jit`` XLA contracts
``b2 + a2 * b1`` into a fused multiply-add, which moves the last bit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense, gelu_tanh, init_dense, truncated_normal

Params = Dict
RGLRUCache = Tuple[torch.Tensor, torch.Tensor]  # (conv [B, W-1, w] bf16, h [B, w] f32)

_C = 8.0  # temperature from the Griffin paper


def init_rglru(cfg: ModelConfig, generator: torch.Generator, device: torch.device) -> Params:
    d, w = cfg.d_model, cfg.lru_width
    # a_param so that a = sigmoid(a_param) lies in [0.9, 0.999] as in the paper.
    u = torch.empty(w, device=device).uniform_(0.9, 0.999, generator=generator) ** (1 / _C)
    return {
        "w_x": init_dense(d, w, generator, device),
        "w_gate": init_dense(d, w, generator, device),
        "conv": {"w": truncated_normal((cfg.conv_width, w), 0.1, generator, device)},
        "a_param": torch.log(u) - torch.log1p(-u),
        "a_gate": {"w": truncated_normal((w, w), 1.0 / math.sqrt(w), generator, device)},
        "x_gate": {"w": truncated_normal((w, w), 1.0 / math.sqrt(w), generator, device)},
        "w_out": init_dense(w, d, generator, device),
    }


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as JAX computes it in bf16: ``1 / (1 + exp(-x))``,
    every step rounded to the input's dtype."""
    return 1 / (1 + torch.exp(-x))


def _gates(p: Params, xb: torch.Tensor):
    """(a, sqrt(1 - a^2) * i * x), both f32."""
    r = sigmoid(xb @ p["a_gate"]["w"].to(xb.dtype))
    i = sigmoid(xb @ p["x_gate"]["w"].to(xb.dtype))
    log_a = -_C * torch.nn.functional.softplus(-p["a_param"].float()) * r.float()
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i.float() * xb.float())
    return a, gated


def _conv(p: Params, x: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Causal depthwise conv of x [B, S, w] (no activation); returns (y, the
    last ``conv_width - 1`` inputs as the next state)."""
    w = p["conv"]["w"]
    width = w.shape[0]
    pad = (torch.zeros((x.shape[0], width - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(width))  # bf16, as in JAX
    return y, xp[:, xp.shape[1] - (width - 1):].clone()  # not a view holding all of xp


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, b2 + a2 * b1


def _interleave(first: torch.Tensor, evens: torch.Tensor, odds: torch.Tensor) -> torch.Tensor:
    """Along dim 1: ``first[:, :1]``, then ``evens`` at 2, 4, ... and ``odds``
    at 1, 3, ..."""
    n = 1 + evens.shape[1] + odds.shape[1]
    out = first.new_empty((first.shape[0], n) + tuple(first.shape[2:]))
    out[:, :1] = first[:, :1]
    out[:, 2::2] = evens
    out[:, 1::2] = odds
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Prefix of ``h_t = a_t h_{t-1} + b_t`` along dim 1 (``h_{-1} = 0``), as
    ``jax.lax.associative_scan(combine, (a, b), axis=1)`` computes it: returns
    (the running products of a, h)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = associative_scan(*_combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                                        (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    return _interleave(a, ea, oa), _interleave(b, eb, ob)


def rglru_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  initial_h: Optional[torch.Tensor] = None, return_state: bool = False):
    """Full-sequence RG-LRU block. x: [B, S, d] -> [B, S, d]; with
    ``return_state`` also the cache ``(conv_state, h[:, -1])``."""
    xb = dense(p["w_x"], x)
    gate_branch = gelu_tanh(dense(p["w_gate"], x))
    xb, conv_state = _conv(p, xb)
    a, gated = _gates(p, xb)
    if initial_h is not None:  # h0 folded into step 0, as JAX does
        gated[:, 0] += a[:, 0] * initial_h.float()
    _, h = associative_scan(a, gated)
    out = dense(p["w_out"], h.to(x.dtype) * gate_branch)
    return (out, (conv_state, h[:, -1])) if return_state else out


def rglru_decode(p: Params, cfg: ModelConfig, x_t: torch.Tensor, cache: RGLRUCache):
    """One-token step. x_t: [B, 1, d]; cache = (conv_state [B, W-1, w], h [B, w])."""
    conv_state, h = cache
    xb = dense(p["w_x"], x_t)
    gate_branch = gelu_tanh(dense(p["w_gate"], x_t))
    xb, conv_state = _conv(p, xb, conv_state)
    a, gated = _gates(p, xb)
    h_new = a[:, 0] * h.float() + gated[:, 0]
    y = h_new[:, None, :].to(x_t.dtype) * gate_branch
    return dense(p["w_out"], y), (conv_state, h_new)


def rglru_cache_shapes(cfg: ModelConfig, batch: int):
    return (batch, cfg.conv_width - 1, cfg.lru_width), (batch, cfg.lru_width)
