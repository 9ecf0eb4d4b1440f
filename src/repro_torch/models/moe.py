"""Mixture-of-Experts layer (top-k routing, capacity-based dispatch).

As in the JAX package's ``models/moe.py``, the dense path: the router's
logits are a product in the activations' dtype, the routing is a top-k of
their softmax in f32, and tokens reach their experts through a static
capacity ``max(1, int(cf * S * k / E))`` per sequence, positions counted
token-major and choice-minor, so an assignment past its expert's capacity
is dropped.  The three expert products are batched products over the expert
axis (JAX computes them outside any Pallas kernel too).  ``moe_apply`` does
not call ``kernels.dispatch.ops.remop_dispatch``, as ``repro``'s does not.

Top-k breaks ties to the lower expert index, as ``jax.lax.top_k`` does
(``torch.topk`` does not promise it): routing is a stable descending sort.
bf16 logits tie often, so the rule decides real routings.

Under grad it differentiates as ``repro``'s: the top-k values carry the
gradient into the router through the bf16 combine weights, the Switch aux
loss only through the mean of ``probs`` (its expert fractions are counts),
and an assignment past its expert's capacity gets none.  The gradient
repeats bit for bit on the card: a token's k copies are summed by an
expand's reduction, and the combine's gather adds only zeros (a dropped
assignment's) where its rows meet.

The expert-parallel ``"ep_shard_map"`` strategy waits for the distributed
slice; :func:`set_moe_impl` accepts it and :func:`moe_apply` then raises.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import init_mlp, mlp, silu, truncated_normal

_MOE_IMPL = "gspmd"


def set_moe_impl(name: str) -> None:
    global _MOE_IMPL
    assert name in ("gspmd", "ep_shard_map")
    _MOE_IMPL = name


def init_moe(cfg: ModelConfig, generator: torch.Generator, device: torch.device) -> Dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff

    def w(shape, fan_in):
        return truncated_normal(shape, 1.0 / math.sqrt(fan_in), generator, device)

    p = {
        "router": {"w": w((d, e), d)},
        "experts": {"w_gate": w((e, d, ff), d), "w_up": w((e, d, ff), d),
                    "w_down": w((e, ff, d), ff)},
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(d, cfg.n_shared_experts * ff, generator, device, "swiglu")
    return p


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot`` as a bool compare: ``F.one_hot`` checks its ids' range,
    which syncs with the card on every call."""
    return ids[..., None] == torch.arange(n, device=ids.device)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, among equal values the lower index first."""
    values, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def _normalise(weights: torch.Tensor) -> torch.Tensor:
    return weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)


def topk_route(router_logits: torch.Tensor, k: int):
    """Returns (weights [T, k] bf16, expert_ids [T, k], aux_loss scalar)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    weights, ids = _top_k(probs, k)
    weights = _normalise(weights)
    # Switch-style load-balance aux loss: E * sum_e f_e * P_e.
    e = router_logits.shape[-1]
    f = _one_hot(ids, e).float().sum(dim=1).mean(dim=0)
    aux = e * torch.sum(f * probs.mean(dim=0))
    return weights.to(torch.bfloat16), ids, aux


def capacity(cfg: ModelConfig, s: int, capacity_factor: Optional[float] = None) -> int:
    """Expert buffer rows for a sequence of ``s`` tokens."""
    cf = capacity_factor or cfg.capacity_factor
    return max(1, int(cf * s * cfg.experts_per_token / cfg.n_experts))


def dispatch_dense(x: torch.Tensor, ids: torch.Tensor, n_experts: int, cap: int):
    """The dense path's dispatch: x [B, S, d], ids [B, S, k] ->
    (expert_in [B, E, C, d], keep [B, S*k], flat slot [B, S*k]).

    Positions are counted token-major, choice-minor; an assignment at or past
    ``cap`` is dropped.  JAX adds a dropped assignment's zero row onto slot
    C-1; here each kept row is copied to its slot and each dropped one to a
    spare row of its own past the buffers, so no row is written twice and a
    drop never lands on a kept row.  The buffers equal JAX's by value (a kept
    -0.0 stays -0.0, where JAX's add onto zeros gives +0.0).
    """
    b, s, d = x.shape
    k = ids.shape[-1]
    flat_ids = ids.reshape(b, s * k)
    # Expert-major [B, E, S*k]: the running count along the last axis is one
    # scan a row on the card, where along a middle axis of E columns it is E
    # sequential scans (3.3 ms at 16,384 assignments).
    experts = torch.arange(n_experts, device=x.device)[None, :, None]
    pos = torch.cumsum((flat_ids[:, None, :] == experts).long(), dim=-1) - 1
    pos_in_e = pos.gather(1, flat_ids[:, None, :])[:, 0]
    keep = pos_in_e < cap
    slot = flat_ids * cap + torch.where(keep, pos_in_e, cap - 1)
    used = n_experts * cap
    rows = used + s * k  # spare rows: one a dropped assignment could take
    spare = used + torch.arange(s * k, device=x.device)
    dest = torch.where(keep, slot, spare) + rows * torch.arange(b, device=x.device)[:, None]
    # Each token's row once a choice: an expand, whose gradient is a sum
    # over the k copies (repeat_interleave's is an index_add, whose atomics
    # on the card would sum them in a varying order).
    updates = x[:, :, None].expand(b, s, k, d).reshape(b * s * k, d)
    buf = torch.zeros((b * rows, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dest.reshape(-1), updates)
    expert_in = buf.view(b, rows, d)[:, :used].reshape(b, n_experts, cap, d)
    return expert_in, keep, slot


def moe_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux_loss).  Batch-grouped static-capacity dispatch."""
    if _MOE_IMPL == "ep_shard_map":
        raise NotImplementedError("expert-parallel MoE (ep_shard_map): later slice "
                                  "(distributed)")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = x @ p["router"]["w"].to(x.dtype)  # [B, S, E]
    probs = torch.softmax(logits.float(), dim=-1)
    weights, ids = _top_k(probs, k)  # [B, S, k]
    weights = _normalise(weights).to(x.dtype)
    # Switch-style load-balance aux loss over the batch.
    f_frac = _one_hot(ids, e).float().mean(dim=(0, 1, 2))
    aux = e * torch.sum(f_frac * probs.mean(dim=(0, 1)))

    cap = capacity(cfg, s, capacity_factor)
    expert_in, keep, slot = dispatch_dense(x, ids, e, cap)

    ex = p["experts"]
    h = silu(torch.einsum("becd,edf->becf", expert_in, ex["w_gate"].to(x.dtype)))
    h = h * torch.einsum("becd,edf->becf", expert_in, ex["w_up"].to(x.dtype))
    expert_out = torch.einsum("becf,efd->becd", h, ex["w_down"].to(x.dtype))

    # Gather back; assignments are token-major, choice-minor, so the combine
    # is a reshape.
    gathered = expert_out.reshape(b, e * cap, d).gather(
        1, slot[..., None].expand(b, s * k, d))
    gathered = torch.where(keep[..., None], gathered, 0)
    y = (gathered.reshape(b, s, k, d) * weights[..., None]).sum(dim=2)
    if "shared" in p:
        y = y + mlp(p["shared"], x, "swiglu")
    return y, aux.float()
