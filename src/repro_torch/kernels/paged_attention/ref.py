"""Plain oracle for paged decode attention: one dense softmax in f32."""

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                        lengths: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """q: [B, KV, G, hd]; k/v_cache: [B, S, KV, hd]; lengths: [B] -> [B, KV, G, hd];
    with ``softcap > 0`` the scaled scores capped, ``tanh(s / softcap) *
    softcap``, before the mask."""
    s, hd = k_cache.shape[1], k_cache.shape[3]
    scores = torch.einsum("bkgh,bskh->bkgs", q.float(), k_cache.float()) / math.sqrt(hd)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None].long()  # [B, S]
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", p, v_cache.float()).to(q.dtype)
