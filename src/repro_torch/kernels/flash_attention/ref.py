"""Plain oracle for flash attention (prefill): one dense softmax in f32."""

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        prefix: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q: [B, H, S, hd]; k/v: [B, KV, T, hd]; causal (q pos offset = T - S),
    every key below ``prefix`` seen by every query; with ``softcap > 0`` the
    scaled scores capped, ``tanh(s / softcap) * softcap``, before the mask."""
    b, h, s, hd = q.shape
    kv, t = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kv, h // kv, s, hd)
    scores = torch.einsum("bkgsh,bkth->bkgst", qg, k.float()) / math.sqrt(hd)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    q_pos = torch.arange(s, device=q.device) + (t - s)
    k_pos = torch.arange(t, device=q.device)
    mask = (q_pos[:, None] >= k_pos[None, :]) | (k_pos[None, :] < prefix)
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bkth->bkgsh", p, v.float())
    return out.reshape(b, h, s, hd).to(q.dtype)
