"""Plain oracle for MoE token dispatch/combine."""

import torch
import torch.nn.functional as F


def dispatch_ref(x: torch.Tensor, expert_ids: torch.Tensor, n_experts: int,
                 capacity: int):
    """x: [A, d] assignment-expanded rows; expert_ids: [A].

    Returns (expert_in [E, C, d], slot [A] (-1 if dropped)) with tokens placed
    in assignment order per expert (stable), dropped beyond capacity.
    """
    ids = expert_ids.long()
    pos = torch.cumsum(F.one_hot(ids, n_experts), dim=0) - 1
    pos_in_e = pos.gather(1, ids[:, None])[:, 0]
    keep = pos_in_e < capacity
    slot = torch.where(keep, ids * capacity + pos_in_e, -1).to(torch.int32)
    flat = torch.zeros((n_experts * capacity, x.shape[1]), dtype=x.dtype, device=x.device)
    flat.index_put_((torch.where(keep, slot, 0).long(),),
                    torch.where(keep[:, None], x, 0), accumulate=True)
    return flat.reshape(n_experts, capacity, x.shape[1]), slot


def combine_ref(expert_out: torch.Tensor, slot: torch.Tensor,
                weights: torch.Tensor, n_tokens: int, top_k: int):
    """expert_out: [E, C, d]; slot: [A]; weights: [A] -> y [T, d]."""
    e, c, d = expert_out.shape
    flat = expert_out.reshape(e * c, d)
    rows = torch.where(slot[:, None] >= 0, flat[slot.clamp_min(0).long()], 0)
    rows = rows * weights[:, None].to(rows.dtype)
    return rows.reshape(n_tokens, top_k, d).sum(dim=1)
