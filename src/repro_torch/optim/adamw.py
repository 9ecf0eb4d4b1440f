"""AdamW with global-norm clipping, on the port's parameter tree in f32.

``repro``'s ``optim/adamw.py`` as written: linear warmup and cosine decay
(``schedule``), the moments m and v in f32 (``init_opt_state``), the
global norm over every leaf in f32, the gradients scaled by ``min(1,
clip_norm / max(norm, 1e-9))``, bias-corrected moments and the decoupled
weight decay added to the update before the learning rate multiplies it
(``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``, computed in f32 and
rounded once to the parameter's dtype).  ``torch.optim.AdamW`` applies its
decay as a separate ``p * (1 - lr * wd)`` and rounds differently, so it is
not used.  Every function but :func:`adamw_update_` is pure: it returns new
trees and leaves its arguments as they are, as ``repro``'s do.
:func:`adamw_update_` is the same update written into the parameters' and
moments' own tensors, leaf by leaf (the donated state of ``repro``'s
``jax.jit(..., donate_argnums=0)`` step): equal bits, without a second copy
of the state and of the clipped gradients.  The step and the schedule's
values are f32 tensors on the parameters' device, so no step waits for the
host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay: an f32 tensor on ``step``'s device."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_opt_state(params) -> Dict[str, Any]:
    return {"m": tree_map(torch.zeros_like, params), "v": tree_map(torch.zeros_like, params)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def _clip_scale(grads, max_norm: float):
    """(the factor ``min(1, max_norm / max(norm, 1e-9))``, the global norm)."""
    norm = global_norm(grads)
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    scale, norm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _leaf_update(cfg: AdamWConfig, step: torch.Tensor):
    """(lr, the update of one leaf: (p, g, m, v) -> (p, m, v) new)."""
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(p, g, m, v):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    return lr, upd


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state, step: torch.Tensor):
    """One AdamW step; returns (new_params, new_opt_state, {"grad_norm", "lr"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    lr, upd = _leaf_update(cfg, step)
    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_p, new_m, new_v = (tree_map(lambda p, o, i=i: o[i], params, out) for i in range(3))
    return new_p, {"m": new_m, "v": new_v}, {"grad_norm": gnorm, "lr": lr}


# The in-place update takes a leaf UPDATE_SLICE elements at a time: its f32
# temporaries (about seven the size of what is updated) then stay small
# beside the state, where a whole leaf's would not (recurrentgemma-2b's
# embedding table is 2.6 GB in f32, and its state and gradients 46 GB).
UPDATE_SLICE = 1 << 24


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, params, grads, opt_state, step: torch.Tensor):
    """:func:`adamw_update` written into ``params`` and ``opt_state``'s own
    tensors, one slice of ``UPDATE_SLICE`` elements of a leaf at a time
    (each gradient clipped as it is used), with the same elementwise
    arithmetic and so the same bits; returns (params, opt_state,
    {"grad_norm", "lr"}), the same trees."""
    scale, gnorm = _clip_scale(grads, cfg.clip_norm)
    lr, upd = _leaf_update(cfg, step)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt_state["m"]),
                          leaves(opt_state["v"])):
        p, m, v, g = p.view(-1), m.view(-1), v.view(-1), g.reshape(-1)
        for i in range(0, p.numel(), UPDATE_SLICE):
            part = slice(i, i + UPDATE_SLICE)
            new = upd(p[part], (g[part].float() * scale).to(g.dtype), m[part], v[part])
            for old, x in zip((p[part], m[part], v[part]), new):
                old.copy_(x)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
