"""Builders for the train, prefill and decode steps.

``repro``'s ``launch/steps.py`` without its shardings (``state_shardings``
and the ``Sharder`` wait for the distributed slice): the same step runs on
one card or, with ``device="cpu"``, on the CPU.  The train step is
``repro``'s run without a ``Sharder``: the loss and its gradient in the
parameters (full remat, :func:`~repro_torch.models.transformer.loss_fn`),
over ``microbatches`` equal slices of the batch (each with its own MoE aux
loss, as ``repro``'s scan of ``value_and_grad`` over them) with the
gradients summed in f32 and divided by ``microbatches``, then AdamW;
metrics ``loss``, ``aux``, ``loss_total``, ``grad_norm`` and ``lr`` as 0-d
tensors.  ``donate=True`` updates the state's parameters and moments in
place (:func:`~repro_torch.optim.adamw.adamw_update_`), as ``repro``'s
``launch/train.py`` donates the state to its jitted step
(``donate_argnums=0``): the same bits, one copy of the state on the card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWConfig, adamw_update, adamw_update_, init_opt_state
from repro_torch.tree import leaves, tree_map, tree_unflatten


def _value_and_grad(params, cfg: ModelConfig, batch):
    """(loss_total, {"loss", "aux"}, grads): grads in the parameters' tree
    and dtypes."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = tf.loss_fn(live, cfg, batch, remat=True)
        flat = torch.autograd.grad(loss, leaves(live), allow_unused=True)
    # A parameter the loss does not reach (an MoE expert no token picked)
    # has a zero gradient, as JAX gives it.
    flat = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves(params), flat)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_unflatten(params,
                                                                                      flat)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, microbatches: int = 1,
                    donate: bool = False):
    """Returns train_step(state, batch) -> (state, metrics); with ``donate``
    the returned state holds ``state``'s parameter and moment tensors,
    updated in place."""

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, metrics, grads = _value_and_grad(params, cfg, batch)
        else:
            mbs = {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])
                   for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss, parts = 0.0, []
            for i in range(microbatches):
                l, m, g = _value_and_grad(params, cfg, {k: v[i] for k, v in mbs.items()})
                tree_map(lambda total, part: total.add_(part), grads, g)
                del g
                loss = loss + l
                parts.append(m)
            tree_map(lambda g: g.div_(microbatches), grads)
            loss = loss / microbatches
            metrics = {k: torch.stack([m[k] for m in parts]).mean() for k in parts[0]}
        update = adamw_update_ if donate else adamw_update
        new_params, new_opt, opt_metrics = update(
            opt_cfg, params, grads, state["opt"], state["step"])
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss_total"] = loss
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics

    train_step.donates = donate
    return train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        return tf.prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig, greedy: bool = True):
    @torch.no_grad()
    def decode_step(params, caches, token, pos: int):
        logits, caches = tf.decode_step(params, cfg, caches, token, pos)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, caches

    return decode_step


def init_state(cfg: ModelConfig, generator: Optional[torch.Generator] = None, device=None,
               param_dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random f32 master parameters (``tf.init_params`` with ``dtype=f32``),
    AdamW's zero moments in f32 and step 0, on ``device``.  ``param_dtype``
    (bf16, say) casts the f32 parameters; m and v stay f32, ``repro``'s
    "master-light" mode."""
    device = resolve_device(device)
    params = tf.init_params(cfg, generator, device, dtype=torch.float32)
    if param_dtype is not None:
        params = tree_map(lambda p: p.to(param_dtype) if p.dtype == torch.float32 else p, params)
    opt = init_opt_state(tree_map(lambda p: p.float(), params))
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=device)}
