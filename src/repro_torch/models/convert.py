"""Carry a parameter tree of the JAX package's ``init_params`` over to the port.

The JAX tree of a dense decoder is ``{"embed": {"table"}, "final_norm":
{"scale"}, "seg0": {"b0_attn": {...}}}`` (``"b0_ssm"`` for Mamba-2,
``"b0_moe"`` for an MoE decoder, whose ``first_k_dense`` dense blocks come
first as ``seg0: {"b0_attn"}`` and its MoE blocks then as ``seg1:
{"b0_moe"}``; with MLA attention the blocks are ``"b0_mla"`` and
``"b0_mla_moe"``, as deepseek-v2-lite's) with every leaf of a segment
stacked over its layers; the
port's is the same tree with the stacks split into one ``"layers"`` list.
Leaves arrive as numpy arrays (the caller converts them with
``np.asarray``), so this module needs nothing of JAX.  Matrices (the SSM's
``w_in``, ``w_out`` and conv weights, the MoE router and experts among them)
become bf16: JAX casts each f32 master matrix to the bf16 activations per
call, which computes the same products.  Norm scales and the SSM's
``a_log``, ``dt_bias`` and ``d_skip`` stay f32, as JAX uses them in f32
arithmetic.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.layers import WEIGHT_DTYPE
from repro_torch.models.transformer import Params, check_supported


F32_LEAVES = ("scale", "a_log", "dt_bias", "d_skip")


def _leaf(name: str, a: np.ndarray, device: torch.device) -> torch.Tensor:
    dtype = torch.float32 if name in F32_LEAVES else WEIGHT_DTYPE
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)


def _tree(tree: Mapping[str, Any], device: torch.device, layer: int | None = None):
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            out[name] = _tree(sub, device, layer)
        else:
            out[name] = _leaf(name, sub if layer is None else sub[layer], device)
    return out


def _segments(cfg: ModelConfig):
    """(segment, block, layers) of ``repro``'s ``stack_plan`` for ``cfg``."""
    if cfg.family == "ssm":
        return [("seg0", "b0_ssm", cfg.n_layers)]
    dense = "b0_mla" if cfg.attn_type == "mla" else "b0_attn"
    if cfg.family != "moe":
        return [("seg0", dense, cfg.n_layers)]
    segs = [("seg0", dense, cfg.first_k_dense)] if cfg.first_k_dense else []
    moe = "b0_mla_moe" if cfg.attn_type == "mla" else "b0_moe"
    segs.append((f"seg{len(segs)}", moe, cfg.n_layers - cfg.first_k_dense))
    return segs


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, device=None) -> Params:
    """The port's parameters from a numpy copy of ``tf.init_params(key, cfg)``.

    ``device`` is ``cuda:0`` unless ``"cpu"`` is passed.
    """
    check_supported(cfg)
    device = resolve_device(device)
    segs = _segments(cfg)
    want = {seg: {block} for seg, block, _ in segs}
    got = {seg: set(sub) for seg, sub in tree.items() if seg.startswith("seg")}
    if set(tree) != {"embed", "final_norm", *want} or got != want:
        raise ValueError(f"not the tree of {cfg.name}: {sorted(tree)}, segments "
                         f"{ {k: sorted(v) for k, v in got.items()} }; expected "
                         f"{ {k: sorted(v) for k, v in want.items()} }")
    layers = [_tree(tree[seg][block], device, layer)
              for seg, block, n in segs for layer in range(n)]
    return {
        "embed": _tree(tree["embed"], device),
        "final_norm": _tree(tree["final_norm"], device),
        "layers": layers,
    }
