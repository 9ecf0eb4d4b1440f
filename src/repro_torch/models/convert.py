"""Carry a parameter tree of the JAX package's ``init_params`` over to the port.

The JAX tree of a dense decoder is ``{"embed": {"table"}, "final_norm":
{"scale"}, "seg0": {"b0_attn": {...}}}`` (``"b0_ssm"`` for Mamba-2) with
every leaf of ``seg0`` stacked over layers; the port's is the same tree
with the stack split into ``"layers"``.  Leaves arrive as numpy arrays (the
caller converts them with ``np.asarray``), so this module needs nothing of
JAX.  Matrices (the SSM's ``w_in``, ``w_out`` and conv weights among them)
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


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, device=None) -> Params:
    """The port's parameters from a numpy copy of ``tf.init_params(key, cfg)``.

    ``device`` is ``cuda:0`` unless ``"cpu"`` is passed.
    """
    check_supported(cfg)
    device = resolve_device(device)
    block = "b0_ssm" if cfg.family == "ssm" else "b0_attn"
    if set(tree) != {"embed", "final_norm", "seg0"} or set(tree["seg0"]) != {block}:
        raise ValueError(f"not the tree of {cfg.name}: {sorted(tree)}, seg0 "
                         f"{sorted(tree.get('seg0', {}))}; expected seg0 {{{block!r}}}")
    stack = tree["seg0"][block]
    return {
        "embed": _tree(tree["embed"], device),
        "final_norm": _tree(tree["final_norm"], device),
        "layers": [_tree(stack, device, layer) for layer in range(cfg.n_layers)],
    }
