"""Carry a parameter tree of the JAX package's ``init_params`` over to the port.

The JAX tree holds one entry per segment of ``repro``'s ``stack_plan``
(:func:`~repro_torch.models.transformer.stack_plan`): ``{"embed":
{"table"}, "final_norm": {"scale"}, "seg0": {"b0_attn": {...}}, ...}``, a
segment holding one block per kind of its scan group (``"b{i}_{kind}"``)
with every leaf stacked over the segment's repeats.  A dense decoder is
``seg0: {"b0_attn"}`` (``"b0_mla"`` with MLA), Mamba-2 ``seg0: {"b0_ssm"}``,
an MoE decoder ``seg0: {"b0_attn"}`` for its ``first_k_dense`` dense blocks
and then ``seg1: {"b0_moe"}`` (``"b0_mla"`` and ``"b0_mla_moe"`` for
deepseek-v2-lite), recurrentgemma's hybrid ``seg0: {"b0_rec", "b1_rec",
"b2_attn_local"}`` repeated 8 times, then ``seg1: {"b0_rec"}`` twice, and
the encoder-decoder's ``seg0: {"b0_cross"}`` (``repro``'s
``_decoder_segments``).  The VLM and the encoder-decoder add ``"frontend":
{"proj_in"}``, the encoder-decoder ``"encoder": {"b0_enc"}`` (stacked over
its layers) and ``"enc_norm"``.  The port's tree is the same with the
stacks split into lists in ``repro``'s layer order: ``"layers"``, where
repeat ``l`` of a segment gives its blocks' layer ``l`` in block order
(``b0_rec[l], b1_rec[l], b2_attn_local[l]``), then the next repeat, then
the next segment; and ``"encoder"``, one ``"enc"`` layer a repeat.  Leaves
arrive as numpy arrays (the caller converts them with ``np.asarray``), so
this module needs nothing of JAX.  Matrices (the SSM's and RG-LRU's
projections and conv weights, the MoE router and experts among them) become
bf16 by default: JAX casts each f32 master matrix to the bf16 activations
per call, which computes the same products; ``dtype=torch.float32`` keeps
them as the f32 masters that training updates.  Norm scales, the SSM's
``a_log``, ``dt_bias`` and ``d_skip`` and the RG-LRU's ``a_param`` stay
f32, as JAX uses them in f32 arithmetic.  :func:`state_from_jax` carries
``repro``'s training state across: the parameters, AdamW's m and v (f32,
the parameters' tree, MoE experts and MLA projections among them) and the
step.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.layers import WEIGHT_DTYPE
from repro_torch.models.transformer import Params, check_supported, decoder_segments


F32_LEAVES = ("scale", "a_log", "dt_bias", "d_skip", "a_param")


def _leaf(name: str, a: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    dtype = torch.float32 if name in F32_LEAVES else dtype
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)


def _tree(tree: Mapping[str, Any], device: torch.device, dtype: torch.dtype,
          layer: int | None = None):
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            out[name] = _tree(sub, device, dtype, layer)
        else:
            out[name] = _leaf(name, sub if layer is None else sub[layer], device, dtype)
    return out


def _segments(cfg: ModelConfig):
    """(segment, block names, repeats) of ``repro``'s ``_decoder_segments``
    for ``cfg``."""
    return [(f"seg{j}", tuple(f"b{i}_{kind}" for i, kind in enumerate(kinds)), repeats)
            for j, (kinds, repeats) in enumerate(decoder_segments(cfg))]


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, device=None,
                    dtype: torch.dtype = WEIGHT_DTYPE) -> Params:
    """The port's parameters from a numpy copy of ``tf.init_params(key, cfg)``
    (or any tree of that structure: AdamW's moments too), matrices in
    ``dtype``.

    ``device`` is ``cuda:0`` unless ``"cpu"`` is passed.
    """
    check_supported(cfg)
    device = resolve_device(device)
    segs = _segments(cfg)
    want = {seg: set(blocks) for seg, blocks, _ in segs}
    if cfg.n_encoder_layers:
        want["encoder"] = {"b0_enc"}
    got = {seg: set(sub) for seg, sub in tree.items() if seg in want}
    top = {"embed", "final_norm", *want}
    top |= {"frontend"} if cfg.frontend else set()
    top |= {"enc_norm"} if cfg.n_encoder_layers else set()
    if set(tree) != top or got != want:
        raise ValueError(f"not the tree of {cfg.name}: {sorted(tree)}, segments "
                         f"{ {k: sorted(v) for k, v in got.items()} }; expected "
                         f"{sorted(top)}, { {k: sorted(v) for k, v in want.items()} }")
    out = {
        "embed": _tree(tree["embed"], device, dtype),
        "final_norm": _tree(tree["final_norm"], device, dtype),
        "layers": [_tree(tree[seg][block], device, dtype, layer)
                   for seg, blocks, n in segs for layer in range(n) for block in blocks],
    }
    if cfg.frontend:
        out["frontend"] = _tree(tree["frontend"], device, dtype)
    if cfg.n_encoder_layers:
        out["encoder"] = [_tree(tree["encoder"]["b0_enc"], device, dtype, layer)
                          for layer in range(cfg.n_encoder_layers)]
        out["enc_norm"] = _tree(tree["enc_norm"], device, dtype)
    return out


def state_from_jax(state: Mapping[str, Any], cfg: ModelConfig, device=None,
                   param_dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """The port's training state from a numpy copy of ``repro``'s
    ``{"params", "opt": {"m", "v"}, "step"}``: the parameters' matrices in
    ``param_dtype`` (f32 masters by default), m and v in f32, the step an
    int32 scalar, all on ``device``."""
    device = resolve_device(device)
    return {
        "params": params_from_jax(state["params"], cfg, device, param_dtype),
        "opt": {k: params_from_jax(state["opt"][k], cfg, device, torch.float32)
                for k in ("m", "v")},
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=device),
    }
