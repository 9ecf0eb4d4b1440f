"""The decoder LM: a stack of ``"attn"`` blocks (dense decoder), of
``"moe"`` blocks after ``first_k_dense`` ``"attn"`` blocks (MoE decoder), or
of ``"ssm"`` blocks (Mamba-2); with MLA attention (``attn_type == "mla"``)
the kinds are ``repro``'s ``"mla"`` and ``"mla_moe"`` (deepseek-v2-lite: one
dense ``"mla"`` block, then ``"mla_moe"`` blocks): init, forward, prefill,
decode.

The JAX package's ``models/transformer.py`` assembles every family and
scans over layer-stacked parameters; here the layers are a Python list and
the loop is a Python loop (PyTorch runs eagerly).  The parameter tree is
JAX's with the layer stack split: ``{"embed": {"table"}, "final_norm":
{"scale"}, "layers": [...]}``, each layer ``{"norm1", "attn", "norm2",
"mlp"}``, ``{"norm1", "attn", "norm2", "moe"}`` or ``{"norm1", "ssm"}`` (no
FFN half); an MLA layer's ``"attn"`` holds ``init_mla``'s weights.  Caches
are a list with one pair per layer: ``(k, v)``, each ``[B, S, KV, hd]``,
MLA's ``(c_kv [B, S, lora], k_rope [B, S, rope])`` as views of one ``[B, S,
lora + rope]`` buffer, or the SSM's ``(conv [B, W-1, C] bf16, state [B, H,
P, N] f32)``, which has no sequence axis.

Other families (hybrid, VLM, enc-dec) raise ``NotImplementedError``: they
wait for later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    embed, init_embedding, init_mlp, init_rmsnorm, mlp, rmsnorm, unembed,
)

Params = Dict[str, Any]
Caches = List[Tuple[torch.Tensor, torch.Tensor]]


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense or MoE decoder of full GQA or MLA
    attention blocks or a Mamba-2 stack."""
    if cfg.family == "ssm":
        return
    if (cfg.family not in ("dense", "moe") or cfg.attn_type not in ("gqa", "mla")
            or cfg.n_encoder_layers):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} ({cfg.attn_type}) waits for a later "
            "slice; the port serves the dense and MoE decoders (GQA or MLA) and Mamba-2")
    if cfg.window or cfg.attn_softcap:
        raise NotImplementedError(f"{cfg.name}: windowed/softcapped attention: later slice")


# ===========================================================================
# Init
# ===========================================================================


def is_moe_layer(cfg: ModelConfig, layer: int) -> bool:
    """Layer ``layer`` is an MoE block: the MoE family past its
    ``first_k_dense`` dense blocks (``repro``'s ``stack_plan``)."""
    return cfg.family == "moe" and layer >= cfg.first_k_dense


def is_mla(cfg: ModelConfig) -> bool:
    """Every attention block is MLA (``repro``'s kinds ``"mla"``, ``"mla_moe"``)."""
    return cfg.attn_type == "mla"


def init_block(cfg: ModelConfig, generator: torch.Generator, device: torch.device,
               layer: int = 0) -> Params:
    if cfg.family == "ssm":
        return {"norm1": init_rmsnorm(cfg.d_model, device),
                "ssm": ssm_mod.init_ssm(cfg, generator, device)}
    init_attn = attn.init_mla if is_mla(cfg) else attn.init_gqa
    p = {
        "norm1": init_rmsnorm(cfg.d_model, device),
        "attn": init_attn(cfg, generator, device),
        "norm2": init_rmsnorm(cfg.d_model, device),
    }
    if is_moe_layer(cfg, layer):
        p["moe"] = moe_mod.init_moe(cfg, generator, device)
    else:
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, generator, device, cfg.mlp_type)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Random weights: matrices in bf16, norm scales in f32, on ``device``
    (``cuda:0`` unless ``"cpu"`` is passed).  ``generator`` must live on
    that device; the default is one seeded with 0."""
    check_supported(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return {
        "embed": init_embedding(cfg.vocab_size, cfg.d_model, generator, device),
        "final_norm": init_rmsnorm(cfg.d_model, device),
        "layers": [init_block(cfg, generator, device, i) for i in range(cfg.n_layers)],
    }


# ===========================================================================
# Blocks
# ===========================================================================


def _ffn(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """The FFN half: (x + FFN(norm2(x)), the MoE's aux loss or None)."""
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        y, aux = moe_mod.moe_apply(p["moe"], cfg, h)
        return x + y, aux
    return x + mlp(p["mlp"], h, cfg.mlp_type), None


def block_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                  want_cache: bool = False):
    """Returns (x_out, cache or None, aux_loss or None): the cache is ``(k,
    v)``, or ``(conv, state)`` for SSM; only an MoE block has an aux loss."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if "ssm" in p:
        out = ssm_mod.ssd_forward(p["ssm"], cfg, h, return_state=want_cache)
        cache = None
        if want_cache:
            out, cache = out
        return x + out, cache, None
    if is_mla(cfg):
        out = attn.mla_forward(p["attn"], cfg, h, positions, return_cache=want_cache)
    else:
        out = attn.gqa_forward(p["attn"], cfg, h, positions, return_kv=want_cache)
    cache = None
    if want_cache:
        out, cache = out
    x, aux = _ffn(p, cfg, x + out)
    return x, cache, aux


def block_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache, pos: int):
    """One token; an SSM block ignores ``pos`` (its state holds the past)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if "ssm" in p:
        out, cache = ssm_mod.ssd_decode(p["ssm"], cfg, h, cache)
        return x + out, cache
    decode = attn.mla_decode if is_mla(cfg) else attn.gqa_decode
    out, cache = decode(p["attn"], cfg, h, cache, pos)
    x, _ = _ffn(p, cfg, x + out)
    return x, cache


# ===========================================================================
# Whole model
# ===========================================================================


def _hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor, want_cache: bool):
    check_supported(cfg)
    x = embed(params["embed"], tokens, scale_by_sqrt_dim=True)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    caches = []
    aux_total = torch.zeros((), device=x.device)
    for layer in params["layers"]:
        x, cache, aux = block_forward(layer, cfg, x, positions, want_cache)
        caches.append(cache)
        if aux is not None:
            aux_total = aux_total + aux
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, (caches if want_cache else None), aux_total


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            want_cache: bool = False):
    """Full-sequence forward; returns (logits, aux_loss, caches)."""
    x, caches, aux = _hidden(params, cfg, batch["tokens"], want_cache)
    logits = unembed(params["embed"], x, cfg.logit_softcap)
    return logits, aux, caches


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            return_hidden: bool = False):
    """Returns (last_token_logits, caches[, last_hidden]) for decode.

    Only the last position is unembedded: its logits are those of
    :func:`forward`, without the ``[B, S, vocab]`` tensor.
    """
    x, caches, _ = _hidden(params, cfg, batch["tokens"], want_cache=True)
    last = x[:, -1]
    logits = unembed(params["embed"], last, cfg.logit_softcap)
    return (logits, caches, last) if return_hidden else (logits, caches)


def decode_step(params: Params, cfg: ModelConfig, caches: Caches, token: torch.Tensor,
                pos: int, return_hidden: bool = False):
    """One decode step. token: [B] integer; pos: the step's position.

    Returns (logits [B, vocab], caches[, hidden [B, d]]); the caches are
    written in place.
    """
    check_supported(cfg)
    x = embed(params["embed"], token[:, None], scale_by_sqrt_dim=True)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        x, cache = block_decode(layer, cfg, x, cache, pos)
        new_caches.append(cache)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)[:, 0]
    logits = unembed(params["embed"], x, cfg.logit_softcap)
    return (logits, new_caches, x) if return_hidden else (logits, new_caches)


# ===========================================================================
# Cache specs
# ===========================================================================


def cache_struct(cfg: ModelConfig, batch: int, seq: int,
                 dtype=torch.bfloat16) -> List[Tuple[Tuple[torch.Size, torch.dtype], ...]]:
    """(shape, dtype) of each layer's (k, v), (c_kv, k_rope) for MLA or
    (conv, state) for SSM, mirroring ``prefill``'s caches."""
    check_supported(cfg)
    if cfg.family == "ssm":
        conv, state = ssm_mod.ssm_cache_shapes(cfg, batch)
        return [((torch.Size(conv), dtype), (torch.Size(state), torch.float32))
                for _ in range(cfg.n_layers)]
    if is_mla(cfg):
        c_sh, r_sh = attn.mla_cache_shapes(cfg, batch, seq)
        return [((torch.Size(c_sh), dtype), (torch.Size(r_sh), dtype))
                for _ in range(cfg.n_layers)]
    spec = (torch.Size(attn.gqa_cache_shape(cfg, batch, seq)), dtype)
    return [(spec, spec) for _ in range(cfg.n_layers)]


def pad_caches(cfg: ModelConfig, caches: Caches, target_len: int) -> Caches:
    """Grow each KV cache's seq axis to ``target_len`` with zeros (decode
    headroom); an MLA cache grows its shared buffer, so its two views still
    alias one buffer.  SSM caches are fixed-size and pass through untouched."""
    if cfg.family == "ssm":
        return caches
    if is_mla(cfg):
        return [attn.mla_pad(cache, target_len) for cache in caches]

    def pad(a):
        return a if a.shape[1] >= target_len else F.pad(
            a, (0, 0, 0, 0, 0, target_len - a.shape[1]))

    return [(pad(k), pad(v)) for k, v in caches]


def param_count(params: Params) -> int:
    def count(tree) -> int:
        if isinstance(tree, torch.Tensor):
            return tree.numel()
        items = tree.values() if isinstance(tree, dict) else tree
        return sum(count(x) for x in items)

    return count(params)
