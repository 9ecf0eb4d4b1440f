"""The decoder LM: init, forward, prefill, decode for every family the port
serves, each layer a block of one of ``repro``'s kinds:

- dense decoder: ``"attn"`` blocks (GQA), or ``"mla"`` with MLA attention
  (``attn_type == "mla"``);
- MoE decoder: ``first_k_dense`` dense blocks, then ``"moe"`` blocks
  (``"mla_moe"`` with MLA: deepseek-v2-lite);
- Mamba-2: ``"ssm"`` blocks;
- hybrid (recurrentgemma): ``block_pattern`` repeated, by default ``("rec",
  "rec", "attn_local")``; ``"rec"`` is an RG-LRU block (``models/rglru.py``),
  ``"attn_local"`` a GQA block whose attention sees the last ``cfg.window``
  keys and whose decode cache is a ring of ``cfg.window`` slots;
- VLM (paligemma): ``"attn"`` blocks over ``[patches; text]``, the patches
  (``batch["patches"]`` ``[B, P, frontend_dim]``) projected in by
  ``frontend.proj_in``, every position seeing the ``P`` patches (the flash
  kernel's ``prefix = P``: ``repro``'s prefix-LM mask);
- encoder-decoder (seamless-m4t): ``batch["frames"]`` ``[B, T_enc,
  frontend_dim]`` through ``frontend.proj_in`` and ``n_encoder_layers``
  bidirectional ``"enc"`` blocks (``prefix = T_enc``) then ``enc_norm``;
  the decoder's ``"cross"`` blocks add cross-attention over that output
  after their causal self-attention.

The JAX package's ``models/transformer.py`` assembles the families and
scans over layer-stacked parameters, one scan per segment of its
``stack_plan`` (:func:`stack_plan` here); here the layers are a Python list
in ``repro``'s layer order (:func:`layer_kinds`) and the loop is a Python
loop (PyTorch runs eagerly).  The parameter tree is JAX's with the stacks
split: ``{"embed": {"table"}, "final_norm": {"scale"}, "layers": [...]}``,
each layer ``{"norm1", "attn", "norm2", "mlp"}`` (also ``"enc"``),
``{"norm1", "attn", "norm2", "moe"}``, ``{"norm1", "ssm"}`` (no FFN half),
``{"norm1", "rec", "norm2", "mlp"}`` or, for ``"cross"``, ``{"norm1",
"attn", "norm_x", "xattn", "norm2", "mlp"}``; an MLA layer's ``"attn"``
holds ``init_mla``'s weights.  The VLM and the encoder-decoder add
``"frontend": {"proj_in"}``, the encoder-decoder ``"encoder"`` (a list of
``"enc"`` layers) and ``"enc_norm"``.  Caches are a list with one entry per
decoder layer: ``(k, v)``, each ``[B, S, KV, hd]`` (a ring ``[B, window,
KV, hd]`` for ``"attn_local"``), MLA's ``(c_kv [B, S, lora], k_rope [B, S,
rope])`` as views of one ``[B, S, lora + rope]`` buffer, the SSM's ``(conv
[B, W-1, C] bf16, state [B, H, P, N] f32)``, the RG-LRU's ``(conv [B, W-1,
lru] bf16, h [B, lru] f32)`` or a cross block's ``{"self": (k, v),
"cross": (ck, cv)}`` (``ck``, ``cv`` ``[B, T_enc, KV, hd]``); only the
plain ``(k, v)`` caches (a cross block's ``"self"`` among them) and MLA
caches have a sequence axis that :func:`pad_caches` grows.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rec_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    WEIGHT_DTYPE, dense, embed, init_dense, init_embedding, init_mlp, init_rmsnorm, matrix_dtype,
    mlp, rmsnorm, softmax_xent, unembed,
)

Params = Dict[str, Any]
Caches = List[Any]  # per decoder layer: a pair of tensors, or a cross block's dict of pairs
# A segment of repro's stack_plan: (the block kinds of one scan group, repeats).
Segment = Tuple[Tuple[str, ...], int]
HYBRID_PATTERN = ("rec", "rec", "attn_local")


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense or MoE decoder of GQA or MLA attention
    blocks, a Mamba-2 stack, a hybrid of RG-LRU and attention blocks, a VLM
    or an encoder-decoder of GQA blocks (encoder layers in the
    encoder-decoder only)."""
    if (cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio_encdec")
            or bool(cfg.n_encoder_layers) != (cfg.family == "audio_encdec")
            or (cfg.family in ("dense", "moe") and cfg.attn_type not in ("gqa", "mla"))
            or (cfg.family in ("vlm", "audio_encdec") and cfg.attn_type != "gqa")):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} ({cfg.attn_type}, {cfg.n_encoder_layers} "
            "encoder layers) waits for a later slice; the port serves the dense and MoE "
            "decoders (GQA or MLA), Mamba-2, the RG-LRU hybrid, the VLM and the "
            "encoder-decoder (GQA)")
    if cfg.family == "hybrid" and not set(cfg.block_pattern or HYBRID_PATTERN) <= {
            "rec", "attn", "attn_local"}:
        raise NotImplementedError(f"{cfg.name}: hybrid pattern {cfg.block_pattern}")


def is_moe_layer(cfg: ModelConfig, layer: int) -> bool:
    """Layer ``layer`` is an MoE block: the MoE family past its
    ``first_k_dense`` dense blocks (``repro``'s ``stack_plan``)."""
    return cfg.family == "moe" and layer >= cfg.first_k_dense


def is_mla(cfg: ModelConfig) -> bool:
    """Every attention block is MLA (``repro``'s kinds ``"mla"``, ``"mla_moe"``)."""
    return cfg.attn_type == "mla"


def stack_plan(cfg: ModelConfig) -> Tuple[Segment, ...]:
    """``repro``'s ``stack_plan``: the layers as segments of ``(kinds,
    repeats)``, each repeat one layer per kind, in order."""
    if cfg.family == "moe":
        dense_kind, kind = ("mla", "mla_moe") if is_mla(cfg) else ("attn", "moe")
        segs = [((dense_kind,), cfg.first_k_dense)] if cfg.first_k_dense else []
        return tuple(segs + [((kind,), cfg.n_layers - cfg.first_k_dense)])
    if cfg.family == "ssm":
        return ((("ssm",), cfg.n_layers),)
    if cfg.family == "hybrid":
        pat = tuple(cfg.block_pattern or HYBRID_PATTERN)
        n_groups, rem = divmod(cfg.n_layers, len(pat))
        segs = [(pat, n_groups)] if n_groups else []
        head = pat[:rem]
        if len(set(head)) == 1:
            segs.append(((head[0],), rem))
        else:
            segs.extend(((kind,), 1) for kind in head)
        return tuple(segs)
    return ((("mla",) if is_mla(cfg) else ("attn",), cfg.n_layers),)


def decoder_segments(cfg: ModelConfig) -> Tuple[Segment, ...]:
    """``repro``'s ``_decoder_segments``: ``n_layers`` ``"cross"`` blocks
    for an encoder-decoder, else :func:`stack_plan`."""
    if cfg.n_encoder_layers:
        return ((("cross",), cfg.n_layers),)
    return stack_plan(cfg)


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of every decoder layer, in ``repro``'s layer order."""
    return [kind for kinds, repeats in decoder_segments(cfg) for _ in range(repeats)
            for kind in kinds]


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind == "attn_local" else 0


# ===========================================================================
# Rematerialization (repro's _checkpoint over each layer of the scan)
# ===========================================================================

# None: full remat (each decoder layer keeps only its input and recomputes
# its forward in the backward pass); "dots": also keep the outputs of the
# 2-D matrix products (aten.mm: the projections, the FFN, the unembedding),
# what JAX's dots_with_no_batch_dims_saveable keeps.
_REMAT_POLICY = None
REMAT_POLICIES = (None, "dots")


def set_remat_policy(name) -> None:
    if name not in REMAT_POLICIES:
        raise ValueError(f"remat policy {name!r} not in {REMAT_POLICIES}")
    global _REMAT_POLICY
    _REMAT_POLICY = name


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant) with
    the policy of :func:`set_remat_policy`."""
    context = (functools.partial(create_selective_checkpoint_contexts, _save_products)
               if _REMAT_POLICY == "dots" else noop_context_fn)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context)


# ===========================================================================
# Init
# ===========================================================================


def init_block(cfg: ModelConfig, generator: torch.Generator, device: torch.device,
               kind: str) -> Params:
    p = {"norm1": init_rmsnorm(cfg.d_model, device)}
    if kind == "ssm":
        p["ssm"] = ssm_mod.init_ssm(cfg, generator, device)
        return p
    if kind == "rec":
        p["rec"] = rec_mod.init_rglru(cfg, generator, device)
    else:
        init_attn = attn.init_mla if kind in ("mla", "mla_moe") else attn.init_gqa
        p["attn"] = init_attn(cfg, generator, device)
    if kind == "cross":
        p["norm_x"] = init_rmsnorm(cfg.d_model, device)
        p["xattn"] = attn.init_gqa(cfg, generator, device)
    p["norm2"] = init_rmsnorm(cfg.d_model, device)
    if kind in ("moe", "mla_moe"):
        p["moe"] = moe_mod.init_moe(cfg, generator, device)
    else:
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, generator, device, cfg.mlp_type)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, dtype: torch.dtype = WEIGHT_DTYPE) -> Params:
    """Random weights: matrices in ``dtype`` (bf16 by default; f32 masters
    for training), norm scales (and the RG-LRU's ``a_param``) in f32, on
    ``device`` (``cuda:0`` unless ``"cpu"`` is passed).  ``generator`` must
    live on that device; the default is one seeded with 0."""
    check_supported(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    with matrix_dtype(dtype):
        return _init_params(cfg, generator, device)


def _init_params(cfg: ModelConfig, generator: torch.Generator, device: torch.device) -> Params:
    p = {
        "embed": init_embedding(cfg.vocab_size, cfg.d_model, generator, device),
        "final_norm": init_rmsnorm(cfg.d_model, device),
        "layers": [init_block(cfg, generator, device, kind) for kind in layer_kinds(cfg)],
    }
    if cfg.frontend:
        p["frontend"] = {"proj_in": init_dense(cfg.frontend_dim, cfg.d_model, generator, device)}
    if cfg.n_encoder_layers:
        p["encoder"] = [init_block(cfg, generator, device, "enc")
                        for _ in range(cfg.n_encoder_layers)]
        p["enc_norm"] = init_rmsnorm(cfg.d_model, device)
    return p


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


def block_forward(p: Params, cfg: ModelConfig, kind: str, x: torch.Tensor,
                  positions: torch.Tensor, want_cache: bool = False, prefix: int = 0,
                  enc_out: Optional[torch.Tensor] = None):
    """Returns (x_out, cache or None, aux_loss or None): the cache is ``(k,
    v)`` (packed into a ring for ``"attn_local"``), MLA's pair, ``(conv,
    state)`` / ``(conv, h)`` for SSM / RG-LRU, or ``{"self": (k, v),
    "cross": (ck, cv)}`` for ``"cross"``; only an MoE block has an aux loss.
    ``prefix`` is the keys every query of an ``"attn"`` block sees (the
    VLM's patches); an ``"enc"`` block sees every key; a ``"cross"`` block
    attends to ``enc_out`` after its causal self-attention."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind == "ssm":
        out = ssm_mod.ssd_forward(p["ssm"], cfg, h, return_state=want_cache)
        cache = None
        if want_cache:
            out, cache = out
        return x + out, cache, None
    window = _window(cfg, kind)
    if kind == "rec":
        out = rec_mod.rglru_forward(p["rec"], cfg, h, return_state=want_cache)
    elif kind in ("mla", "mla_moe"):
        out = attn.mla_forward(p["attn"], cfg, h, positions, return_cache=want_cache)
    elif kind == "cross":
        out, kv_self = attn.gqa_forward(p["attn"], cfg, h, positions, return_kv=True)
        x = x + out
        hx = rmsnorm(p["norm_x"], x, cfg.norm_eps)
        out, kv_cross = attn.gqa_forward(p["xattn"], cfg, hx, positions, xa=enc_out,
                                         return_kv=True)
        if want_cache:
            out = out, {"self": kv_self, "cross": kv_cross}
    else:
        out = attn.gqa_forward(p["attn"], cfg, h, positions, window=window,
                               prefix=x.shape[1] if kind == "enc" else prefix,
                               return_kv=want_cache)
    cache = None
    if want_cache:
        out, cache = out
        if window:
            cache = attn.ring_pack(cache, positions, window)
    x, aux = _ffn(p, cfg, x + out)
    return x, cache, aux


def block_decode(p: Params, cfg: ModelConfig, kind: str, x: torch.Tensor, cache, pos: int):
    """One token; SSM and RG-LRU blocks ignore ``pos`` (their state holds
    the past)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind == "ssm":
        out, cache = ssm_mod.ssd_decode(p["ssm"], cfg, h, cache)
        return x + out, cache
    if kind == "rec":
        out, cache = rec_mod.rglru_decode(p["rec"], cfg, h, cache)
    elif kind in ("mla", "mla_moe"):
        out, cache = attn.mla_decode(p["attn"], cfg, h, cache, pos)
    elif kind == "cross":
        out, kv_self = attn.gqa_decode(p["attn"], cfg, h, cache["self"], pos)
        x = x + out
        hx = rmsnorm(p["norm_x"], x, cfg.norm_eps)
        out = attn.cross_decode(p["xattn"], cfg, hx, cache["cross"])
        cache = {"self": kv_self, "cross": cache["cross"]}
    else:
        out, cache = attn.gqa_decode(p["attn"], cfg, h, cache, pos, window=_window(cfg, kind))
    x, _ = _ffn(p, cfg, x + out)
    return x, cache


# ===========================================================================
# Whole model
# ===========================================================================


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """``repro``'s ``_embed_inputs``: the token embedding, for the VLM
    after the projected patches; returns (x, positions, prefix), ``prefix``
    the patches every position sees (0 without them)."""
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, scale_by_sqrt_dim=True)
    prefix = 0
    if cfg.family == "vlm":
        patches = batch["patches"].to(device=x.device, dtype=x.dtype)  # [B, P, frontend_dim]
        x = torch.cat([dense(params["frontend"]["proj_in"], patches), x], dim=1)
        prefix = patches.shape[1]
    return x, _positions(x.shape[0], x.shape[1], x.device), prefix


def encode(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``repro``'s ``_encode``: ``batch["frames"]`` [B, T_enc,
    frontend_dim] in bf16 through ``proj_in`` and the bidirectional encoder
    layers, then ``enc_norm``: [B, T_enc, d]."""
    frames = batch["frames"].to(torch.bfloat16)
    h = dense(params["frontend"]["proj_in"], frames)
    positions = _positions(h.shape[0], h.shape[1], h.device)
    for layer in params["encoder"]:
        h, _, _ = block_forward(layer, cfg, "enc", h, positions)
    return rmsnorm(params["enc_norm"], h, cfg.norm_eps)


def _hidden(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            want_cache: bool, remat: bool = False):
    """The decoder's final hidden state; with ``remat`` (and grad enabled)
    each decoder layer runs under :func:`_checkpoint`, as ``repro``'s
    training scan wraps each layer step (its encoder is not rematted)."""
    check_supported(cfg)
    enc_out = encode(params, cfg, batch) if cfg.n_encoder_layers else None
    x, positions, prefix = _embed_inputs(params, cfg, batch)
    caches = []
    aux_total = torch.zeros((), device=x.device)
    remat = remat and torch.is_grad_enabled()
    for kind, layer in zip(layer_kinds(cfg), params["layers"]):
        args = (layer, cfg, kind, x, positions, want_cache, prefix, enc_out)
        x, cache, aux = _checkpoint(block_forward, *args) if remat else block_forward(*args)
        caches.append(cache)
        if aux is not None:
            aux_total = aux_total + aux
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, (caches if want_cache else None), aux_total


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            want_cache: bool = False, remat: bool = False):
    """Full-sequence forward over ``repro``'s batch: ``{"tokens"}``, with
    ``"patches"`` for the VLM (its logits cover patches and text) and
    ``"frames"`` for the encoder-decoder; returns (logits, aux_loss,
    caches).  ``remat``: see :func:`_hidden`."""
    x, caches, aux = _hidden(params, cfg, batch, want_cache, remat)
    logits = unembed(params["embed"], x, cfg.logit_softcap)
    return logits, aux, caches


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True):
    """``repro``'s ``loss_fn``: the next-token cross entropy of
    :func:`forward`'s logits (the VLM's text positions only) against
    ``batch["targets"]`` shifted by one, under ``batch["mask"]`` if given,
    plus ``router_aux_coef`` times the MoE aux loss, each decoder layer
    rematerialized under ``remat`` (:func:`set_remat_policy`).  Returns
    (total, {"loss", "aux"}); differentiable in the parameters (the flash
    kernel through its backward kernel on the card)."""
    logits, aux, _ = forward(params, cfg, batch, remat=remat)
    if cfg.family == "vlm":  # only text positions carry loss
        logits = logits[:, batch["patches"].shape[1]:]
    loss = softmax_xent(logits[:, :-1], batch["targets"][:, 1:], batch.get("mask"))
    return loss + cfg.router_aux_coef * aux, {"loss": loss, "aux": aux}


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            return_hidden: bool = False):
    """Returns (last_token_logits, caches[, last_hidden]) for decode.

    Only the last position is unembedded: its logits are those of
    :func:`forward`, without the ``[B, S, vocab]`` tensor.
    """
    x, caches, _ = _hidden(params, cfg, batch, want_cache=True)
    last = x[:, -1]
    logits = unembed(params["embed"], last, cfg.logit_softcap)
    return (logits, caches, last) if return_hidden else (logits, caches)


def decode_step(params: Params, cfg: ModelConfig, caches: Caches, token: torch.Tensor,
                pos: int, return_hidden: bool = False):
    """One decode step. token: [B] integer; pos: the step's position (the
    VLM's counts its patches: ``P + tokens so far``).

    Returns (logits [B, vocab], caches[, hidden [B, d]]); the caches are
    written in place.
    """
    check_supported(cfg)
    x = embed(params["embed"], token[:, None], scale_by_sqrt_dim=True)
    new_caches = []
    for kind, layer, cache in zip(layer_kinds(cfg), params["layers"], caches):
        x, cache = block_decode(layer, cfg, kind, x, cache, pos)
        new_caches.append(cache)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)[:, 0]
    logits = unembed(params["embed"], x, cfg.logit_softcap)
    return (logits, new_caches, x) if return_hidden else (logits, new_caches)


# ===========================================================================
# Cache specs
# ===========================================================================


def cache_struct(cfg: ModelConfig, batch: int, seq: int, dtype=torch.bfloat16,
                 enc_len: Optional[int] = None) -> List[Any]:
    """(shape, dtype) of each layer's cache, mirroring ``prefill``'s: (k, v)
    (a ring of ``cfg.window`` slots for ``"attn_local"``; under
    ``attention.KV_QUANT`` the int8 cache ``(k_q, v_q, k_scale, v_scale)``
    of those slots for ``"attn"``, ``"moe"`` and ``"attn_local"``), (c_kv,
    k_rope) for MLA, (conv, state) for SSM, (conv, h) for RG-LRU, ``{"self":
    (k, v), "cross": (ck, cv)}`` for ``"cross"``, the cross pair over
    ``enc_len`` positions (by default ``cfg.frontend_seq``, else ``seq``),
    as in ``repro`` (without its stacked layer axis)."""
    check_supported(cfg)
    enc_len = enc_len or cfg.frontend_seq or seq

    def spec(kind):
        if kind == "cross":
            kv = (torch.Size(attn.gqa_cache_shape(cfg, batch, seq)), dtype)
            enc = (torch.Size(attn.gqa_cache_shape(cfg, batch, enc_len)), dtype)
            return {"self": (kv, kv), "cross": (enc, enc)}
        if kind == "ssm":
            conv, state = ssm_mod.ssm_cache_shapes(cfg, batch)
            return (torch.Size(conv), dtype), (torch.Size(state), torch.float32)
        if kind == "rec":
            conv, h = rec_mod.rglru_cache_shapes(cfg, batch)
            return (torch.Size(conv), dtype), (torch.Size(h), torch.float32)
        if kind in ("mla", "mla_moe"):
            c_sh, r_sh = attn.mla_cache_shapes(cfg, batch, seq)
            return (torch.Size(c_sh), dtype), (torch.Size(r_sh), dtype)
        sh = torch.Size(attn.gqa_cache_shape(cfg, batch, seq, _window(cfg, kind)))
        if attn.KV_QUANT:
            values, scales = (sh, torch.int8), (sh[:-1] + (1,), torch.bfloat16)
            return values, values, scales, scales
        return (sh, dtype), (sh, dtype)

    return [spec(kind) for kind in layer_kinds(cfg)]


def pad_caches(cfg: ModelConfig, caches: Caches, target_len: int) -> Caches:
    """Grow each KV cache's seq axis to ``target_len`` with zeros (decode
    headroom; an int8 cache's four tensors alike); an MLA cache grows its
    shared buffer, so its two views still
    alias one buffer.  Ring (windowed), SSM and RG-LRU caches are fixed-size
    and pass through untouched, as does a cross block's ``"cross"`` pair
    (its ``"self"`` pair grows)."""

    def pad(a):
        return a if a.shape[1] >= target_len else F.pad(
            a, (0, 0, 0, 0, 0, target_len - a.shape[1]))

    def grown(kind, cache):
        if kind in ("mla", "mla_moe"):
            return attn.mla_pad(cache, target_len)
        if kind in ("attn", "moe"):
            return tuple(pad(a) for a in cache)
        if kind == "cross":
            return {"self": tuple(pad(a) for a in cache["self"]), "cross": cache["cross"]}
        return cache

    return [grown(kind, cache) for kind, cache in zip(layer_kinds(cfg), caches)]


def param_count(params: Params) -> int:
    def count(tree) -> int:
        if isinstance(tree, torch.Tensor):
            return tree.numel()
        items = tree.values() if isinstance(tree, dict) else tree
        return sum(count(x) for x in items)

    return count(params)


def active_param_count(params: Params, cfg: ModelConfig) -> int:
    """``repro``'s ``active_param_count``: parameters a token uses, the
    routed experts' counted at ``experts_per_token / n_experts`` (every
    tensor under an ``"experts"`` key)."""
    total = param_count(params)
    if not cfg.n_experts:
        return total

    def expert_size(tree, under: bool = False) -> int:
        if isinstance(tree, torch.Tensor):
            return tree.numel() if under else 0
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return sum(expert_size(x, under or "experts" in str(key)) for key, x in items)

    e_total = expert_size(params)
    return int(total - e_total + e_total * (cfg.experts_per_token / cfg.n_experts))
