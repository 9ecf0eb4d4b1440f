"""Model / shape configuration dataclasses for the assigned architectures."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture from the assigned pool (verbatim numbers; see DESIGN.md
    §Arch-applicability for recorded spec discrepancies)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio_encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---------------------------------------------------------
    attn_type: str = "gqa"  # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0

    # --- MLA (deepseek) ----------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MLP ----------------------------------------------------------------
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # --- hybrid (recurrentgemma) ---------------------------------------------
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    window: int = 0
    lru_width: int = 0

    # --- encoder-decoder -----------------------------------------------------
    n_encoder_layers: int = 0
    cross_attention: bool = False

    # --- modality frontend stubs ---------------------------------------------
    frontend: str = ""  # "" | vision_stub | audio_stub
    frontend_seq: int = 0  # stub tokens prepended (vlm) / encoder frames (audio)
    frontend_dim: int = 0

    # --- misc -----------------------------------------------------------------
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    sub_quadratic: bool = False  # supports long_500k decode

    @property
    def qkv_heads_padded(self) -> int:
        return self.n_heads

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim if self.ssm_head_dim else 0


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": ShapeSpec("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeSpec("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": ShapeSpec("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Task rules: long_500k only for sub-quadratic archs; decode needs a decoder."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k context is quadratic — skipped per task spec"
    return True, ""


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    changes = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else cfg.n_kv_heads,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
    )
    if cfg.attn_type == "mla":
        changes.update(kv_lora_rank=32, q_lora_rank=0, rope_head_dim=8,
                       nope_head_dim=16, v_head_dim=16, head_dim=16)
    if cfg.n_experts:
        # capacity_factor = E ensures no capacity drops in tiny smoke tests,
        # keeping prefill/decode exactly consistent.
        changes.update(n_experts=4, experts_per_token=2, moe_d_ff=64,
                       n_shared_experts=min(cfg.n_shared_experts, 1),
                       capacity_factor=4.0)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.lru_width:
        changes.update(lru_width=64, window=32)
    if cfg.window and not cfg.lru_width:
        changes.update(window=32)
    if cfg.n_encoder_layers:
        changes.update(n_encoder_layers=2)
    if cfg.frontend_seq:
        changes.update(frontend_seq=8, frontend_dim=32)
    if cfg.block_pattern:
        changes.update(n_layers=len(cfg.block_pattern))
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
