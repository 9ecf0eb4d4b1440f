"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base].

Assigned spec: 32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155,
"MoE 40e top-8 — 32 experts top-8".
DISCREPANCY (recorded in DESIGN.md): headline says 40 experts, bracket note
says 32; we implement the assigned headline: 40 experts, top-8, expert
d_ff=512.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    attn_type="gqa",
    mlp_type="swiglu",
    n_experts=40,
    experts_per_token=8,
    n_shared_experts=0,
    moe_d_ff=512,
    sub_quadratic=False,
)
