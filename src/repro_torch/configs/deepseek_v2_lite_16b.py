"""deepseek-v2-lite-16b [arXiv:2405.04434; hf].

Assigned spec: 27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
"MoE 64e top-6 — MLA kv_lora=512, 2 shared+160 routed top-6".
DISCREPANCY (recorded in DESIGN.md): the headline says 64 routed experts
top-6 while the trailing note says 160 routed; DeepSeek-V2-Lite's published
config is 64 routed + 2 shared, top-6, with the first layer dense and
moe_d_ff=1408 — we implement that reading.  MLA: kv_lora_rank=512,
per-head 128 nope + 64 rope dims, v_head_dim=128.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,  # nope 128 + rope 64
    d_ff=10944,    # dense first layer FFN (DeepSeek-V2-Lite)
    vocab_size=102400,
    attn_type="mla",
    kv_lora_rank=512,
    q_lora_rank=0,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    mlp_type="swiglu",
    n_experts=64,
    experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_k_dense=1,
    sub_quadratic=False,
)
