"""qwen3-0.6b [hf:Qwen/Qwen3-0.6B]: 28L d1024 16H kv8, qk_norm.

Qwen3 uses head_dim=128 (detached from d_model/n_heads); we follow HF.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    attn_type="gqa",
    qk_norm=True,
    rope_theta=1e6,
    mlp_type="swiglu",
    sub_quadratic=False,
)
