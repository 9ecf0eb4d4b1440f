"""gemma-2b [arXiv:2403.08295; hf]: 18L d2048 8H MQA(kv=1) d_ff=16384 GeGLU."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    attn_type="gqa",
    mlp_type="geglu",
    sub_quadratic=False,
)
