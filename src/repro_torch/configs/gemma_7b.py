"""gemma-7b [arXiv:2403.08295; hf]: 28L d3072 16H kv16 d_ff=24576 GeGLU."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    attn_type="gqa",
    mlp_type="geglu",
    sub_quadratic=False,
)
