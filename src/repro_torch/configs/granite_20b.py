"""granite-20b [arXiv:2405.04324; hf]: 52L d6144 48H MQA(kv=1) d_ff=24576."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    attn_type="gqa",
    mlp_type="gelu",  # granite-20b-code is a gpt-bigcode derivative
    sub_quadratic=False,
)
