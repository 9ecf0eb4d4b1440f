"""mamba2-370m [arXiv:2405.21060]: 48L d1024 SSD, ssm_state=128, attn-free."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    attn_type="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_width=4,
    sub_quadratic=True,  # O(1)-state decode: runs long_500k
)
