"""recurrentgemma-2b [arXiv:2402.19427; hf]: RG-LRU + local attn, 1:2.

26 layers in the Griffin pattern (rec, rec, local-attn) — 2 recurrent
blocks per local-attention block, window 2048, lru_width=2560.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    attn_type="gqa",
    mlp_type="geglu",
    block_pattern=("rec", "rec", "attn_local"),
    window=2048,
    lru_width=2560,
    conv_width=4,
    sub_quadratic=True,  # bounded window + O(1) recurrent state: runs long_500k
)
