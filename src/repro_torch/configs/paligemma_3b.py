"""paligemma-3b [arXiv:2407.07726; hf]: SigLIP stub + gemma-2b backbone.

The SigLIP vision tower is a STUB per the task spec: input_specs() provides
256 precomputed patch embeddings (frontend_dim=1152, SigLIP-So400m width)
projected into the LM; the decoder is the gemma-2b backbone with a
prefix-LM mask over the image tokens.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    attn_type="gqa",
    mlp_type="geglu",
    frontend="vision_stub",
    frontend_seq=256,
    frontend_dim=1152,
    sub_quadratic=False,
)
