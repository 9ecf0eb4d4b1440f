"""seamless-m4t-large-v2 [arXiv:2308.11596; hf]: enc-dec, speech stub.

24 encoder + 24 decoder layers, d1024 16H kv16 d_ff=8192, vocab 256206.
The speech frontend (w2v-BERT) is a STUB: input_specs() provides precomputed
frame embeddings (frontend_dim=1024) consumed by the text-decoder backbone
through cross-attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio_encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    attn_type="gqa",
    mlp_type="gelu",
    n_encoder_layers=24,
    cross_attention=True,
    frontend="audio_stub",
    frontend_seq=4096,   # encoder frames per train_4k cell (= seq_len)
    frontend_dim=1024,
    sub_quadratic=False,
)
