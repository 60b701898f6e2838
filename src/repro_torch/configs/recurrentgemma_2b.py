"""recurrentgemma-2b [hybrid] — arXiv:2402.19427 (Griffin; hf tier).

26L d_model=2560 10H (GQA kv=1 for the local-attention blocks, head_dim=256)
d_ff=7680 vocab=256000. Block pattern 1 local-attention : 2 RG-LRU recurrent
(26 = 8 x (rec, rec, attn) + (rec, rec) tail). Sliding window 2048.

Sub-quadratic -> runs the long_500k cell (decode state = RG-LRU state +
2048-token ring window cache).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2_560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7_680,
    vocab_size=256_000,
    block_pattern=("recurrent", "recurrent", "attention"),
    window_size=2_048,
    d_rnn=2_560,
    conv_width=4,
    rope_theta=10_000.0,
)
