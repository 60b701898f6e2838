"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8, hd=128), QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8_192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
