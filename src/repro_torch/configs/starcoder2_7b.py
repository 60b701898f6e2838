"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4, hd=128), biased
linear layers and a plain GELU MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4_608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_432,
    vocab_size=49_152,
    qkv_bias=True,
    rope_theta=100_000.0,
    mlp_act="gelu",
)
