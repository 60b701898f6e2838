"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8, hd=128)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=32_768,
    qkv_bias=False,
    rope_theta=1_000_000.0,
)
