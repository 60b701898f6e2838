"""internvl2-2b [vlm] — arXiv:2404.16821 (hf tier).

Backbone: InternLM2-1.8B — 24L d_model=2048 16H (GQA kv=8, head_dim=128)
d_ff=8192 vocab=92553.

The InternViT-300M vision frontend is a STUB per the task spec: input_specs()
supplies precomputed patch embeddings (batch, frontend_seq, d_model) that are
concatenated in front of the token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2_048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8_192,
    vocab_size=92_553,
    frontend="vision_stub",
    frontend_seq=256,        # 256 visual tokens after pixel-shuffle (448px / 14 / 2)^2
    frontend_dim=2_048,      # already projected to backbone width by the stub
    rope_theta=1_000_000.0,
)
