"""xlstm-125m [ssm] — arXiv:2405.04517 (unverified tier).

12 blocks, d_model=768, 4 heads (head_dim=192), vocab=50304, d_ff=0 (xLSTM
blocks carry their own up/down projections, proj_factor=2). Alternating
mLSTM / sLSTM blocks (6 groups of 2).

Attention-free -> runs the long_500k cell (decode state is O(1) in sequence
length: per-head matrix memory C, normalizer n, stabilizer m).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=("mlstm", "slstm"),
    proj_factor=2.0,
    mlstm_chunk=256,
)
