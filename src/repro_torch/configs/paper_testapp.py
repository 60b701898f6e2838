"""The paper's synthetic test application, adapted: a tiny dense LM whose
step exposes the paper's boundary structure (see the reference's
`configs/paper_testapp.py`)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-testapp",
    family="dense",
    num_layers=4,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=1_024,
    vocab_size=1_024,
    dtype="float32",
    param_dtype="float32",
    remat="none",
)
