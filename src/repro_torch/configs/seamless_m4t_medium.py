"""seamless-m4t-medium [audio] — arXiv:2308.11596 (hf tier).

Enc-dec transformer backbone: 12 encoder + 12 decoder layers, d_model=1024,
16H (kv=16, head_dim=64), d_ff=4096, vocab=256206.

The speech frontend (w2v-BERT conformer) is a STUB per the task spec:
input_specs() supplies precomputed frame embeddings (batch, frontend_seq, 1024)
consumed by the text encoder stack; the decoder cross-attends to encoder output.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    cross_attention=True,
    d_model=1_024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4_096,
    vocab_size=256_206,
    frontend="audio_stub",
    frontend_seq=1_024,       # precomputed speech frames fed to the encoder
    frontend_dim=1_024,
    rope_theta=10_000.0,
    mlp_act="gelu",           # NLLB/seamless transformer uses ReLU/GELU FFN
)
