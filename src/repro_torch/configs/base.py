"""Configuration dataclasses for the PyTorch port of SEDAR.

Copies of the reference package's dataclasses (`repro/configs/base.py`),
kept field-for-field so that one configuration means the same run in both
packages. The port keeps its own copy: it imports nothing of `repro`.
`RunConfig.mesh` is the one place a run's mesh shape comes from: the
mesh backends' trainer takes only the process groups as `mesh=` (a
`launch/mesh.py::ProcessMesh`, made from the same `MeshConfig`) and raises
if their shape disagrees.

Every run is described by a `RunConfig`, which composes:
  * `ModelConfig`   -- architecture hyper-parameters.
  * `TrainConfig`   -- optimizer / schedule / batching.
  * `ServeConfig`   -- serving batch / context.
  * `MeshConfig`    -- the process mesh of the `pod`/`vote` backends, of
                       the elastic trainer's data axis and of expert
                       parallelism (`launch/mesh.py::make_process_mesh`).
  * `SedarConfig`   -- the paper's fault-tolerance knobs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (same fields as the reference)."""

    name: str
    family: str                       # dense | moe | hybrid | vlm | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    mlp_act: str = "swiglu"           # swiglu | gelu

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0

    # --- hybrid (recurrentgemma-style) --------------------------------------
    block_pattern: Tuple[str, ...] = ()
    window_size: int = 0
    d_rnn: int = 0
    conv_width: int = 4

    # --- ssm / xlstm ---------------------------------------------------------
    mlstm_chunk: int = 256
    proj_factor: float = 2.0

    # --- encoder-decoder ------------------------------------------------------
    encoder_layers: int = 0
    cross_attention: bool = False

    # --- modality frontend ------------------------------------------------------
    frontend: Optional[str] = None
    frontend_seq: int = 0
    frontend_dim: int = 0

    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"           # activation / compute dtype
    param_dtype: str = "float32"      # master parameter dtype

    # --- attention implementation --------------------------------------------
    # "xla": plain tensor attention (the reference's einsum path);
    # "pallas": the hand-written flash-attention kernel (K2) on prefill.
    attention_impl: str = "xla"

    remat: str = "full"               # none | minimal | full (training only)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.family == "hybrid" and self.d_rnn == 0:
            object.__setattr__(self, "d_rnn", self.d_model)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class MeshConfig:
    """The mesh's shape and axis names ("pod", "data" and "model"). The
    port runs the mesh as processes (`launch/mesh.py`): one rank per
    (pod, data, model) index; a model axis larger than 1 carries expert
    parallelism (`models/moe.py::moe_mlp_ep`), which no trainer runs."""

    shape: Tuple[int, ...] = (2, 1)
    axis_names: Tuple[str, ...] = ("pod", "data")


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    microbatch: int = 0
    steps: int = 100
    optimizer: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    schedule: str = "cosine"
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    grad_compression: str = "none"
    donate_state: bool = True


@dataclass(frozen=True)
class ServeConfig:
    batch: int = 128
    context_len: int = 32_768
    prefill_chunk: int = 0
    cache_dtype: str = "bfloat16"


@dataclass(frozen=True)
class SedarConfig:
    """Fault-tolerance configuration (paper Secs. 3.1-3.3).

    level: 0 off, 1 detection + safe stop, 2 checkpoint chain + rollback,
    3 single validated application-level checkpoint."""

    level: int = 3
    replication: str = "dual"
    replica_axis: str = "pod"
    compare: str = "fingerprint"
    validate_interval: int = 1
    validate_lag: int = 1
    param_validate_interval: int = 50
    checkpoint_interval: int = 50
    checkpoint_dir: str = "/tmp/sedar_ckpt"
    max_checkpoints: int = 0
    async_checkpoint: bool = True
    ckpt_tiers: str = "disk"
    device_ring_slots: int = 4
    host_ring_slots: int = 4
    device_ckpt_interval: int = 1
    host_ckpt_interval: int = 0
    partner_ckpt_interval: int = 0
    ckpt_delta: bool = False
    ckpt_compress: bool = False
    toe_timeout_s: float = 120.0
    app_level_dtype: str = "float32"
    fused_fingerprint: bool = True


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    sedar: SedarConfig = field(default_factory=SedarConfig)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape sets (the reference's: 4 shapes per LM arch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k",    "train",   4_096,   256),
    ShapeSpec("prefill_32k", "prefill", 32_768,  32),
    ShapeSpec("decode_32k",  "decode",  32_768,  128),
    ShapeSpec("long_500k",   "decode",  524_288, 1),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(model: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """The reference's applicability: ``long_500k`` only for sub-quadratic
    archs. Returns (applicable, reason_if_not)."""
    if shape.name == "long_500k" and model.family not in ("hybrid", "ssm"):
        return False, (
            "long_500k skipped: pure full-attention architecture (dense 500k KV "
            "cache); per task spec only SSM/hybrid/linear-attention archs run it "
            "(see DESIGN.md)"
        )
    return True, ""


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Scale an architecture down to CPU-smoke size, preserving its family
    structure (GQA ratio, MoE top-k, block pattern, enc-dec split, frontend).
    Same result as the reference's `reduce_for_smoke`."""
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    heads = (heads // kv) * kv or kv
    head_dim = 16
    if cfg.family == "ssm":
        d_model = heads * head_dim
    else:
        d_model = heads * head_dim * 2
    pattern = cfg.block_pattern
    layers = 2 * len(pattern) if pattern else 2
    return dataclasses.replace(
        cfg,
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=4 * d_model if cfg.d_ff else 0,
        vocab_size=257,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.experts_per_token else 0,
        window_size=min(cfg.window_size, 8) if cfg.window_size else 0,
        d_rnn=d_model if cfg.family == "hybrid" else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        frontend_seq=min(cfg.frontend_seq, 6) if cfg.frontend_seq else 0,
        frontend_dim=d_model if cfg.frontend_dim else 0,
        mlstm_chunk=8,
        dtype="float32",
        param_dtype="float32",
        remat="none",
    )
