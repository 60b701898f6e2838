"""Checkpoints of the port: the flat multi-version disk store (`store.py`,
the reference's on-disk format), its delta variant (`delta.py`) and the
Tier-0 `SlotRing` of continuous serving (`tiers.py`). The device, host and
partner tiers and their planner are not ported yet."""
from repro_torch.checkpoint.delta import DeltaCheckpointStore
from repro_torch.checkpoint.store import (CheckpointCorruptionError,
                                          CheckpointStore, DiskReadStats,
                                          Manifest, count_disk_reads)

__all__ = ["CheckpointCorruptionError", "CheckpointStore",
           "DeltaCheckpointStore", "DiskReadStats", "Manifest",
           "count_disk_reads"]
