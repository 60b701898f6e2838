"""Checkpoints of the port: the flat multi-version disk store (`store.py`,
the reference's on-disk format), its delta variant (`delta.py`) and the
tier hierarchy (`tiers.py`: device and host rings, the disk and partner
stores behind one planner, and the Tier-0 `SlotRing` of continuous
serving)."""
from repro_torch.checkpoint.delta import DeltaCheckpointStore
from repro_torch.checkpoint.store import (CheckpointCorruptionError,
                                          CheckpointStore, DiskReadStats,
                                          Manifest, count_disk_reads)
from repro_torch.checkpoint.tiers import (DeviceRing, HostRing,
                                          TieredCheckpointer, TierSchedule,
                                          make_tiered, parse_tiers)

__all__ = ["CheckpointCorruptionError", "CheckpointStore",
           "DeltaCheckpointStore", "DeviceRing", "DiskReadStats", "HostRing",
           "Manifest", "TierSchedule", "TieredCheckpointer",
           "count_disk_reads", "make_tiered", "parse_tiers"]
