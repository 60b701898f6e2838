"""Checkpoint tiers of the port. Only the Tier-0 `SlotRing` of continuous
serving is ported so far (`tiers.py`)."""
