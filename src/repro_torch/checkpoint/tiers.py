"""Tiered checkpoint hierarchy — device / host / disk / partner (the
reference's `checkpoint/tiers.py`).

The paper's levels of checkpointing (L2/L3) say WHAT a checkpoint means;
this module says WHERE it lives:

  Tier 0  `device`   on-device snapshot ring: a clone per leaf on the card,
                     no copy to the host, no serialization. A rollback from
                     it performs ZERO disk reads and ZERO host reads.
                     Survives nothing but the process (an SDC in the step,
                     the common case).
  Tier 1  `host`     host-RAM ring: ONE batched device-to-host copy per
                     save (`hostsync.batched_get`), no serialization.
  Tier 2  `disk`     the atomic `CheckpointStore` (or `DeltaCheckpointStore`,
                     compressed leaves). Survives process death.
  Tier 3  `partner`  a second directory with independently computed digests
                     (numpy's, on the writer thread): the fallback when a
                     Tier-2 restore raises `CheckpointCorruptionError`.

`TieredCheckpointer` is the single facade: per-tier save cadences
(`TierSchedule`), one shared device-to-host copy feeding every durable tier,
and a cost-aware restore planner (`plan` / `restore`) that picks the
cheapest tier holding a version at or below the caller's bound and falls
back tier by tier (then version by version) on corruption — each fallback
an event passed to `notify` and recorded in the restore's info, never
silent.

Ring tiers hold versions INSIDE the deferred-validation window (they are
disposable; the planner's `max_step` bound filters them), while the durable
tiers are only cut after a clean flush. Ring eviction keeps the same
`keep_floor` anchor as `CheckpointStore.gc_keep_last`. `SlotRing` is the
per-slot Tier-0 ring of continuous serving.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch import tree as tree_util
from repro_torch.checkpoint.store import (CheckpointCorruptionError,
                                          CheckpointStore, snapshot)

TIER_ORDER = ("device", "host", "disk", "partner")

# Relative restore-cost weights for the planner (unitless; only ratios
# matter). A device slot is a few device copies; host pays one upload; disk
# pays deserialization + digest checks; partner is disk plus being the last
# line of defense. `DEFAULT_REWORK_WEIGHT` prices one step of lost
# progress, so a ring slot `k` steps older than a disk version wins until
# the rework gap outgrows the deserialization saving.
DEFAULT_RESTORE_COSTS = {"device": 1.0, "host": 4.0,
                         "disk": 64.0, "partner": 96.0}
DEFAULT_REWORK_WEIGHT = 1.0


def _clone(state):
    return tree_util.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)


@dataclass(frozen=True)
class TierSchedule:
    """Per-tier save cadence in steps; 0 disables the tier."""

    device: int = 0
    host: int = 0
    disk: int = 0
    partner: int = 0

    def interval(self, tier: str) -> int:
        return int(getattr(self, tier))

    def tier_due(self, tier: str, step: int) -> bool:
        iv = self.interval(tier)
        return iv > 0 and step > 0 and step % iv == 0

    def enabled(self) -> Tuple[str, ...]:
        return tuple(t for t in TIER_ORDER if self.interval(t) > 0)


class _Ring:
    """Bounded newest-last version ring of the device and host tiers.

    Eviction keeps `keep_floor` as `gc_keep_last` does: the newest slot at
    or below the floor (the last version older than every unvalidated step)
    is pinned, so a deferred-window fault always finds a rollback target in
    the ring even after the ring rotates past it."""

    def __init__(self, slots: int):
        self.slots = max(int(slots), 1)
        self._ring: List[Tuple[int, Any]] = []

    def _put(self, step: int, payload, keep_floor: Optional[int]) -> None:
        self._ring = [e for e in self._ring if e[0] != step]
        self._ring.append((step, payload))
        self._ring.sort(key=lambda e: e[0])
        while len(self._ring) > self.slots:
            anchored = [s for s, _ in self._ring
                        if keep_floor is not None and s <= keep_floor]
            anchor = max(anchored) if anchored else None
            victim = next((i for i, (s, _) in enumerate(self._ring)
                           if s != anchor), None)
            if victim is None:
                break
            del self._ring[victim]

    def _get(self, step: int):
        for s, payload in self._ring:
            if s == step:
                return payload
        raise KeyError(f"version {step} not in ring")

    def versions(self) -> List[int]:
        return [s for s, _ in self._ring]

    def keep_only(self, step: int) -> None:
        self._ring = [e for e in self._ring if e[0] == step]

    def clear(self) -> None:
        self._ring = []


class DeviceRing(_Ring):
    """Tier 0: on-device snapshot ring. Saves and restores are clones on
    the state's own device, both ways: a restored state must never alias a
    slot (the slot outlives it and may be restored again)."""

    name = "device"

    def save(self, step: int, state,
             keep_floor: Optional[int] = None) -> None:
        self._put(step, _clone(state), keep_floor)

    def restore(self, step: int):
        return _clone(self._get(step))


class HostRing(_Ring):
    """Tier 1: host-RAM ring of a state's leaves (numpy, flatten order) and
    its structure (a skeleton without the tensors, so the ring keeps no
    device memory alive); a restore uploads them to the template's
    devices (the CPU without a template) without touching the disk."""

    name = "host"

    def save(self, step: int, host_leaves: List[np.ndarray], state,
             keep_floor: Optional[int] = None) -> None:
        skeleton = tree_util.tree_map(lambda _: 0, state)
        self._put(step, (list(host_leaves), skeleton), keep_floor)

    def restore(self, step: int, template=None):
        from repro_torch.device import upload
        leaves, skeleton = self._get(step)
        tpl = template if template is not None else skeleton
        tleaves = tree_util.leaves(tpl)
        if len(tleaves) != len(leaves):
            raise ValueError(
                f"host ring version {step} has {len(leaves)} leaves, "
                f"template has {len(tleaves)}")
        out = []
        for arr, t in zip(leaves, tleaves):
            dev = t.device if isinstance(t, torch.Tensor) \
                else torch.device("cpu")
            out.append(upload(arr, dev))
        return tree_util.unflatten_like(tpl, out)


class SlotRing:
    """One bounded version ring PER SEQUENCE SLOT, holding that slot's
    {cache slice, token, position} image on the device.

    Saves and restores are device-side copies: no disk, no host read. The
    ring stores CLONES and hands out clones: the serving KV cache is written
    in place, so a stored view would silently change with the next decode
    step. Versions are decode ticks; `restore(slot, max_step=k)` returns
    the newest snapshot at or below `k`. `evict` drops a finished or
    rejected request's history so the ring never resurrects state across
    requests sharing a slot."""

    name = "device"

    def __init__(self, slots_per_key: int = 4):
        self.slots_per_key = max(int(slots_per_key), 1)
        self._rings: Dict[int, List[Tuple[int, Any]]] = {}
        self.saves = 0
        self.restores = 0

    def save(self, key: int, step: int, state_slice) -> None:
        """Store a clone of `state_slice` as version `step` of `key`; the
        oldest version leaves once the key holds `slots_per_key`."""
        ring = [e for e in self._rings.get(int(key), []) if e[0] != step]
        ring.append((int(step), _clone(state_slice)))
        ring.sort(key=lambda e: e[0])
        self._rings[int(key)] = ring[-self.slots_per_key:]
        self.saves += 1

    def save_many(self, step: int, slices: Dict[int, Any]) -> None:
        """Snapshots of several keys at one shared version (a prefill pack's
        admitted rows, or every running slot at a clean flush edge)."""
        for key, sl in slices.items():
            self.save(key, step, sl)

    def versions(self, key: int) -> List[int]:
        return [s for s, _ in self._rings.get(int(key), [])]

    def restore(self, key: int, max_step: Optional[int] = None
                ) -> Tuple[int, Any]:
        """Newest version at or below `max_step` for `key` -> (version, a
        clone of its slice). KeyError when nothing qualifies."""
        ring = self._rings.get(int(key))
        if ring is None:
            raise KeyError(f"no snapshots for slot {key}")
        cands = [e for e in ring if max_step is None or e[0] <= max_step]
        if not cands:
            raise KeyError(f"no slot-{key} snapshot at or below {max_step}")
        version, payload = cands[-1]
        self.restores += 1
        return version, _clone(payload)

    def nbytes(self) -> int:
        """Device bytes the stored snapshots hold."""
        return sum(x.numel() * x.element_size()
                   for ring in self._rings.values() for _, sl in ring
                   for x in tree_util.leaves(sl)
                   if isinstance(x, torch.Tensor))

    def evict(self, key: int) -> None:
        self._rings.pop(int(key), None)

    def clear(self) -> None:
        self._rings.clear()

class TieredCheckpointer:
    """Facade over the tier hierarchy: cadence-routed saves, one shared
    device-to-host copy for all durable tiers, cost-aware restore planning
    with corruption fallback, saves counted per tier."""

    def __init__(self, schedule: TierSchedule, *,
                 device_slots: int = 4, host_slots: int = 4,
                 disk_store: Optional[CheckpointStore] = None,
                 partner_store: Optional[CheckpointStore] = None,
                 notify: Optional[Callable[[dict], None]] = None):
        if schedule.interval("disk") > 0 and disk_store is None:
            raise ValueError("disk tier scheduled but no disk_store given")
        if schedule.interval("partner") > 0 and partner_store is None:
            raise ValueError("partner tier scheduled but no partner_store")
        self.schedule = schedule
        self.device = DeviceRing(device_slots) \
            if schedule.interval("device") > 0 else None
        self.host = HostRing(host_slots) \
            if schedule.interval("host") > 0 else None
        self.disk = disk_store
        self.partner = partner_store
        self.notify = notify or (lambda e: None)
        self.events: List[Dict[str, Any]] = []
        self.saves_by_tier: Dict[str, int] = {}

    # -- cadence ---------------------------------------------------------------

    def due(self, step: int) -> bool:
        return any(self.schedule.tier_due(t, step)
                   for t in self.schedule.enabled())

    def sync_due(self, step: int) -> bool:
        """True when a tier that pays a device-to-host copy is due (host,
        disk, partner): the engine flushes the deferred window first, so
        every durable version predates every unvalidated step."""
        return any(self.schedule.tier_due(t, step)
                   for t in ("host", "disk", "partner"))

    def fp_needed(self, step: int) -> bool:
        """Whether the engine should pay the state-fingerprint read for this
        save: only the serialized tiers record it in a manifest."""
        return any(self.schedule.tier_due(t, step)
                   for t in ("disk", "partner"))

    # -- save ------------------------------------------------------------------

    def save(self, step: int, state, *, fingerprint=None,
             valid: Optional[bool] = None, kind: str = "system",
             async_: bool = True, keep_floor: Optional[int] = None,
             force: bool = False) -> List[str]:
        """Route one version into every due tier; returns the tiers saved.
        One batched device-to-host copy (`snapshot`: the leaves and, on the
        card, their K1 digests) feeds host + disk + partner together; the
        device tier never leaves the card. `force=True` hits every enabled
        tier whatever its cadence (the L3 validated-checkpoint boundary
        replicates into all tiers at once)."""
        saved: List[str] = []

        def _due(tier: str) -> bool:
            iv = self.schedule.interval(tier)
            return iv > 0 and (force or self.schedule.tier_due(tier, step))

        if self.device is not None and _due("device"):
            with obs.span("checkpoint_tier", tier="device", step=step):
                self.device.save(step, state, keep_floor)
            saved.append("device")

        host_due = self.host is not None and _due("host")
        disk_due = self.disk is not None and _due("disk")
        partner_due = self.partner is not None and _due("partner")
        if host_due or disk_due or partner_due:
            host_leaves, digests = snapshot(state)
            if host_due:
                with obs.span("checkpoint_tier", tier="host", step=step):
                    self.host.save(step, host_leaves, state, keep_floor)
                saved.append("host")
            if disk_due:
                with obs.span("checkpoint_tier", tier="disk", step=step):
                    self.disk.save(step, state, kind=kind, valid=valid,
                                   fingerprint=fingerprint, async_=async_,
                                   snap=(host_leaves, digests))
                saved.append("disk")
            if partner_due:
                # independent digests: the partner's writer recomputes them
                # from the same host buffers
                with obs.span("checkpoint_tier", tier="partner", step=step):
                    self.partner.save(step, state, kind=kind, valid=valid,
                                      fingerprint=fingerprint, async_=async_,
                                      snap=(host_leaves, None))
                saved.append("partner")
        for t in saved:
            self.saves_by_tier[t] = self.saves_by_tier.get(t, 0) + 1
            obs.note_tier_save(t, step)
        return saved

    # -- version queries -------------------------------------------------------

    def _tier_versions(self, tier: str) -> List[int]:
        obj = getattr(self, tier, None)
        if obj is None:
            return []
        if tier in ("device", "host"):
            return obj.versions()
        return obj.steps()

    def versions(self) -> List[int]:
        out = set()
        for t in TIER_ORDER:
            out.update(self._tier_versions(t))
        return sorted(out)

    def latest_valid(self) -> Optional[int]:
        """Newest validated version across tiers (L3). The rings only ever
        receive validated states under L3, so their slots count; the disk
        tiers consult the manifest's valid flag."""
        cands: List[int] = []
        for t in ("device", "host"):
            cands.extend(self._tier_versions(t))
        for store in (self.disk, self.partner):
            if store is not None:
                v = store.latest(valid_only=True)
                if v is not None:
                    cands.append(v)
        return max(cands) if cands else None

    # -- restore planner -------------------------------------------------------

    def plan(self, version: Optional[int] = None,
             max_step: Optional[int] = None) -> List[Tuple[str, int]]:
        """Ordered restore candidates, cheapest first.

        With `version`: every tier holding exactly that version (tier cost
        order), then, as corruption fallbacks, every (tier, older version)
        ranked by `restore_cost + DEFAULT_REWORK_WEIGHT * (version - v)`.
        With only `max_step`: the cost-ranked list of candidates at or below
        it."""
        ref = version if version is not None else max_step

        def cost(tier: str, v: int) -> float:
            c = DEFAULT_RESTORE_COSTS[tier]
            if ref is not None:
                c += DEFAULT_REWORK_WEIGHT * max(ref - v, 0)
            return c

        exact: List[Tuple[str, int]] = []
        older: List[Tuple[str, int]] = []
        for t in TIER_ORDER:
            for v in self._tier_versions(t):
                if max_step is not None and v > max_step:
                    continue
                if version is not None:
                    if v == version:
                        exact.append((t, v))
                    elif v < version:
                        older.append((t, v))
                else:
                    older.append((t, v))
        exact.sort(key=lambda tv: cost(*tv))
        older.sort(key=lambda tv: cost(*tv))
        return exact + older

    def _restore_from(self, tier: str, version: int, template):
        if tier == "device":
            return self.device.restore(version)
        if tier == "host":
            return self.host.restore(version, template)
        store = self.disk if tier == "disk" else self.partner
        return store.restore(version, template)

    def restore(self, version: Optional[int], template, *,
                max_step: Optional[int] = None
                ) -> Tuple[Any, Dict[str, Any]]:
        """Restore `version` (or the planner's best candidate <= `max_step`
        when version is None) from the cheapest tier holding it.

        A tier that fails (`CheckpointCorruptionError` from a digest
        mismatch, or a payload that cannot be used) is recorded as a
        `tier_fallback` event and the next candidate is tried: the caller
        sees a recovery record, not an exception, unless EVERY candidate
        fails. Returns (state, info): the winning tier and version plus any
        fallbacks, for the engine's recovery record."""
        with obs.span("restore_plan", version=version, max_step=max_step):
            candidates = self.plan(version=version, max_step=max_step)
        if not candidates:
            raise KeyError(
                f"no restorable version (requested {version}, "
                f"max_step {max_step})")
        fallbacks: List[Dict[str, Any]] = []
        last_err: Optional[Exception] = None
        for tier, v in candidates:
            try:
                with obs.span("restore", tier=tier, version=v):
                    state = self._restore_from(tier, v, template)
            except (CheckpointCorruptionError, FileNotFoundError, KeyError,
                    ValueError, OSError) as e:
                ev = {"kind": "tier_fallback", "tier": tier, "version": v,
                      "error": f"{type(e).__name__}: {e}"}
                fallbacks.append(ev)
                self.events.append(ev)
                obs.note_tier_event(ev)
                self.notify(ev)
                last_err = e
                continue
            obs.note_tier_restore(tier, v)
            info: Dict[str, Any] = {"tier": tier, "version": v}
            if fallbacks:
                info["fallbacks"] = fallbacks
            return state, info
        raise CheckpointCorruptionError(
            f"every tier failed restoring version {version}: "
            f"{fallbacks}") from last_err

    # -- retention -------------------------------------------------------------

    def keep_only(self, step: int) -> None:
        """L3's "exactly one valid checkpoint", enforced PER TIER."""
        for ring in (self.device, self.host):
            if ring is not None:
                ring.keep_only(step)
        for store in (self.disk, self.partner):
            if store is not None:
                store.delete_others_than(step)

    def gc_keep_last(self, n: int, keep_floor: Optional[int] = None) -> None:
        """Bounded-chain GC of the durable tiers (the rings bound
        themselves)."""
        for store in (self.disk, self.partner):
            if store is not None:
                store.gc_keep_last(n, keep_floor=keep_floor)

    def wait(self) -> None:
        """Durability barrier across every disk-backed tier."""
        for store in (self.disk, self.partner):
            if store is not None:
                store.wait()

    def drop_volatile(self) -> None:
        """Node loss: the device and host rings live in the failed
        process's memory; drop them so only the durable tiers can serve a
        restore."""
        for ring in (self.device, self.host):
            if ring is not None:
                ring.clear()

    def clear(self) -> None:
        for ring in (self.device, self.host):
            if ring is not None:
                ring.clear()
        for store in (self.disk, self.partner):
            if store is not None:
                store.clear()


# ---------------------------------------------------------------------------
# Construction from a SedarConfig (make_recovery's entry point)
# ---------------------------------------------------------------------------

def parse_tiers(spec: str) -> Tuple[str, ...]:
    names = tuple(t.strip() for t in str(spec).split(",") if t.strip())
    bad = [t for t in names if t not in TIER_ORDER]
    if bad:
        raise ValueError(f"unknown checkpoint tier(s) {bad}; "
                         f"valid: {TIER_ORDER}")
    return names or ("disk",)


def make_tiered(sedar_cfg, directory: str,
                disk_store: Optional[CheckpointStore] = None,
                notify: Optional[Callable[[dict], None]] = None
                ) -> Optional[TieredCheckpointer]:
    """A `TieredCheckpointer` from a SedarConfig, or None when the config
    names only the flat disk store. Cadences: device every
    `device_ckpt_interval` steps (default 1), host and partner every
    `host_ckpt_interval` / `partner_ckpt_interval` steps (0: the disk
    cadence, `checkpoint_interval`); the partner directory sits beside the
    primary, `<directory>/checkpoints_partner`, with its own manifests."""
    names = parse_tiers(sedar_cfg.ckpt_tiers)
    if names == ("disk",):
        return None
    iv = int(sedar_cfg.checkpoint_interval)
    sched = TierSchedule(
        device=(int(sedar_cfg.device_ckpt_interval) or 1)
        if "device" in names else 0,
        host=(int(sedar_cfg.host_ckpt_interval) or iv)
        if "host" in names else 0,
        disk=iv if "disk" in names else 0,
        partner=(int(sedar_cfg.partner_ckpt_interval) or iv)
        if "partner" in names else 0)
    partner_store = None
    if "partner" in names:
        partner_store = CheckpointStore(
            os.path.join(directory, "checkpoints_partner"),
            compress=bool(sedar_cfg.ckpt_compress))
    return TieredCheckpointer(
        sched, device_slots=int(sedar_cfg.device_ring_slots),
        host_slots=int(sedar_cfg.host_ring_slots),
        disk_store=disk_store if "disk" in names else None,
        partner_store=partner_store, notify=notify)
