"""Structured fault journal: one JSONL line per reliability event.

Every `DetectionEvent`, recovery record, tier fallback, heartbeat anomaly,
and request rejection becomes one append — monotonic timestamp, sequence
number, step, slot/request id, backend, boundary — so a completed run can
be REPLAYED: the scenario runner loads the journal and asserts
predicted-vs-observed the way the paper's Section-7 model does, and
`obs.kpi` computes MTTD/MTTR/availability from the same stream.

Canonical form: `canonical(obj)` is the byte-for-byte comparison contract
between the engine's in-memory records and their journaled copies. Both
sides pass through `_jsonable` (numpy scalars → Python scalars, dict keys →
str) before `json.dumps(sort_keys=True)`, so a record that survived a JSON
round trip compares equal to one that never left memory.

The journal is host-side only (list append + optional file write); it never
touches a device buffer — see the zero-extra-hostsync argument in
DESIGN.md §15. A torch tensor in a record raises `TypeError`: reading it
(`.item()`, `.tolist()`, even `str()`) would sync the device, so the engine
must hand over host values it already read.
"""
from __future__ import annotations

import atexit
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch


def _jsonable(obj: Any) -> Any:
    """Normalize to what json.dumps emits and json.loads returns."""
    if isinstance(obj, torch.Tensor):
        raise TypeError(
            f"telemetry record holds a torch tensor ({obj.dtype}, "
            f"{obj.device.type}): reading it would sync the device; pass "
            f"the host value the engine already read")
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return _jsonable(obj.tolist())
    if obj is None or isinstance(obj, str):
        return obj
    return str(obj)


def canonical(obj: Any) -> bytes:
    """Canonical bytes of a record — the predicted-vs-observed comparator."""
    return json.dumps(_jsonable(obj), sort_keys=True).encode()


def event_to_record(event: Any) -> Dict[str, Any]:
    """Project a DetectionEvent onto its journal payload."""
    return {
        "step": event.step,
        "boundary": event.boundary,
        "effect": event.effect,
        "detail": dict(event.detail),
    }


class FaultJournal:
    """Append-only reliability event log (in-memory + optional JSONL file).

    Each record carries `kind`, a monotonic offset `t_mono` (seconds since
    the journal was opened) and a sequence number `seq`; everything else is
    caller fields. When `path` is given every append is streamed as one
    JSONL line (flushed, so a crashed run keeps its tail).

    Durability + bounded growth (DESIGN.md §17):

      * ``fsync_every=N`` forces the line to disk every N appends (0 =
        never fsync — the OS page cache decides). A kill -9 loses at most
        the last unsynced batch; ``synced_seq`` names the last sequence
        number guaranteed on disk.
      * an atexit hook flushes+fsyncs whatever is buffered on clean
        interpreter exit, so only a hard crash can drop the tail.
      * ``max_bytes=B`` rotates ``journal.jsonl`` → ``journal.jsonl.1``
        when the active file exceeds B (one generation — campaigns are
        bounded); ``load()`` reads across the rotation so ``reconcile()``
        still sees the whole stream.
    """

    def __init__(self, path: Optional[str] = None, *,
                 fsync_every: int = 0, max_bytes: int = 0):
        self.path = path
        self.entries: List[Dict[str, Any]] = []
        self.fsync_every = int(fsync_every)
        self.max_bytes = int(max_bytes)
        self.synced_seq = -1
        self._since_sync = 0
        self._t0 = time.monotonic()
        self._fh = open(path, "w") if path else None
        self._atexit = None
        if self._fh is not None:
            self._atexit = self.sync
            atexit.register(self._atexit)

    def append(self, kind: str, **fields) -> Dict[str, Any]:
        rec = {"kind": kind, "seq": len(self.entries),
               "t_mono": time.monotonic() - self._t0}
        rec.update(fields)
        rec = _jsonable(rec)
        self.entries.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
            self._fh.flush()
            self._since_sync += 1
            if self.fsync_every > 0 and self._since_sync >= self.fsync_every:
                self.sync()
            if self.max_bytes > 0 and self._fh.tell() >= self.max_bytes:
                self._rotate()
        return rec

    def sync(self) -> None:
        """Flush + fsync: everything appended so far is now on disk."""
        if self._fh is None:
            return
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self.synced_seq = len(self.entries) - 1
        self._since_sync = 0

    def _rotate(self) -> None:
        self.sync()
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "w")

    def records(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        if kind is None:
            return list(self.entries)
        return [r for r in self.entries if r["kind"] == kind]

    def close(self) -> None:
        if self._fh is not None:
            self.sync()
            self._fh.close()
            self._fh = None
        if self._atexit is not None:
            atexit.unregister(self._atexit)
            self._atexit = None

    @staticmethod
    def load(path: str) -> List[Dict[str, Any]]:
        """Read a journal back, rotated generation first; a torn final
        line (crash mid-write) is skipped rather than raised."""
        out: List[Dict[str, Any]] = []
        for p in (path + ".1", path):
            if not os.path.exists(p):
                continue
            with open(p) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        return out


def payloads(records: Iterable[Dict[str, Any]], kind: str,
             field: str) -> List[Dict[str, Any]]:
    """Extract the embedded engine records of one kind (e.g. the
    `event`/`record` field of detection/recovery lines), journal framing
    stripped."""
    return [r[field] for r in records if r.get("kind") == kind]


def replay(records: Iterable[Dict[str, Any]]) -> Dict[str, List[Dict]]:
    """Group a loaded journal by kind — the scenario runner's view."""
    out: Dict[str, List[Dict]] = {}
    for r in records:
        out.setdefault(r.get("kind", "?"), []).append(r)
    return out


def reconcile(records: Iterable[Dict[str, Any]], detections: Iterable[Any],
              recoveries: Iterable[Dict[str, Any]],
              alerts: Optional[Iterable[Dict[str, Any]]] = None,
              reconfigs: Optional[Iterable[Dict[str, Any]]] = None,
              ) -> Dict[str, bool]:
    """Byte-for-byte check: does the journal reproduce the engine's
    detection/recovery sequences exactly? `detections` are DetectionEvents
    (projected via event_to_record); `recoveries` are the engine's record
    dicts. Passing `alerts` (AlertManager.records) and/or `reconfigs`
    (SedarEngine.reconfigs) extends the same contract to the control
    loop — the corresponding `*_match` keys only appear when provided."""
    recs = list(records)
    j_det = [canonical(p) for p in payloads(recs, "detection", "event")]
    j_rec = [canonical(p) for p in payloads(recs, "recovery", "record")]
    e_det = [canonical(event_to_record(e)) for e in detections]
    e_rec = [canonical(r) for r in recoveries]
    out = {
        "detections_match": j_det == e_det,
        "recoveries_match": j_rec == e_rec,
    }
    if alerts is not None:
        j_al = [canonical(p) for p in payloads(recs, "alert", "record")]
        out["alerts_match"] = j_al == [canonical(a) for a in alerts]
    if reconfigs is not None:
        j_rc = [canonical(p) for p in payloads(recs, "reconfig", "record")]
        out["reconfigs_match"] = j_rc == [canonical(r) for r in reconfigs]
    return out
