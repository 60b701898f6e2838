"""Per-stage trace spans in Chrome-trace / Perfetto JSON.

Spans cover the protected pipeline's host-visible stages — prefill pack,
decode tick, train step, deferred flush, validate, checkpoint (per tier),
rollback, restore plan — as "X" (complete) events. Load the output at
https://ui.perfetto.dev or chrome://tracing.

Timing uses `time.monotonic()` only: a span brackets work the host was
already blocking on, so tracing adds zero device syncs by construction.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class TraceRecorder:
    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.monotonic()
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str, cat: str = "sedar", **args):
        start = time.monotonic()
        try:
            yield
        finally:
            end = time.monotonic()
            ev = {
                "name": name,
                "cat": cat,
                "ph": "X",
                "ts": (start - self._t0) * 1e6,
                "dur": (end - start) * 1e6,
                "pid": 0,
                "tid": threading.get_ident() & 0xFFFF,
            }
            if args:
                ev["args"] = {k: _arg(v) for k, v in args.items()}
            with self._lock:
                self.events.append(ev)

    def write(self, path: str) -> None:
        with self._lock:
            doc = {"traceEvents": list(self.events),
                   "displayTimeUnit": "ms"}
        with open(path, "w") as fh:
            json.dump(doc, fh)

    def by_name(self, name: str) -> List[Dict[str, Any]]:
        with self._lock:
            return [e for e in self.events if e["name"] == name]


def _arg(v: Any) -> Any:
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)
