"""Span spools: the records the node exporter reads, and their reaping.

The port of the read side of the JAX package's `trace/recorder.py`: the
`Span` record with its JSONL wire form, and `reap_stale_spools`, which the
exporter calls before each read. A tracing process appends spans to
`<service>.<pid>.jsonl` under the trace dir, with `meta` lines that carry
its cumulative drop count; the writer (`SpanRecorder`) is not ported yet.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

SPOOL_SUFFIX = ".jsonl"
# a spool untouched this long belongs to a dead process (a live recorder
# stamps its meta line at least every flush interval)
DEFAULT_SPOOL_TTL_S = 24 * 3600.0


@dataclass
class Span:
    """One timed stage of a pod's allocation path."""

    stage: str                 # e.g. "scheduler.filter"
    trace_id: str = ""
    pod_uid: str = ""
    service: str = ""          # emitting process ("scheduler", "plugin"...)
    start_s: float = 0.0       # wall clock (cross-process join axis)
    dur_s: float = 0.0
    attrs: dict = field(default_factory=dict)

    def to_wire(self) -> dict:
        out = {"kind": "span", "stage": self.stage, "trace": self.trace_id,
               "pod": self.pod_uid, "service": self.service,
               "start": round(self.start_s, 6), "dur": round(self.dur_s, 6)}
        if self.attrs:
            out["attrs"] = self.attrs
        return out

    @classmethod
    def from_wire(cls, doc: dict) -> "Span":
        return cls(stage=str(doc.get("stage", "")),
                   trace_id=str(doc.get("trace", "")),
                   pod_uid=str(doc.get("pod", "")),
                   service=str(doc.get("service", "")),
                   start_s=float(doc.get("start", 0.0)),
                   dur_s=float(doc.get("dur", 0.0)),
                   attrs=dict(doc.get("attrs") or {}))


def reap_stale_spools(spool_dir: str,
                      max_age_s: float = DEFAULT_SPOOL_TTL_S) -> int:
    """Delete spools (and their flocks) untouched for ``max_age_s`` —
    leftovers of dead processes. Called by the monitor before reads;
    returns files removed. Live spools are safe: their recorder re-stamps
    mtime on every flush."""
    removed = 0
    if not os.path.isdir(spool_dir):
        return removed
    cutoff = time.time() - max_age_s
    for name in os.listdir(spool_dir):
        if not (name.endswith(SPOOL_SUFFIX)
                or name.endswith(f"{SPOOL_SUFFIX}.flock")):
            continue
        path = os.path.join(spool_dir, name)
        try:
            if os.path.getmtime(path) < cutoff:
                os.unlink(path)
                removed += 1
        except OSError:
            continue
    return removed
