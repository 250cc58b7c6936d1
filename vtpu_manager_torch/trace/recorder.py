"""Span spools: the span record, the recorder that writes a process's
spool, and the reaping of dead processes' spools.

The port of the JAX package's `trace/recorder.py`. Recording is in two
phases, so that an instrumented path (Allocate holds kubelet's attention)
never pays for disk I/O:

- `record()` appends to a bounded in-memory ring under a lock held only
  for the append, and at half capacity only wakes the flusher: it never
  writes. A full ring drops the span and counts it;
- `flush()`, run by the flusher thread that `trace.configure` starts and
  at exit, takes the ring's contents under that lock and appends them as
  JSONL to `<service>.<pid>.jsonl` under the trace dir, under the spool's
  flock, with a `meta` line that carries the process's cumulative drop
  count (the exporter's `vtpu_trace_spool_dropped_total`). A spool that
  cannot be written turns its spans into drops; nothing raises.

A spool that reaches `max_spool_bytes` is rotated to one
`<service>.<pid>.prev.jsonl` generation, which assembly still reads; spools
untouched for a day are reaped by `reap_stale_spools`, which the exporter
calls before each read.

A flush fires the `trace.spool_flush` failpoint before the spool's I/O
(arm it with `exc=OSError` and the spans become drops).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field

from vtpu_manager_torch.resilience import failpoints
from vtpu_manager_torch.util.flock import FileLock

SPOOL_SUFFIX = ".jsonl"
DEFAULT_CAPACITY = 512
DEFAULT_MAX_SPOOL_BYTES = 16 * 2**20
DEFAULT_FLUSH_INTERVAL_S = 1.0
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


class SpanRecorder:
    def __init__(self, service: str, spool_dir: str,
                 capacity: int = DEFAULT_CAPACITY,
                 flush_at: int | None = None,
                 max_spool_bytes: int = DEFAULT_MAX_SPOOL_BYTES):
        self.service = service
        self.spool_dir = spool_dir
        self.capacity = max(1, capacity)
        self.max_spool_bytes = max_spool_bytes
        self.spool_path = os.path.join(
            spool_dir, f"{service}.{os.getpid()}{SPOOL_SUFFIX}")
        self._lock = threading.Lock()
        self._buf: list[Span] = []
        self._dropped = 0
        self._flushed_drops = -1   # the drop count last written
        # the flusher is woken at half capacity, so a burst does not reach
        # the drop path before the interval's tick; above the capacity it
        # is never woken early
        self._flush_at = flush_at if flush_at is not None \
            else max(1, self.capacity // 2)
        self._wake = threading.Event()
        self._stop = False

    def record(self, span: Span) -> bool:
        """Appends to the ring; False, and one more drop, when it is full.
        Never writes: a ring at the threshold only wakes the flusher."""
        span.service = span.service or self.service
        with self._lock:
            if len(self._buf) >= self.capacity:
                self._dropped += 1
                return False
            self._buf.append(span)
            pending = len(self._buf)
        if pending >= self._flush_at:
            self._wake.set()
        return True

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def pending(self) -> int:
        with self._lock:
            return len(self._buf)

    def flush(self) -> int:
        """Drains the ring to the spool; returns the spans written. The
        ring's lock covers only taking the spans, the file I/O runs under
        the spool's flock alone."""
        with self._lock:
            spans = self._buf
            self._buf = []
            drops = self._dropped
        if not spans and drops == self._flushed_drops:
            return 0
        lines = [json.dumps(s.to_wire(), separators=(",", ":"))
                 for s in spans]
        lines.append(json.dumps(
            {"kind": "meta", "service": self.service, "pid": os.getpid(),
             "drops": drops, "ts": round(time.time(), 3)},
            separators=(",", ":")))
        try:
            failpoints.fire("trace.spool_flush", path=self.spool_path)
            os.makedirs(self.spool_dir, exist_ok=True)
            with FileLock(f"{self.spool_path}.flock"):
                self._rotate_if_large()
                with open(self.spool_path, "a") as f:
                    f.write("\n".join(lines) + "\n")
        except OSError:
            # the spans are lost: counted as drops, so the loss shows on
            # the exporter rather than nowhere
            with self._lock:
                self._dropped += len(spans)
            return 0
        self._flushed_drops = drops
        return len(spans)

    def _rotate_if_large(self) -> None:
        """Rotates the spool to its one `.prev` generation once it reaches
        max_spool_bytes (the caller holds the spool's flock)."""
        try:
            size = os.path.getsize(self.spool_path)
        except OSError:
            return
        if size < self.max_spool_bytes:
            return
        prev = self.spool_path[:-len(SPOOL_SUFFIX)] + f".prev{SPOOL_SUFFIX}"
        os.replace(self.spool_path, prev)

    def run_flusher(self,
                    interval_s: float = DEFAULT_FLUSH_INTERVAL_S) -> None:
        """The flush loop: every `interval_s`, or at once when record()
        wakes it; after stop_flusher() it flushes once more and returns."""
        while not self._stop:
            self._wake.wait(interval_s)
            self._wake.clear()
            self.flush()

    def stop_flusher(self) -> None:
        self._stop = True
        self._wake.set()


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
