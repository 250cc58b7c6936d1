"""Span spools -> per-pod allocation timelines, for the exporter's /traces.

The port of the JAX package's `trace/assemble.py`. Each process spools its
own spans; assembly is the read-side join. Spans with a trace id join by
it; spans with only a pod uid (DRA prepare, the registry) join through the
uid <-> trace mapping the others establish. Each pod gets one timeline,
its spans ordered by wall-clock start, the canonical stage order breaking
ties. Durations are perf_counter deltas, immune to clock steps.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from vtpu_manager_torch.trace.recorder import SPOOL_SUFFIX, Span

# Canonical allocation-path order: admission -> scheduling -> node
# preparation -> tenant startup. Used for tie-breaking and for naming
# the expected next hop when the CLI flags a gap.
STAGE_ORDER = (
    "webhook.mutate",
    "scheduler.filter",
    "scheduler.gang",
    "scheduler.preempt",
    "scheduler.bind",
    "plugin.allocate",
    "plugin.config",
    "dra.prepare",
    "dra.cdi",
    "registry.register",
    "shim.install",
    "shim.register",
    "shim.first_execute",
)

_STAGE_RANK = {s: i for i, s in enumerate(STAGE_ORDER)}


@dataclass
class Timeline:
    pod_uid: str = ""
    trace_id: str = ""
    spans: list[Span] = field(default_factory=list)

    def key(self) -> str:
        return self.pod_uid or self.trace_id

    def sort(self) -> None:
        self.spans.sort(key=lambda s: (s.start_s,
                                       _STAGE_RANK.get(s.stage, 99)))

    def total_s(self) -> float:
        """First-start to last-end across the assembled path."""
        if not self.spans:
            return 0.0
        start = min(s.start_s for s in self.spans)
        end = max(s.start_s + s.dur_s for s in self.spans)
        return end - start

    def stages(self) -> set[str]:
        return {s.stage for s in self.spans}

    def to_wire(self) -> dict:
        return {"pod_uid": self.pod_uid, "trace_id": self.trace_id,
                "total_s": round(self.total_s(), 6),
                "spans": [s.to_wire() for s in self.spans]}


def read_spools(spool_dir: str) -> tuple[list[Span],
                                         dict[tuple[str, int], int]]:
    """(spans, cumulative drops per (service, pid)). Unparseable lines
    (a spooling process killed mid-write before the flock protocol was
    in force, operator edits) are skipped, not fatal — the read side
    must degrade to a partial timeline, never to no timeline."""
    spans: list[Span] = []
    drops: dict[tuple[str, int], int] = {}
    if not os.path.isdir(spool_dir):
        return spans, drops
    for name in sorted(os.listdir(spool_dir)):
        if not name.endswith(SPOOL_SUFFIX):
            continue
        try:
            with open(os.path.join(spool_dir, name)) as f:
                raw = f.read()
        except OSError:
            continue
        for line in raw.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if not isinstance(doc, dict):
                continue
            if doc.get("kind") == "meta":
                key = (str(doc.get("service", "")),
                       int(doc.get("pid", 0) or 0))
                # drops are cumulative per process: keep the newest count
                drops[key] = max(drops.get(key, 0),
                                 int(doc.get("drops", 0) or 0))
            elif doc.get("kind") == "span":
                spans.append(Span.from_wire(doc))
    return spans, drops


def assemble(spans: list[Span]) -> dict[str, Timeline]:
    """Join spans into per-pod timelines, keyed by pod uid (or trace id
    for spans whose pod uid never became known)."""
    uid_by_trace: dict[str, str] = {}
    trace_by_uid: dict[str, str] = {}
    for s in spans:
        if s.trace_id and s.pod_uid:
            uid_by_trace.setdefault(s.trace_id, s.pod_uid)
            trace_by_uid.setdefault(s.pod_uid, s.trace_id)
    out: dict[str, Timeline] = {}
    for s in spans:
        uid = s.pod_uid or uid_by_trace.get(s.trace_id, "")
        key = uid or s.trace_id
        if not key:
            continue
        tl = out.get(key)
        if tl is None:
            tl = out[key] = Timeline(pod_uid=uid)
        tl.trace_id = (tl.trace_id or s.trace_id
                       or trace_by_uid.get(uid, ""))
        tl.pod_uid = tl.pod_uid or uid
        tl.spans.append(s)
    for tl in out.values():
        tl.sort()
    return out


def find_timeline(timelines: dict[str, Timeline],
                  key: str) -> Timeline | None:
    """Lookup by assembly key (pod uid) OR by trace id — an operator may
    hold either (the uid from kubectl, the trace id from an annotation
    or a spool line), and a timeline with any uid-bearing span is keyed
    by the uid even when the caller has the trace id."""
    tl = timelines.get(key)
    if tl is not None:
        return tl
    for tl in timelines.values():
        if tl.trace_id == key:
            return tl
    return None


def critical_path(tl: Timeline) -> list[dict]:
    """Per-stage rows with offsets and inter-stage gaps: where the
    admission-to-running time actually went. The gap before a stage is
    time attributed to NO instrumented stage (queueing, kubelet work,
    watch lag) — often the real finding."""
    rows: list[dict] = []
    if not tl.spans:
        return rows
    origin = min(s.start_s for s in tl.spans)
    prev_end = origin
    for s in tl.spans:
        rows.append({
            "stage": s.stage,
            "service": s.service,
            "offset_s": round(s.start_s - origin, 6),
            "dur_s": round(s.dur_s, 6),
            "gap_s": round(max(0.0, s.start_s - prev_end), 6),
            "attrs": s.attrs,
        })
        prev_end = max(prev_end, s.start_s + s.dur_s)
    return rows


def stage_durations(spans: list[Span]) -> dict[str, list[float]]:
    out: dict[str, list[float]] = {}
    for s in spans:
        out.setdefault(s.stage, []).append(s.dur_s)
    return out


def _median(values: list[float]) -> float:
    ordered = sorted(values)
    mid = len(ordered) // 2
    if len(ordered) % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2.0


def outliers(spans: list[Span], factor: float = 3.0,
             floor_s: float = 0.001) -> list[dict]:
    """Spans whose duration exceeds ``factor``x their stage's median
    (and an absolute floor, so microsecond jitter on fast stages never
    alarms). The per-stage population is the fleet baseline; a single
    sample can't be its own outlier."""
    by_stage = stage_durations(spans)
    medians = {stage: _median(durs) for stage, durs in by_stage.items()
               if len(durs) >= 2}
    out = []
    for s in spans:
        med = medians.get(s.stage)
        if med is None:
            continue
        if s.dur_s >= floor_s and s.dur_s > factor * med:
            out.append({"stage": s.stage, "pod_uid": s.pod_uid,
                        "trace_id": s.trace_id,
                        "dur_s": round(s.dur_s, 6),
                        "median_s": round(med, 6),
                        "factor": round(s.dur_s / med, 1) if med else 0.0})
    out.sort(key=lambda r: r["dur_s"], reverse=True)
    return out
