"""The node-overcommit annotation: per-class memory ratios and the spill
signal, stamped for staleness.

The port of the JAX package's `overcommit/ratio.py` without
`virtual_registry`, which is the scheduler's:

    "<class>:<ratio>;...|<spill_frac>:<spilled_bytes>@<wall_ts>"

one `;`-separated segment per workload class (`lat`, `thr`, `def` for an
unclassified tenant), each ratio a decimal >= 1.0, then the fraction of
recent steps that paid a spill or fill and the live bytes in the node's
host pool. The scheduler decodes what the port's publisher writes with the
JAX copy of these rules (`tests/test_torch_overcommit.py`), so the bytes
must not drift. A stale or malformed annotation is no signal: ratio 1.0
and no spill penalty, never a claim nobody measures any more.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from vtpu_manager_torch.util import consts, stalecodec

# a rollup older than this reads as no signal (ratio 1.0)
MAX_OVERCOMMIT_AGE_S = 120.0
# no ratio, however unanimous its evidence, oversells a device more
MAX_RATIO = 4.0
# score points a node loses when every recent step paid a spill or fill
SPILL_SCORE_WEIGHT = 50.0

# wire keys per workload class; "def" covers unclassified tenants
CLASS_KEYS = {
    consts.WORKLOAD_CLASS_LATENCY_CRITICAL: "lat",
    consts.WORKLOAD_CLASS_THROUGHPUT: "thr",
    "": "def",
}


@dataclass(frozen=True)
class NodeOvercommit:
    ratios: dict[str, float] = field(default_factory=dict)  # key -> ratio
    spill_frac: float = 0.0        # fraction of recent steps spilling
    spilled_bytes: int = 0         # live host-pool footprint
    ts: float = 0.0

    def encode(self) -> str:
        body = ";".join(f"{k}:{r:.2f}"
                        for k, r in sorted(self.ratios.items()))
        return stalecodec.stamp(
            f"{body}|{self.spill_frac:.4f}:{self.spilled_bytes}", self.ts)

    def max_ratio(self) -> float:
        """The widest class's ratio (the rollup's VIRT column)."""
        return max(self.ratios.values(), default=1.0)


def parse_overcommit(raw: str | None, now: float | None = None,
                     max_age_s: float = MAX_OVERCOMMIT_AGE_S
                     ) -> NodeOvercommit | None:
    """The decoded annotation; None when absent, malformed or stale."""
    split = stalecodec.split_stamp(raw)
    if split is None:
        return None
    body, ts = split
    if not stalecodec.is_fresh(ts, now, max_age_s):
        return None
    classes, sep, spill_raw = body.rpartition("|")
    if not sep:
        return None
    frac_raw, _, bytes_raw = spill_raw.partition(":")
    try:
        spill_frac = float(frac_raw)
        spilled_bytes = int(bytes_raw)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(spill_frac):
        return None
    ratios: dict[str, float] = {}
    for seg in classes.split(";"):
        if not seg:
            continue
        key, _, ratio_raw = seg.partition(":")
        try:
            ratio = float(ratio_raw)
        except (TypeError, ValueError):
            return None
        if not math.isfinite(ratio):
            return None
        ratios[key] = min(max(ratio, 1.0), MAX_RATIO)
    return NodeOvercommit(ratios=ratios,
                          spill_frac=min(max(spill_frac, 0.0), 1.0),
                          spilled_bytes=max(spilled_bytes, 0), ts=ts)


def _fresh(oc: NodeOvercommit | None, now: float | None) -> bool:
    return oc is not None and stalecodec.is_fresh(oc.ts, now,
                                                  MAX_OVERCOMMIT_AGE_S)


def ratio_for_class(oc: NodeOvercommit | None, workload_class: str,
                    now: float | None = None) -> float:
    """The admission ratio for a pod's workload class. Staleness is judged
    again here: a cached rollup whose publisher died must decay to 1.0."""
    if not _fresh(oc, now):
        return 1.0
    key = CLASS_KEYS.get(workload_class, "def")
    ratio = oc.ratios.get(key)
    if ratio is None:
        ratio = oc.ratios.get("def", 1.0)
    return min(max(ratio, 1.0), MAX_RATIO)


def spill_penalty(oc: NodeOvercommit | None,
                  now: float | None = None) -> float:
    """Score points to subtract for a node's live spill activity; a stale
    signal is 0.0."""
    if not _fresh(oc, now):
        return 0.0
    return SPILL_SCORE_WEIGHT * oc.spill_frac
