"""The reclaimable-headroom annotation: what a node's tenants leave unused.

The port of the JAX package's `utilization/headroom.py`, whole. The device
plugin publishes the ledger's per-chip rollup (`utilization/ledger.py
UtilizationLedger.headroom`) as a node annotation under the
UtilizationLedger gate:

    "[mix=<class>:<n>,...;]<idx>:<alloc_core>:<used_core>:<reclaim_core>:<reclaim_hbm>;...@<ts>"

one `;`-separated segment per chip, core fields in percent of one chip,
HBM in bytes, one wall-clock stamp for the whole rollup (the
`util/stalecodec.py` rules: a publisher that stops decays to no signal).
The leading `mix=` segment, present only when a tenant carries a workload
class, counts the resident tenants per class. The scheduler decodes the
annotation with the JAX package's copy of these rules, so the bytes must
not drift; the score terms are here so that both sides compute them alike.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from vtpu_manager_torch.util import stalecodec

# a rollup older than this is no signal
MAX_HEADROOM_AGE_S = 120.0

FUTURE_SKEW_TOLERANCE_S = stalecodec.FUTURE_SKEW_TOLERANCE_S


@dataclass(frozen=True)
class ChipHeadroom:
    alloc_core_pct: float      # sum of assigned core % on the chip
    used_core_pct: float       # EWMA of measured use (fresh tenants only)
    reclaim_core_pct: float    # burstiness-discounted reclaimable core %
    reclaim_hbm_bytes: int     # allocated-minus-high-water HBM


@dataclass(frozen=True)
class NodeHeadroom:
    chips: dict[int, ChipHeadroom] = field(default_factory=dict)
    ts: float = 0.0
    # resident tenants per workload-class key ("lat" / "thr" / "def")
    class_mix: dict[str, int] = field(default_factory=dict)

    def encode(self) -> str:
        segs = []
        if self.class_mix:
            # only when non-empty: a mix-less publisher's bytes are unchanged
            segs.append("mix=" + ",".join(
                f"{k}:{n}" for k, n in sorted(self.class_mix.items())))
        segs += [
            f"{idx}:{ch.alloc_core_pct:.1f}:{ch.used_core_pct:.1f}:"
            f"{ch.reclaim_core_pct:.1f}:{ch.reclaim_hbm_bytes}"
            for idx, ch in sorted(self.chips.items())]
        return stalecodec.stamp(";".join(segs), self.ts)

    def total_reclaim_core_pct(self) -> float:
        return sum(c.reclaim_core_pct for c in self.chips.values())


def parse_headroom(raw: str | None, now: float | None = None,
                   max_age_s: float = MAX_HEADROOM_AGE_S
                   ) -> NodeHeadroom | None:
    """The annotation decoded; None when absent, malformed or stale."""
    split = stalecodec.split_stamp(raw)
    if split is None:
        return None
    body, ts = split
    if not stalecodec.is_fresh(ts, now, max_age_s):
        return None
    chips: dict[int, ChipHeadroom] = {}
    class_mix: dict[str, int] = {}
    for seg in body.split(";"):
        if not seg:
            continue
        if seg.startswith("mix="):
            # garbage inside the mix invalidates the whole rollup
            for pair in seg[4:].split(","):
                key, _, n_raw = pair.partition(":")
                try:
                    class_mix[key] = max(int(n_raw), 0)
                except (TypeError, ValueError):
                    return None
            continue
        parts = seg.split(":")
        if len(parts) != 5:
            return None
        try:
            idx = int(parts[0])
            alloc, used, reclaim = (float(parts[1]), float(parts[2]),
                                    float(parts[3]))
            hbm = int(parts[4])
        except (TypeError, ValueError):
            return None
        if not all(math.isfinite(v) for v in (alloc, used, reclaim)):
            return None
        chips[idx] = ChipHeadroom(
            alloc_core_pct=max(alloc, 0.0),
            used_core_pct=max(used, 0.0),
            reclaim_core_pct=min(max(reclaim, 0.0), 100.0 * 64),
            reclaim_hbm_bytes=max(hbm, 0))
    return NodeHeadroom(chips=chips, ts=ts, class_mix=class_mix)


def headroom_is_fresh(hr: "NodeHeadroom | None",
                      now: float | None = None) -> bool:
    """Freshness judged again where a cached rollup is used: a dead
    publisher sends no further event to expire it."""
    if hr is None:
        return False
    return stalecodec.is_fresh(hr.ts, now, MAX_HEADROOM_AGE_S)


def headroom_score_input(hr: "NodeHeadroom | None",
                         now: float | None = None) -> float:
    """The node's total reclaimable core %, 0 when stale or absent: the
    scheduler's observed score input."""
    if hr is None:
        return 0.0
    if not stalecodec.is_fresh(hr.ts, now, MAX_HEADROOM_AGE_S):
        return 0.0
    return hr.total_reclaim_core_pct()


# below the pressure penalty's 50 and the gang bonus's 100
HEADROOM_TERM_CAP = 50.0


def headroom_score_term(hr: "NodeHeadroom | None",
                        now: float | None = None) -> float:
    """The score term under QuotaMarket: the input, capped."""
    return min(headroom_score_input(hr, now), HEADROOM_TERM_CAP)


def headroom_term_from_input(score_input: float) -> float:
    """The same cap applied to a recorded input."""
    return min(max(score_input, 0.0), HEADROOM_TERM_CAP)


# a lender-class resident is worth 5, at most 15
MIX_TERM_PER_LENDER = 5.0
MIX_TERM_CAP = 15.0

# the lender class's key in the mix segment (overcommit/ratio.py)
_LENDER_MIX_KEY = "thr"


def class_mix_term(hr: "NodeHeadroom | None",
                   now: float | None = None) -> float:
    """The class-mix term for a latency-critical pod: 5 per throughput
    (lender) resident, capped; 0 for a stale, absent or mix-less rollup."""
    if hr is None or not headroom_is_fresh(hr, now):
        return 0.0
    lenders = hr.class_mix.get(_LENDER_MIX_KEY, 0)
    if lenders <= 0:
        return 0.0
    return min(lenders * MIX_TERM_PER_LENDER, MIX_TERM_CAP)
