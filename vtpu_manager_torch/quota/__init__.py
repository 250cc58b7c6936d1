"""The quota market: a card's measured idle compute lent between tenants.

The port of the JAX package's `quota/` (`__init__.py`, `ledger.py`,
`market.py`, `victimcost.py`):

- workload classes (`latency-critical`, `throughput`) come from one pod
  annotation, which Allocate stamps into the tenant's config
  (`deviceplugin/vnum.py`, under QuotaMarket);
- `ledger` is the node's FileLock'd lease record, whose epoch the configs
  carry as `quota_epoch`;
- `market` is the device plugin's daemon that grants and revokes bounded,
  TTL'd leases against the utilization ledger's reclaimable headroom and
  rewrites the parties' configs, which the interposer adopts within a
  quantum (`csrc/shim/enforce_quota.cc`);
- `victimcost` is the per-tenant rollup of who holds a borrow lease and
  how much of its memory is in the host pool, which the scheduler's
  victim ordering reads (the scheduler is not ported).

With the gate off nothing is stamped, no ledger file is written, and the
configs carry zero lease fields.
"""

from __future__ import annotations

from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.quota.ledger import (QuotaLeaseLedger, STATE_EXPIRED,
                                             STATE_GRANTED, STATE_REVOKED,
                                             lease_is_active)
from vtpu_manager_torch.quota.market import (CLASS_TO_ABI, QuotaMarketManager,
                                             effective_core,
                                             sum_effective_by_chip)
from vtpu_manager_torch.util import consts, stalecodec

__all__ = [
    "QuotaLeaseLedger", "QuotaMarketManager", "CLASS_TO_ABI",
    "STATE_GRANTED", "STATE_REVOKED", "STATE_EXPIRED",
    "lease_is_active", "effective_core", "sum_effective_by_chip",
    "workload_class_of", "workload_class_abi", "parse_lease_summary",
]

# a lease summary older than this reads as no signal (the pressure and
# headroom staleness rule)
MAX_LEASE_SUMMARY_AGE_S = 120.0


def workload_class_of(pod: dict) -> str:
    """The pod's normalized workload class ("" = unclassified), from the
    webhook-stamped annotation only; an unnormalized value is ignored."""
    anns = (pod.get("metadata") or {}).get("annotations") or {}
    raw = anns.get(consts.workload_class_annotation(), "")
    return raw if raw in consts.WORKLOAD_CLASSES else ""


def workload_class_abi(cls: str) -> int:
    """Annotation value -> config ABI value (0 for unclassified)."""
    return CLASS_TO_ABI.get(cls, vc.WORKLOAD_CLASS_NONE)


def parse_lease_summary(raw: str | None, now: float | None = None,
                        max_age_s: float = MAX_LEASE_SUMMARY_AGE_S
                        ) -> dict[int, dict] | None:
    """The node lease summary (`chip:lent:count;...@ts`,
    `QuotaMarketManager.encode_annotation`) as
    `{chip: {"lent_core_pct": int, "leases": int}}`; None when absent,
    malformed or stale: a bad shape is no signal, never a wrong claim."""
    split = stalecodec.split_stamp(raw)
    if split is None:
        return None
    body, ts = split
    if not stalecodec.is_fresh(ts, now, max_age_s):
        return None
    out: dict[int, dict] = {}
    for seg in body.split(";"):
        if not seg:
            continue
        parts = seg.split(":")
        if len(parts) != 3:
            return None
        try:
            chip, lent, count = int(parts[0]), int(parts[1]), \
                int(parts[2])
        except (TypeError, ValueError):
            return None
        out[chip] = {"lent_core_pct": max(lent, 0),
                     "leases": max(count, 0)}
    return out
