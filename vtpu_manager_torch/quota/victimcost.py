"""The preemption victim-cost rollup: which tenants are cheap to evict.

The port of the JAX package's `quota/victimcost.py`, whole. Priority stays
the scheduler's first preemption key; among candidates of one priority two
node-local facts make a victim cheaper than its measured use alone says:

- lease state: a tenant holding an active borrow lease runs on capacity
  that is revocable and expiring by contract;
- spill residency: a tenant whose working set is mostly in the host pool
  (the memory ledger's `spilled` over resident plus spilled) has already
  lost its device locality, and evicting it frees the pressure that made
  it spill.

Both live in node-local files (the lease ledger, the memory ledger) the
scheduler cannot read, so the device plugin publishes a per-tenant rollup
as a node annotation:

    "<uid12>:<lease_flag>:<spill_frac>;...@<wall_ts>"

`uid12` is the pod uid's prefix (the victim join key), `lease_flag` `l` or
`-`, `spill_frac` a decimal in 0..1. It is stale by its timestamp like the
pressure and headroom codecs: a stale or absent rollup degrades the victim
order to the priority-only one.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass

from vtpu_manager_torch.util import consts, stalecodec

log = logging.getLogger(__name__)

MAX_VICTIM_COST_AGE_S = 120.0
FUTURE_SKEW_TOLERANCE_S = stalecodec.FUTURE_SKEW_TOLERANCE_S

UID_PREFIX_LEN = 12

# a node holds tens of tenants, and the parse runs per preemption
# candidate: the annotation stays bounded
MAX_TENANTS = 64
MAX_VC_LEN = 4096


@dataclass(frozen=True)
class NodeVictimCosts:
    """The decoded rollup: uid prefix -> (holds_lease, spill_frac)."""

    tenants: dict
    ts: float

    def encode(self) -> str:
        body = ";".join(
            f"{uid}:{'l' if leased else '-'}:{frac:.3f}"
            for uid, (leased, frac) in sorted(self.tenants.items()))
        return stalecodec.stamp(body, self.ts)

    def lookup(self, pod_uid: str) -> tuple[bool, float] | None:
        """(holds_lease, spill_frac) of a victim by its uid's prefix;
        None when it has no row (no signal: not cheaper)."""
        return self.tenants.get((pod_uid or "")[:UID_PREFIX_LEN])


def parse_victim_costs(raw: str | None, now: float | None = None,
                       max_age_s: float = MAX_VICTIM_COST_AGE_S
                       ) -> NodeVictimCosts | None:
    """The annotation decoded; None when absent, malformed or stale. A
    malformed row is skipped, never the rest."""
    split = stalecodec.split_stamp(raw, max_len=MAX_VC_LEN)
    if split is None:
        return None
    body, ts = split
    if not stalecodec.is_fresh(ts, now, max_age_s):
        return None
    tenants: dict = {}
    for seg in body.split(";"):
        if not seg:
            continue
        parts = seg.split(":")
        if len(parts) != 3:
            continue
        uid, flag, frac_raw = parts
        if not uid or flag not in ("l", "-"):
            continue
        try:
            frac = float(frac_raw)
        except (TypeError, ValueError):
            continue
        if not math.isfinite(frac):
            continue
        tenants[uid[:UID_PREFIX_LEN]] = (flag == "l",
                                         min(max(frac, 0.0), 1.0))
        if len(tenants) >= MAX_TENANTS:
            break
    return NodeVictimCosts(tenants=tenants, ts=ts)


def victim_costs_fresh(vc: "NodeVictimCosts | None",
                       now: float | None = None) -> bool:
    """Freshness judged again at use time (a cached parse outlives a dead
    publisher, which sends no more node events)."""
    if vc is None:
        return False
    return stalecodec.is_fresh(vc.ts, now, MAX_VICTIM_COST_AGE_S)


# --- collection, where the ledgers live (the device plugin) -----------------

def collect_victim_costs(base_dir: str, vmem_path: str | None = None,
                         include_leases: bool = True,
                         include_spill: bool = True,
                         now: float | None = None) -> NodeVictimCosts:
    """The node's lease ledger and memory ledger folded into one rollup.
    Either source may be off (its gate) or broken: a tenant then has no
    row or a partial one, and an absent row reads as not cheaper."""
    now = time.time() if now is None else now
    tenants: dict = {}

    def row(uid: str) -> list:
        key = uid[:UID_PREFIX_LEN]
        got = tenants.get(key)
        if got is None:
            got = [False, 0.0]
            tenants[key] = got
        return got

    if include_leases:
        try:
            from vtpu_manager_torch.quota.ledger import QuotaLeaseLedger
            ledger = QuotaLeaseLedger(base_dir)
            if ledger.exists():
                for lease in ledger.snapshot(now=now).active:
                    borrower = lease.get("borrower", "")
                    uid = borrower.partition("/")[0]
                    if uid:
                        row(uid)[0] = True
        except Exception:  # noqa: BLE001 - costs the lease column only
            log.warning("victim-cost lease fold failed", exc_info=True)

    if include_spill:
        try:
            from vtpu_manager_torch.config.tenantdirs import \
                iter_container_config_paths
            from vtpu_manager_torch.config.vmem import VmemLedger, fnv64
            # resident and spilled bytes per owner token, joined back to
            # pod uids through the one tenant-dir walk (one labelling, or
            # the joins drift apart)
            by_token: dict[int, list] = {}
            ledger = VmemLedger(vmem_path or consts.VMEM_NODE_CONFIG)
            try:
                for entry in ledger.entries():
                    tot = by_token.setdefault(entry.owner_token, [0, 0])
                    tot[0] += entry.bytes
                    tot[1] += entry.spilled
            finally:
                ledger.close()
            for pod_uid, label, _path, _dra in \
                    iter_container_config_paths(base_dir):
                tot = by_token.get(fnv64(f"{pod_uid}/{label}"))
                if tot is None:
                    continue
                resident, spilled = tot
                if resident + spilled <= 0:
                    continue
                frac = spilled / (resident + spilled)
                got = row(pod_uid)
                got[1] = max(got[1], frac)
        except Exception:  # noqa: BLE001 - the spill column degrades to
            # 0.0, never to a wrong eviction
            log.warning("victim-cost spill fold failed", exc_info=True)

    return NodeVictimCosts(
        tenants={k: (v[0], v[1]) for k, v in tenants.items()}, ts=now)


class VictimCostPublisher:
    """Collects the rollup and patches the node annotation every
    `interval_s`; a failed pass is logged, and the timestamp ages a dead
    publisher out."""

    def __init__(self, client, node_name: str, base_dir: str,
                 vmem_path: str | None = None,
                 include_leases: bool = True,
                 include_spill: bool = True,
                 policy=None, interval_s: float = 15.0):
        from vtpu_manager_torch.resilience.policy import RetryPolicy
        self.client = client
        self.node_name = node_name
        self.base_dir = base_dir
        self.vmem_path = vmem_path
        self.include_leases = include_leases
        self.include_spill = include_spill
        self.policy = policy or RetryPolicy(max_attempts=3,
                                            deadline_s=10.0)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def publish_once(self) -> NodeVictimCosts:
        vc = collect_victim_costs(
            self.base_dir, vmem_path=self.vmem_path,
            include_leases=self.include_leases,
            include_spill=self.include_spill)
        self.policy.run(
            lambda: self.client.patch_node_annotations(
                self.node_name,
                {consts.node_victim_cost_annotation(): vc.encode()}),
            op="victimcost.patch")
        return vc

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.publish_once()
                except Exception:  # noqa: BLE001 - an advisory signal
                    log.warning("victim-cost publish failed",
                                exc_info=True)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="vtpu-victimcost")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
