"""The node's quota market: it lends a card's idle compute between tenants.

The port of the JAX package's `quota/market.py`, whole. It runs in the
device plugin under QuotaMarket (`cmd/device_plugin.start_market`). Each
pass:

1. folds a utilization ledger of its own (`utilization/ledger.py`; the
   headroom publisher and the overcommit policy keep theirs, so no two
   consumers share one fold's cursors);
2. expires granted leases past their TTL;
3. revokes the leases whose lender needs its quota back (its measured
   envelope climbing into the lent range), whose lender's signal went
   stale (a lease never outlives the evidence it was granted on), or
   whose parties' configs are gone;
4. grants bounded, TTL'd steps of a throughput tenant's
   confidence-gated reclaimable headroom to throttle-bound
   latency-critical tenants on the same card;
5. reconciles every tenant's `vtpu.config` to the ledger's active deltas,
   the one writer for grant, revoke, expiry and recovery alike:
   `lease_core` per (tenant, card) from the ledger, `quota_epoch` the
   ledger's epoch, tmp + rename as Allocate writes it. The interposer's
   quota tick re-reads the config within a quantum and adopts it
   (`csrc/shim/enforce_quota.cc`), and a revoke clamps its tokens;
6. publishes a per-card lease summary annotation (the /utilization
   fan-in's remote view) and records each grant, revoke and expiry in
   both parties' trace timelines (`quota.grant`, `quota.revoke`,
   `quota.expire`).

The conservation rule: for every card, the sum over resident tenants of
`clamp(hard_core + lease_core, 0, 100)` never exceeds 100. A lease moves
quota, it never makes it; the reconcile re-derives every delta from the
ledger before it writes, and revokes every lease of a card whose desired
sum would pass 100.

The JAX `_audit` also hands each record to the decision-explain spool
(`explain.record_raw`). The port has no DecisionExplain; with no
recorder configured the JAX call records nothing either
(`vtpu_manager/explain/__init__.py:107-110`), so that leg is left out
until the explain plane is ported.
"""

from __future__ import annotations

import logging
import math
import threading
import time

from vtpu_manager_torch import trace
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.config.tenantdirs import iter_container_config_paths
from vtpu_manager_torch.quota.ledger import (QuotaLeaseLedger, STATE_EXPIRED,
                                             STATE_GRANTED, STATE_REVOKED)
from vtpu_manager_torch.resilience import failpoints
from vtpu_manager_torch.util import consts, stalecodec

log = logging.getLogger(__name__)

# class annotation value -> config ABI value
CLASS_TO_ABI = {
    consts.WORKLOAD_CLASS_LATENCY_CRITICAL: vc.WORKLOAD_CLASS_LATENCY,
    consts.WORKLOAD_CLASS_THROUGHPUT: vc.WORKLOAD_CLASS_THROUGHPUT,
}

# how close (core %) the lender's envelope may come to its retained rate
# before its lease is reclaimed
REVOKE_MARGIN_PCT = 2.0
# headroom a grant leaves above the revoke margin, so a new lease is not
# born inside its own revoke band (without it a lender at the edge would
# lend and reclaim every pass)
GRANT_HEADROOM_PCT = 5.0

# the borrowed-vs-used verdict that scales the next grant's step: a
# borrower using at least WELL_USED of what it borrowed gets a doubled
# step (toward max_borrow), one using less than UNUSED a halved step and
# a halved TTL; in between the step holds. Only how much is offered
# moves, never whether offering is safe.
WELL_USED_UTILIZATION = 0.6
UNUSED_UTILIZATION = 0.2


def borrowed_used_verdict(used_pct, base_alloc_pct, borrowed_pct):
    """The used share of what was borrowed, clamp(used - base_alloc, 0,
    borrowed) core %; None when it cannot be judged (no live signal,
    nothing borrowed). The one formula of the rollup's `borrowed_used`
    rows and the grant step."""
    if used_pct is None or base_alloc_pct is None:
        return None
    borrowed = float(borrowed_pct)
    if borrowed <= 0:
        return None
    return min(max(float(used_pct) - float(base_alloc_pct), 0.0),
               borrowed)


def scaled_grant_step(prev_step: int, base_step: int, max_borrow: int,
                      used_pct, base_alloc_pct, borrowed_pct
                      ) -> tuple[int, float]:
    """(the next step %, the TTL's factor) from the borrowed-vs-used
    verdict. `prev_step` is the borrower's current step (`base_step`
    without history); no verdict resets to the base step and the whole
    TTL."""
    used_of = borrowed_used_verdict(used_pct, base_alloc_pct,
                                    borrowed_pct)
    if used_of is None:
        return base_step, 1.0
    utilization = used_of / float(borrowed_pct)
    if utilization >= WELL_USED_UTILIZATION:
        return min(max(prev_step * 2, 1), max_borrow), 1.0
    if utilization < UNUSED_UTILIZATION:
        return max(prev_step // 2, 1), 0.5
    return prev_step, 1.0


def effective_core(hard: int, lease: int) -> int:
    """The compute percent under a lease, clamp(hard + lease, 0, 100)
    (the interposer's `EffectiveCorePct`)."""
    return max(0, min(100, int(hard) + int(lease)))


def sum_effective_by_chip(base_dir: str) -> dict[int, int]:
    """Per card, the sum of the effective percents the configs on disk
    carry: the conservation rule's ground truth, read off the files the
    interposers read."""
    out: dict[int, int] = {}
    for _uid, _label, path, _is_dra in \
            iter_container_config_paths(base_dir):
        try:
            cfg = vc.read_config(path)
        except (OSError, ValueError):
            continue
        for dev in cfg.devices:
            out[dev.host_index] = out.get(dev.host_index, 0) + \
                effective_core(dev.hard_core, dev.lease_core)
    return out


class _Tenant:
    """One (pod_uid, container label) partition's config."""

    __slots__ = ("key", "path", "cfg", "by_chip")

    def __init__(self, key: str, path: str, cfg: vc.VtpuConfig):
        self.key = key
        self.path = path
        self.cfg = cfg
        self.by_chip = {d.host_index: d for d in cfg.devices}


class QuotaMarketManager:
    def __init__(self, node_name: str, base_dir: str, util_ledger,
                 client=None, policy=None, interval_s: float = 5.0,
                 grant_step_pct: int = 10, max_borrow_pct: int = 40,
                 lease_ttl_s: float = 30.0, min_retain_pct: int = 5,
                 wait_frac_threshold: float = 0.2,
                 revoke_confidence: float = 0.35,
                 clock=time.time):
        from vtpu_manager_torch.resilience.policy import RetryPolicy
        self.node_name = node_name
        self.base_dir = base_dir
        self.util = util_ledger
        self.client = client
        self.policy = policy or RetryPolicy(max_attempts=3,
                                            deadline_s=10.0)
        self.interval_s = interval_s
        self.grant_step_pct = grant_step_pct
        self.max_borrow_pct = max_borrow_pct
        self.lease_ttl_s = lease_ttl_s
        self.min_retain_pct = min_retain_pct
        self.wait_frac_threshold = wait_frac_threshold
        self.revoke_confidence = revoke_confidence
        self.clock = clock
        self.ledger = QuotaLeaseLedger(base_dir, clock=clock)
        self.grants_total = 0
        self.revokes_total = 0
        self.expiries_total = 0
        self.rewrites_total = 0
        self.passes_total = 0
        self.failed_passes_total = 0
        # lender -> no grants until this wall time, set on every demand
        # or staleness revoke: a reclaimed lender proves idleness again
        # across passes, not within one
        self._lender_cooldown: dict[str, float] = {}
        self.cooldown_s = 2.0 * interval_s
        # borrower -> its step, scaled by the borrowed-vs-used verdict
        self._borrower_step: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- the configs ------------------------------------------------------

    def _tenants(self) -> dict[str, _Tenant]:
        out: dict[str, _Tenant] = {}
        for uid, label, path, _is_dra in \
                iter_container_config_paths(self.base_dir):
            try:
                cfg = vc.read_config(path)
            except (OSError, ValueError):
                continue     # a writer's crash window; next pass
            out[f"{uid}/{label}"] = _Tenant(f"{uid}/{label}", path, cfg)
        return out

    # -- one pass ---------------------------------------------------------

    def tick(self, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        try:
            self.util.fold(now_wall=now)
        except Exception:  # noqa: BLE001 - costs this pass its freshness;
            # the confidence decay converges the market
            log.warning("quota market: utilization fold failed",
                        exc_info=True)
        tenants = self._tenants()
        # lapsed cooldowns and departed borrowers' steps go
        self._lender_cooldown = {k: t for k, t
                                 in self._lender_cooldown.items()
                                 if t > now}
        self._borrower_step = {k: v for k, v
                               in self._borrower_step.items()
                               if k in tenants}
        self._expire(now)
        # one ledger read per phase (a phase may mutate it)
        self._revoke_stressed(tenants, now, self.ledger.snapshot(now))
        self._grant(tenants, now, self.ledger.snapshot(now))
        self._reconcile(tenants, now)
        self._publish(now)
        # granted leases are never dropped; settled ones age out
        self.ledger.compact(now=now)

    def _expire(self, now: float) -> None:
        due = self.ledger.due(now)
        if not due:
            return
        epoch = self.ledger.settle([l["id"] for l in due],
                                   STATE_EXPIRED, now)
        self.expiries_total += len(due)
        for lease in due:
            self._audit("expire", lease, epoch, now)

    def _revoke(self, leases: list[dict], now: float,
                why: str) -> None:
        if not leases:
            return
        epoch = self.ledger.settle([l["id"] for l in leases],
                                   STATE_REVOKED, now)
        # the crash window: revoked in the ledger, in no config yet; the
        # reconcile and the restart rule converge it
        failpoints.fire("quota.revoke", path=self.ledger.path,
                        count_leases=len(leases), why=why)
        self.revokes_total += len(leases)
        for lease in leases:
            self._audit("revoke", lease, epoch, now, why=why)

    def _revoke_stressed(self, tenants: dict[str, _Tenant],
                         now: float, view) -> None:
        active = view.active
        if not active:
            return
        states = {(s.pod_uid, s.container, s.host_index): s
                  for s in self.util.tenants()}
        deltas = view.deltas
        to_revoke: dict[str, dict] = {}
        reasons: dict[str, str] = {}
        for lease in active:
            lender, borrower = lease["lender"], lease["borrower"]
            chip = int(lease["chip"])
            lt = tenants.get(lender)
            if lt is None or tenants.get(borrower) is None or \
                    chip not in lt.by_chip:
                to_revoke[lease["id"]] = lease
                reasons[lease["id"]] = "party-gone"
                continue
            uid, _, label = lender.partition("/")
            state = states.get((uid, label, chip))
            conf = state.confidence(now) if state is not None else 0.0
            if state is None or conf <= self.revoke_confidence:
                # no signal: reclaim to the exact pre-market rates
                to_revoke[lease["id"]] = lease
                reasons[lease["id"]] = "stale-signal"
                continue
            envelope = state.used_ewma + 2.0 * math.sqrt(
                max(state.used_var, 0.0))
            retained = effective_core(
                lt.by_chip[chip].hard_core,
                deltas.get((lender, chip), 0))
            if envelope >= retained - REVOKE_MARGIN_PCT:
                to_revoke[lease["id"]] = lease
                reasons[lease["id"]] = "lender-demand"
        for why in set(reasons.values()):
            self._revoke([l for lid, l in to_revoke.items()
                          if reasons[lid] == why], now, why)
        for lid, lease in to_revoke.items():
            # the cooldown is for the lender's own signal (demand,
            # staleness), not for a counterparty that left
            if reasons[lid] != "party-gone":
                self._lender_cooldown[lease["lender"]] = \
                    now + self.cooldown_s

    def _grant(self, tenants: dict[str, _Tenant], now: float,
               view) -> None:
        states = {(s.pod_uid, s.container, s.host_index): s
                  for s in self.util.tenants()}
        deltas = view.deltas
        # a borrower's step is scaled at most once a pass, however many
        # cards it is on
        tick_step: dict[str, tuple[int, float]] = {}

        def tenant_state(key: str, chip: int):
            uid, _, label = key.partition("/")
            return states.get((uid, label, chip))

        by_chip: dict[int, list[_Tenant]] = {}
        for t in tenants.values():
            for chip in t.by_chip:
                by_chip.setdefault(chip, []).append(t)

        for chip, residents in sorted(by_chip.items()):
            borrowers = []
            lenders = []
            for t in residents:
                dev = t.by_chip[chip]
                state = tenant_state(t.key, chip)
                delta = deltas.get((t.key, chip), 0)
                cls = t.cfg.workload_class
                if cls == vc.WORKLOAD_CLASS_LATENCY:
                    if state is None or state.confidence(now) <= 0.0:
                        continue    # no fresh evidence of the stall
                    if state.wait_frac < self.wait_frac_threshold:
                        continue    # not throttle-bound
                    if dev.core_limit == vc.CORE_LIMIT_NONE:
                        continue    # unthrottled: nothing to lend it
                    room = min(100 - effective_core(dev.hard_core,
                                                    delta),
                               self.max_borrow_pct - max(delta, 0))
                    if room > 0:
                        borrowers.append((t, dev, state, room, delta))
                elif cls == vc.WORKLOAD_CLASS_THROUGHPUT:
                    if state is None:
                        continue
                    if now < self._lender_cooldown.get(t.key, 0.0):
                        continue    # recently reclaimed: re-prove idle
                    lent = max(-delta, 0)
                    lendable = min(
                        state.reclaim_core_pct(now) - lent
                        - GRANT_HEADROOM_PCT,
                        dev.hard_core - lent - self.min_retain_pct)
                    if lendable >= 1.0:
                        lenders.append((t, dev, state, lendable))
            if not borrowers or not lenders:
                continue
            # the most stalled borrower first, the idlest lender first
            borrowers.sort(key=lambda b: -b[2].wait_frac)
            lenders.sort(key=lambda l: -l[3])
            for bt, bdev, bstate, room, delta in borrowers:
                if bt.key not in tick_step:
                    tick_step[bt.key] = scaled_grant_step(
                        self._borrower_step.get(bt.key,
                                                self.grant_step_pct),
                        self.grant_step_pct, self.max_borrow_pct,
                        bstate.used_ewma
                        if bstate.confidence(now) > 0 else None,
                        bdev.hard_core, max(delta, 0))
                    self._borrower_step[bt.key] = tick_step[bt.key][0]
                step, ttl_factor = tick_step[bt.key]
                ttl_s = self.lease_ttl_s * ttl_factor
                for i, (lt, ldev, lstate, lendable) in \
                        enumerate(lenders):
                    pct = int(min(step, room, lendable))
                    if pct < 1:
                        continue
                    lease, epoch = self.ledger.grant(
                        chip, lt.key, bt.key, pct, ttl_s, now)
                    # the crash window: granted in the ledger, in no
                    # config yet; the reconcile and restart rules
                    # converge it
                    failpoints.fire("quota.lease",
                                    path=self.ledger.path,
                                    lease_id=lease["id"], chip=chip)
                    self.grants_total += 1
                    self._audit("grant", lease, epoch, now)
                    lenders[i] = (lt, ldev, lstate, lendable - pct)
                    room -= pct
                    if room < 1:
                        break

    def _reconcile(self, tenants: dict[str, _Tenant],
                   now: float) -> None:
        """Writes the ledger's active deltas into the configs, the one
        writer of every path. The conservation guard comes first: if the
        desired state would pass 100 on a card (a corrupt ledger), every
        lease there is revoked and the pass reads the settled ledger."""
        view = self.ledger.snapshot(now)
        desired_sum: dict[int, int] = {}
        for t in tenants.values():
            for chip, dev in t.by_chip.items():
                desired_sum[chip] = desired_sum.get(chip, 0) + \
                    effective_core(dev.hard_core,
                                   view.deltas.get((t.key, chip), 0))
        bad = [chip for chip, total in desired_sum.items()
               if total > 100]
        if bad:
            log.error("quota ledger would oversubscribe chip(s) %s; "
                      "revoking every lease there", bad)
            victims = [l for l in view.active
                       if l.get("chip") in bad]
            self._revoke(victims, now, "oversubscribed-ledger")
            view = self.ledger.snapshot(now)
        # the deltas and the epoch from one load: a config never carries
        # one generation's epoch with another's leases
        deltas = view.deltas
        epoch = view.epoch
        for t in tenants.values():
            want = {chip: deltas.get((t.key, chip), 0)
                    for chip in t.by_chip}
            if all(dev.lease_core == want[chip]
                   for chip, dev in t.by_chip.items()):
                continue
            for chip, dev in t.by_chip.items():
                dev.lease_core = want[chip]
            t.cfg.quota_epoch = epoch
            try:
                vc.write_config(t.path, t.cfg)
                self.rewrites_total += 1
            except OSError:
                # the next pass retries; the interposer keeps the old
                # rates until a whole file lands
                log.warning("quota config rewrite failed for %s",
                            t.path, exc_info=True)

    # -- the audit and the annotation ---------------------------------------

    def _audit(self, op: str, lease: dict, epoch: int, now: float,
               why: str = "") -> None:
        for party, role in ((lease.get("borrower", ""), "borrower"),
                            (lease.get("lender", ""), "lender")):
            uid = party.partition("/")[0]
            if uid:
                trace.event(trace.context_for_uid(uid), f"quota.{op}",
                            role=role, chip=lease.get("chip"),
                            pct=lease.get("pct"), epoch=epoch,
                            **({"why": why} if why else {}))

    def encode_annotation(self, now: float) -> str:
        """The per-card lease summary, `chip:lent:count;...@ts`, stale by
        its timestamp like the pressure and headroom codecs."""
        per_chip: dict[int, tuple[int, int]] = {}
        for lease in self.ledger.active(now):
            chip = int(lease["chip"])
            lent, count = per_chip.get(chip, (0, 0))
            per_chip[chip] = (lent + int(lease["pct"]), count + 1)
        body = ";".join(f"{chip}:{lent}:{count}"
                        for chip, (lent, count)
                        in sorted(per_chip.items()))
        return stalecodec.stamp(body, now)

    def _publish(self, now: float) -> None:
        if self.client is None:
            return
        try:
            self.policy.run(
                lambda: self.client.patch_node_annotations(
                    self.node_name,
                    {consts.node_quota_lease_annotation():
                     self.encode_annotation(now)}),
                op="quota.lease_patch")
        except Exception:  # noqa: BLE001 - an advisory view; the codec's
            # timestamp ages a silent publisher out on every reader
            log.warning("quota lease annotation publish failed",
                        exc_info=True)

    # -- the lifecycle ------------------------------------------------------

    def recover(self) -> None:
        """The restart rule: after a crash a granted lease's enforcement
        is unknown (the market may have died mid-revoke, or between the
        ledger and a config), so every lease still granted, active or
        past its TTL, is revoked and the configs reconciled: the market
        starts from base truth. `start` runs it before the first pass."""
        now = self.clock()
        stale = [l for l in self.ledger.leases()
                 if l.get("state") == STATE_GRANTED]
        if stale:
            log.info("quota market restart: revoking %d carried "
                     "lease(s)", len(stale))
        self._revoke(stale, now, "manager-restart")
        self._reconcile(self._tenants(), now)

    def run_pass(self) -> bool:
        """One pass of the loop: a pass that fails is logged and counted,
        and the market goes on (the TTLs bound any half state).
        `passes_total` counts passes that have ended."""
        try:
            self.tick()
            return True
        except Exception:  # noqa: BLE001 - one torn pass must not end it
            self.failed_passes_total += 1
            log.warning("quota market pass failed", exc_info=True)
            return False
        finally:
            self.passes_total += 1

    def start(self) -> None:
        self.recover()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.run_pass()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="vtqm-market")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
