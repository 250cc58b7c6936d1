"""The cluster rollup: the node ledgers joined into the /utilization view.

The port of the JAX package's `utilization/rollup.py` with the folds whose
gates the port has: QuotaMarket's leases, HBMOvercommit's ratios and spill
state, the cluster compile cache's warm keys, CommTelemetry's rows. The
SLO, autopilot, health and fragmentation folds wait for their planes;
with their gates off the JAX rollup writes none of their keys, so the
document is the one the JAX rollup writes.

The exporter serves it as `/utilization` under the UtilizationLedger gate.
The cluster comes from the annotations the node agents already publish
(the device registry, the reclaimable headroom, the pressure) and the
pods' claim annotations, one listing each through the API client. A
tenant's live use (used %, throttle wait, high-water) is node-local: it
comes from this exporter's own ledger for the tenants on this node, and
remote tenants carry their quota rows and their chips' rollup. Without a
client the document is the node-local cut; an API error adds a line to
`errors`, never a failed document.
"""

from __future__ import annotations

import logging
import os
import time

from vtpu_manager_torch.device.claims import PodDeviceClaims
from vtpu_manager_torch.device.types import NodeDeviceRegistry
from vtpu_manager_torch.resilience import failpoints
from vtpu_manager_torch.telemetry import pressure as tel_pressure
from vtpu_manager_torch.util import consts
from vtpu_manager_torch.utilization import headroom as hr_mod
from vtpu_manager_torch.utilization.ledger import UtilizationLedger

log = logging.getLogger(__name__)


def _decode_registry(raw: str | None) -> NodeDeviceRegistry | None:
    """The register annotation decoded; None when absent or malformed."""
    if not raw:
        return None
    try:
        return NodeDeviceRegistry.decode(raw)
    except (ValueError, TypeError, AttributeError):
        return None


class ClusterRollup:
    """Node annotations, pod claims and the local ledger, folded into the
    /utilization document. `vmem_path` and `spill_dir` are the node's
    memory ledger and host pool (the overcommit fold's local truth)."""

    def __init__(self, ledger: UtilizationLedger, client=None,
                 cache_root: str | None = None,
                 fold_budget_s: float | None = None,
                 quota_dir: str | None = None,
                 overcommit: bool = False,
                 cluster_cache: bool = False,
                 comm: bool = False,
                 vmem_path: str = consts.VMEM_NODE_CONFIG,
                 spill_dir: str = consts.SPILL_DIR):
        self.ledger = ledger
        self.client = client
        self.cache_root = cache_root
        # QuotaMarket: the directory of the node's lease ledger; None
        # (the gate off): the document carries no lease fields
        self.quota_dir = quota_dir
        # each False: the document carries none of the gate's fields
        self.overcommit = overcommit
        self.cluster_cache = cluster_cache
        self.comm = comm
        self.vmem_path = vmem_path
        self.spill_dir = spill_dir
        # the collector's knob, parsed once (a bad value fails here)
        if fold_budget_s is None:
            fold_budget_s = float(
                os.environ.get("VTPU_UTIL_FOLD_BUDGET_S", "0.25"))
        self.fold_budget_s = fold_budget_s

    # -- the cluster ------------------------------------------------------

    def _node_rows(self, now: float) -> tuple[list[dict], list[str]]:
        rows: list[dict] = []
        errors: list[str] = []
        if self.client is None:
            return rows, errors
        # one memory-ledger scan per collect for the SPILL column
        local_spilled = self._local_spilled_by_chip() \
            if self.overcommit else {}
        try:
            nodes = self.client.list_nodes()
        except Exception as e:  # noqa: BLE001 - the local cut, said so
            log.warning("utilization rollup node listing failed: %s", e)
            errors.append(f"list_nodes: {e}")
            return rows, errors
        reg_ann = consts.node_device_register_annotation()
        hr_ann = consts.node_reclaimable_headroom_annotation()
        pr_ann = consts.node_pressure_annotation()
        oc_ann = consts.node_overcommit_annotation()
        for node in nodes:
            meta = node.get("metadata") or {}
            anns = meta.get("annotations") or {}
            name = meta.get("name", "")
            registry = _decode_registry(anns.get(reg_ann))
            headroom = hr_mod.parse_headroom(anns.get(hr_ann), now=now)
            pressure = tel_pressure.parse_pressure(anns.get(pr_ann),
                                                   now=now)
            overcommit = None
            if self.overcommit:
                from vtpu_manager_torch.overcommit import ratio as oc_mod
                overcommit = oc_mod.parse_overcommit(anns.get(oc_ann),
                                                     now=now)
            chips = []
            if registry is not None:
                for chip in registry.chips:
                    ch = headroom.chips.get(chip.index) \
                        if headroom else None
                    row = {
                        "index": chip.index, "uuid": chip.uuid,
                        "memory_bytes": chip.memory,
                        "split_count": chip.split_count,
                        "healthy": getattr(chip, "healthy", True),
                        "alloc_core_pct":
                            ch.alloc_core_pct if ch else None,
                        "used_core_pct":
                            ch.used_core_pct if ch else None,
                        "reclaim_core_pct":
                            ch.reclaim_core_pct if ch else None,
                        "reclaim_hbm_bytes":
                            ch.reclaim_hbm_bytes if ch else None,
                    }
                    if self.overcommit:
                        # VIRT: the chip under the node's widest class
                        # ratio (None: no live policy, physical admission)
                        row["virt_hbm_bytes"] = (
                            int(chip.memory * overcommit.max_ratio())
                            if overcommit else None)
                        # SPILL: node-local truth; remote chips carry None
                        row["spilled_bytes"] = (
                            local_spilled.get(chip.index, 0)
                            if name == self.ledger.node_name
                            and local_spilled is not None else None)
                    chips.append(row)
            row_extra = {}
            if self.quota_dir:
                # the raw lease summary rides to the lease fold, which
                # pops it
                row_extra["_quota_lease_raw"] = anns.get(
                    consts.node_quota_lease_annotation())
            if self.overcommit:
                row_extra["overcommit_ratios"] = \
                    dict(overcommit.ratios) if overcommit else None
                row_extra["overcommit_ratio"] = \
                    overcommit.max_ratio() if overcommit else None
                row_extra["spill_frac"] = \
                    overcommit.spill_frac if overcommit else None
                row_extra["spilled_bytes"] = \
                    overcommit.spilled_bytes if overcommit else None
            if self.cluster_cache:
                # which programs this node can seed the fleet with
                from vtpu_manager_torch.clustercache import advertise
                warm = advertise.parse_warm_keys(
                    anns.get(consts.node_cache_keys_annotation()), now=now)
                row_extra["warm_keys"] = \
                    len(warm.pairs) if warm else None
                # hottest first, as advertised
                row_extra["warm_fps"] = \
                    [fp for fp, _k in warm.pairs] if warm else None
            rows.append({
                **row_extra,
                "node": name,
                "local": name == self.ledger.node_name,
                "chips": chips,
                "mesh_domain":
                    registry.mesh_domain if registry else "",
                "headroom_ts": headroom.ts if headroom else None,
                "headroom_stale": headroom is None
                    and bool(anns.get(hr_ann)),
                "reclaim_core_pct": round(
                    headroom.total_reclaim_core_pct(), 2)
                    if headroom else None,
                "pressure_frac":
                    pressure.throttle_frac if pressure else None,
            })
        return rows, errors

    def _tenant_quota_rows(self, now: float
                           ) -> tuple[list[dict], list[str]]:
        """Every pod's quota rows from its claim annotation, joined with
        live use where this node's ledger has the tenant."""
        rows: list[dict] = []
        errors: list[str] = []
        if self.client is None:
            return rows, errors
        try:
            pods = self.client.list_pods()
        except Exception as e:  # noqa: BLE001 - the local cut, said so
            log.warning("utilization rollup pod listing failed: %s", e)
            errors.append(f"list_pods: {e}")
            return rows, errors
        real_ann = consts.real_allocated_annotation()
        pre_ann = consts.pre_allocated_annotation()
        live = {(s.pod_uid, s.container.split("/", 1)[0], s.host_index): s
                for s in self.ledger.tenants()}
        for pod in pods:
            meta = pod.get("metadata") or {}
            anns = meta.get("annotations") or {}
            raw = anns.get(real_ann) or anns.get(pre_ann)
            if not raw:
                continue
            try:
                claims = PodDeviceClaims.decode(raw)
            except (ValueError, TypeError):
                continue
            uid = meta.get("uid", "")
            node = (pod.get("spec") or {}).get("nodeName", "") or \
                anns.get(consts.predicate_node_annotation(), "")
            for container, clist in claims.containers.items():
                for claim in clist:
                    state = live.get((uid, container, claim.host_index))
                    rows.append({
                        "pod_uid": uid,
                        "pod_name": meta.get("name", ""),
                        "pod_namespace": meta.get("namespace", ""),
                        "container": container,
                        "node": node,
                        "chip_index": claim.host_index,
                        "chip_uuid": claim.uuid,
                        "allocated_core_pct": claim.cores,
                        "allocated_hbm_bytes": claim.memory,
                        "used_core_pct": round(state.used_ewma, 2)
                            if state else None,
                        "throttle_wait_frac": round(state.wait_frac, 4)
                            if state else None,
                        "hbm_highwater_bytes": state.hbm_highwater
                            if state else None,
                        "confidence": round(state.confidence(now), 3)
                            if state else None,
                        "live": state is not None,
                    })
        return rows, errors

    def _fold_quota_leases(self, tenant_rows: list[dict],
                           node_rows: list[dict],
                           now: float) -> dict | None:
        """The node's lease ledger folded into the tenant rows (the lent
        and borrowed columns) and the nodes' lease summaries into the node
        rows; the ledger file is the local truth, as the live columns
        are."""
        if not self.quota_dir:
            return None
        from vtpu_manager_torch.quota import (QuotaLeaseLedger,
                                              parse_lease_summary)
        from vtpu_manager_torch.quota.market import borrowed_used_verdict
        # the remote nodes first: the raw annotation is popped whatever
        # the local read below does
        for nrow in node_rows:
            summary = parse_lease_summary(
                nrow.pop("_quota_lease_raw", None), now=now)
            if summary is not None:
                nrow["quota_lent_core_pct"] = sum(
                    c["lent_core_pct"] for c in summary.values())
                nrow["quota_leases"] = sum(
                    c["leases"] for c in summary.values())
        # one ledger generation for the document (a torn file loads as
        # empty): the columns, the active list and the epoch agree
        view = QuotaLeaseLedger(self.quota_dir).snapshot(now)
        leases, active = view.leases, view.active
        by_tenant_chip: dict[tuple[str, str, int], int] = {}
        for (tenant, chip), pct in view.deltas.items():
            uid, _, label = tenant.partition("/")
            # summed per base container: a multi-request DRA claim's
            # partitions share the row's key
            key = (uid, label.split("/", 1)[0], chip)
            by_tenant_chip[key] = by_tenant_chip.get(key, 0) + pct
        by_row = {}
        for row in tenant_rows:
            key = (row.get("pod_uid", ""),
                   str(row.get("container", "")).split("/", 1)[0],
                   row.get("chip_index"))
            by_row[key] = row
            delta = by_tenant_chip.get(key)
            if delta is None:
                continue
            if delta > 0:
                row["borrowed_core_pct"] = delta
            elif delta < 0:
                row["lent_core_pct"] = -delta
        # per active lease, did the borrower use what it borrowed: its
        # used % (the ledger's, as its row carries it) through the
        # market's own formula, so a recorded document replays it
        borrowed_used = []
        for lease in active:
            uid, _, label = str(lease.get("borrower", "")).partition("/")
            row = by_row.get((uid, label.split("/", 1)[0],
                              lease.get("chip")))
            pct = int(lease.get("pct", 0))
            used = row.get("used_core_pct") if row else None
            base = row.get("allocated_core_pct") if row else None
            used_of_borrowed = borrowed_used_verdict(used, base, pct)
            if used_of_borrowed is not None:
                used_of_borrowed = round(used_of_borrowed, 2)
            borrowed_used.append({
                "id": lease.get("id"),
                "chip": lease.get("chip"),
                "borrower": lease.get("borrower"),
                "pct": pct,
                "used_of_borrowed_pct": used_of_borrowed,
                "utilization": round(used_of_borrowed / pct, 3)
                    if used_of_borrowed is not None and pct else None,
                "live": used is not None,
            })
        return {
            "leases_active": len(active),
            "lent_core_pct_total": sum(int(l.get("pct", 0))
                                       for l in active),
            "epoch": int(view.epoch),
            "leases": [{k: l.get(k) for k in
                        ("id", "chip", "lender", "borrower", "pct",
                         "granted_at", "ttl_s", "state")}
                       for l in leases[-64:]],
            "borrowed_used": borrowed_used,
        }

    def _local_spilled_by_chip(self) -> "dict[int, int] | None":
        """Host-pool bytes per chip off the node's memory ledger, one scan
        (None when it cannot be read: the column shows '-')."""
        try:
            from vtpu_manager_torch.config.vmem import VmemLedger
            led = VmemLedger(self.vmem_path)
            try:
                out: dict[int, int] = {}
                for e in led.entries():
                    out[e.host_index] = out.get(e.host_index, 0) \
                        + e.spilled
                return out
            finally:
                led.close()
        except (OSError, ValueError):
            return None

    def _compile_cache_state(self) -> dict | None:
        if not self.cache_root:
            return None
        try:
            from vtpu_manager_torch.compilecache.cache import node_totals
            counters, entries, size = node_totals(self.cache_root)
            return {"entries": entries, "size_bytes": size,
                    "hits": counters.get("hits", 0),
                    "misses": counters.get("misses", 0)}
        except (OSError, ValueError):
            return None

    # -- the document -----------------------------------------------------

    def collect(self, now: float | None = None) -> dict:
        """The /utilization document. Raises only what the `util.rollup`
        failpoint injects (the route answers 503); a failed fold or
        listing leaves a line in `errors`."""
        failpoints.fire("util.rollup", node=self.ledger.node_name)
        now = time.time() if now is None else now
        fold_errors: list[str] = []
        try:
            # fresh local rows even when nothing scrapes /metrics
            self.ledger.fold(budget_s=self.fold_budget_s)
        except Exception as e:  # noqa: BLE001 - the last fold's decaying
            # state, and the error said
            log.warning("utilization rollup fold failed: %s", e)
            fold_errors.append(f"fold: {e}")
        node_rows, node_errors = self._node_rows(now)
        tenant_rows, pod_errors = self._tenant_quota_rows(now)
        # local rows the pod listing did not cover join in, shaped like
        # the cluster's (which take precedence)
        present = {(t["pod_uid"], t["container"], t["chip_index"])
                   for t in tenant_rows}
        local = self.ledger.to_wire(now)
        for t in local["tenants"]:
            key = (t["pod_uid"], t["container"].split("/", 1)[0],
                   t["chip_index"])
            if key not in present:
                tenant_rows.append(
                    dict(t, node=self.ledger.node_name, live=True))
        local["compile_cache"] = self._compile_cache_state()
        if self.overcommit:
            from vtpu_manager_torch.overcommit.spill import pool_totals
            spill_frac, ring_bytes = self.ledger.node_spill_signal(now)
            pool_files, pool_bytes = pool_totals(self.spill_dir)
            local["spill"] = {
                "spill_frac": round(spill_frac, 4),
                "spilled_bytes": ring_bytes,
                "pool_files": pool_files,
                "pool_bytes": pool_bytes,
                "spill_events_total": self.ledger.spill_events_total,
                "fill_events_total": self.ledger.fill_events_total,
            }
        if self.comm:
            comm_rows = self.ledger.comm_rows(now)
            local["comm"] = {
                "tenants": comm_rows,
                "comm_bytes_total": self.ledger.comm_bytes_total,
                "collectives_total": self.ledger.collectives_total,
            }
            # a stale comm writer keeps its flagged row above but no COMM
            # columns on a live tenant row
            by_tenant = {(c["pod_uid"],
                          c["container"].split("/", 1)[0]): c
                         for c in comm_rows if not c["stale"]}
            for row in tenant_rows:
                c = by_tenant.get(
                    (row.get("pod_uid", ""),
                     str(row.get("container", "")).split("/", 1)[0]))
                if c is not None and row.get("live"):
                    row["comm_duty_frac"] = c["comm_duty_frac"]
                    row["comm_intensity"] = c["comm_intensity"]
        quota = self._fold_quota_leases(tenant_rows, node_rows, now)
        live_nodes = [r for r in node_rows
                      if r["reclaim_core_pct"] is not None]
        doc = {
            "generated_at": now,
            "node": local,
            "nodes": node_rows,
            "tenants": tenant_rows,
            "cluster": {
                "nodes": len(node_rows),
                "nodes_with_signal": len(live_nodes),
                "chips": sum(len(r["chips"]) for r in node_rows),
                "reclaimable_core_pct": round(
                    sum(r["reclaim_core_pct"] for r in live_nodes), 2),
                "tenant_rows": len(tenant_rows),
            },
            "errors": fold_errors + node_errors + pod_errors,
        }
        if quota is not None:
            doc["quota"] = quota
        if self.overcommit:
            # the fleet's view: each class's ratio spread over the
            # publishing nodes and the fleet's spill headline
            per_class: dict[str, list] = {}
            spill_fracs = []
            spilled_sum = 0
            publishing = 0
            for nrow in node_rows:
                ratios = nrow.get("overcommit_ratios")
                if ratios is None:
                    continue
                publishing += 1
                for cls, ratio in ratios.items():
                    per_class.setdefault(cls, []).append(float(ratio))
                if nrow.get("spill_frac") is not None:
                    spill_fracs.append(float(nrow["spill_frac"]))
                spilled_sum += int(nrow.get("spilled_bytes") or 0)
            doc["overcommit"] = {
                "nodes_publishing": publishing,
                "classes": {
                    cls: {
                        "nodes": len(vals),
                        "min_ratio": round(min(vals), 3),
                        "max_ratio": round(max(vals), 3),
                        "mean_ratio": round(sum(vals) / len(vals), 3),
                    } for cls, vals in sorted(per_class.items())},
                "fleet_spill_frac_mean": round(
                    sum(spill_fracs) / len(spill_fracs), 4)
                    if spill_fracs else 0.0,
                "fleet_spill_frac_max": round(max(spill_fracs), 4)
                    if spill_fracs else 0.0,
                "fleet_spilled_bytes": spilled_sum,
            }
        return doc


def filter_document(doc: dict, node: str = "", pod: str = "") -> dict:
    """The route's ?node= and ?pod= cuts of a collected document."""
    out = dict(doc)
    if node:
        out["nodes"] = [r for r in doc.get("nodes", [])
                        if r.get("node") == node]
        out["tenants"] = [r for r in doc.get("tenants", [])
                         if r.get("node") == node]
    if pod:
        out["tenants"] = [r for r in out.get("tenants", [])
                         if pod in (r.get("pod_uid"), r.get("pod_name"))]
    return out
