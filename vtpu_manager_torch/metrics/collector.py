"""The node exporter's collector: what each tenant of a card is given and
what it uses, as Prometheus gauges.

The port of the JAX package's `metrics/collector.py:19-651`, less the
planes that are not ported (the utilization ledger, SLO attribution). One scrape reads, all node-local:
each container's `vtpu.config` (its limits), the memory ledger (bytes in
use, per process), the watcher's feed (the card's duty cycle and each
tenant's attributed share, the calibration block), kubelet's view of who
holds devices (the pod-resources socket and the checkpoint, to flag a
config directory kubelet does not vouch for), the step rings (per-pod
histograms and the node's pressure; with `comm_enabled`, CommTelemetry's
`vtpu_tenant_comm_*` families from the rings' comm block), the compile
cache's counters, with `overcommit_enabled` (HBMOvercommit) the node's
spill series (the rings' spill block and the host pool's files), and its
own duration and per-feed read errors.
"""

from __future__ import annotations

import logging
import os
import time

import vtpu_manager_torch
from vtpu_manager_torch.client import pod_resources
from vtpu_manager_torch.compilecache.cache import render_node_metrics
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.config.tc_watcher import TcUtilFile
from vtpu_manager_torch.config.tenantdirs import iter_container_configs
from vtpu_manager_torch.config.vmem import VmemLedger, fnv64
from vtpu_manager_torch.device.types import ChipSpec
from vtpu_manager_torch.deviceplugin import checkpoint as ckpt
from vtpu_manager_torch.telemetry import TenantStepTelemetry
from vtpu_manager_torch.util import consts

log = logging.getLogger(__name__)

# a tenant's config dir younger than this is unjudgeable rather than a
# mismatch: kubelet's checkpoint write can lag the allocation, so a tenant
# just started would otherwise publish a transient mismatch
STARTUP_GRACE_S = float(os.environ.get("VTPU_MAP_STARTUP_GRACE_S", "60"))


def _age_seconds(ts_monotonic_ns: int, now_ns: int | None = None) -> float:
    """Age of a monotonic-clock timestamp; negative deltas (pre-reboot
    stamps) read as very stale, not fresh."""
    now = time.monotonic_ns() if now_ns is None else now_ns
    delta = now - ts_monotonic_ns
    return delta / 1e9 if delta >= 0 else float("inf")


class Gauge:
    def __init__(self, name: str, help_text: str, labels: tuple[str, ...]):
        self.name = name
        self.help = help_text
        self.labels = labels
        self.samples: list[tuple[tuple[str, ...], float]] = []

    def set(self, label_values: tuple[str, ...], value: float) -> None:
        self.samples.append((label_values, value))

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        for values, value in self.samples:
            label_str = ",".join(f'{k}="{v}"'
                                 for k, v in zip(self.labels, values))
            lines.append(f"{self.name}{{{label_str}}} {value}")
        return "\n".join(lines)


class NodeCollector:
    """Collects one scrape's worth of node + container gauges."""

    def __init__(self, node_name: str, chips: list[ChipSpec],
                 base_dir: str = consts.MANAGER_BASE_DIR,
                 tc_path: str = consts.TC_UTIL_CONFIG,
                 vmem_path: str = consts.VMEM_NODE_CONFIG,
                 pod_resources_socket: str | None = None,
                 kubelet_checkpoint: str | None = None,
                 comm_enabled: bool = False,
                 overcommit_enabled: bool = False,
                 spill_dir: str = consts.SPILL_DIR):
        self.node_name = node_name
        self.chips = chips
        self.base_dir = base_dir
        self.tc_path = tc_path
        self.vmem_path = vmem_path
        # the kubelet, not the config directories' own names, is the
        # authority on which container holds devices; None = its
        # well-known paths
        self.pod_resources_socket = (
            pod_resources.POD_RESOURCES_SOCKET
            if pod_resources_socket is None else pod_resources_socket)
        self.kubelet_checkpoint = (
            ckpt.KUBELET_CHECKPOINT
            if kubelet_checkpoint is None else kubelet_checkpoint)
        # peak concurrent tenants per card over this exporter's life
        self._peak_shared: dict[str, int] = {}
        # the kubelet view is cached for a TTL: the List call dials a new
        # channel with a 2 s timeout inside collect(), and a wedged socket
        # must not add that to every scrape
        self._kubelet_view_cache: pod_resources.KubeletView | None = None
        self._kubelet_view_ts: float = -float("inf")
        self._kubelet_view_was_cached: bool = False
        self.kubelet_view_ttl_s = float(
            os.environ.get("VTPU_KUBELET_VIEW_TTL_S", "10"))
        # the step rings, tailed by cursor and folded into cumulative
        # per-pod histograms across scrapes (a ring remembers only its
        # last RING_CAPACITY steps); with CommTelemetry the same fold
        # takes the comm block into the vtpu_tenant_comm_* families, and
        # off renders none of them (the gate-off contract)
        self.comm_enabled = comm_enabled
        self.telemetry = TenantStepTelemetry(base_dir, comm=comm_enabled)
        # HBMOvercommit: the node's spill series, from a fold of the rings'
        # spill block with its own cursors and the pool dir; off renders
        # none of them (the gate-off contract)
        self.spill_dir = spill_dir
        self.oc_ledger = None
        if overcommit_enabled:
            from vtpu_manager_torch.overcommit.ledger import OvercommitLedger
            self.oc_ledger = OvercommitLedger(chips, base_dir=base_dir,
                                              tc_path=tc_path)
        # per-feed last-read-error flags: a wedged file must show, not
        # serve stale gauges silently
        self._feed_errors: dict[str, float] = {
            "tc_util": 0.0, "vmem": 0.0, "telemetry": 0.0}
        self._last_scrape_s: float = 0.0

    def _kubelet_view(self, force: bool = False
                      ) -> pod_resources.KubeletView:
        now = time.monotonic()
        if (force or self._kubelet_view_cache is None
                or now - self._kubelet_view_ts >= self.kubelet_view_ttl_s):
            self._kubelet_view_cache = pod_resources.kubelet_view(
                self.pod_resources_socket, self.kubelet_checkpoint)
            self._kubelet_view_ts = now
            self._kubelet_view_was_cached = False
        else:
            self._kubelet_view_was_cached = True
        return self._kubelet_view_cache

    def _container_configs(self) -> list[
            tuple[str, str, vc.VtpuConfig, bool, float]]:
        """(pod_uid_or_claim, container_label, config, is_dra,
        config_mtime — the tenant-age signal for the startup grace), by
        the one walk of config/tenantdirs.py."""
        return list(iter_container_configs(self.base_dir))

    def collect(self) -> list[Gauge]:
        gauges: list[Gauge] = []
        chip_by_index = {c.index: c for c in self.chips}

        # ---- physical chip gauges (reference physical_gpu_device_*) ----
        g_mem_total = Gauge("vtpu_device_memory_total_bytes",
                            "Physical HBM per chip",
                            ("node", "uuid", "index"))
        g_mem_used = Gauge("vtpu_device_memory_used_bytes",
                           "HBM in use on the chip across all tenants",
                           ("node", "uuid", "index"))
        g_mem_util = Gauge("vtpu_device_memory_utilization_percent",
                           "Chip HBM utilization (0-100)",
                           ("node", "uuid", "index"))
        g_healthy = Gauge("vtpu_device_healthy",
                          "Chip health (1 healthy)",
                          ("node", "uuid", "index"))
        g_util = Gauge("vtpu_device_utilization_percent",
                       "Chip duty-cycle percent from the node watcher",
                       ("node", "uuid", "index"))
        g_slots_total = Gauge("vtpu_device_slots_total",
                              "Advertised vTPU slots per chip",
                              ("node", "uuid", "index"))
        g_feed_age = Gauge("vtpu_device_feed_age_seconds",
                           "Age of the node watcher's last sample for the "
                           "chip (staleness signal)",
                           ("node", "uuid", "index"))
        for chip in self.chips:
            labels = (self.node_name, chip.uuid, str(chip.index))
            g_mem_total.set(labels, float(chip.memory))
            g_healthy.set(labels, 1.0 if chip.healthy else 0.0)
            g_slots_total.set(labels, float(chip.split_count))
        gauges += [g_mem_total, g_healthy, g_slots_total]

        # node watcher feed: chip duty cycle + per-tenant/per-process
        # attributed shares (the watcher apportions by ledger submit-
        # activity deltas). Keyed per (tenant, chip): ProcUtil.util is
        # percent OF ONE CHIP — summing across chips would exceed 100.
        util_by_token: dict[tuple[int, int], int] = {}
        proc_utils: list[tuple[int, int, int, int]] = []  # token,chip,pid,%
        g_cal_max = Gauge("vtpu_node_obs_excess_max_us",
                          "Max point of the published transport "
                          "span-inflation excess table (absent = "
                          "uncalibrated; 0 = calibrated clean transport)",
                          ("node",))
        g_cal_age = Gauge("vtpu_node_obs_calibration_age_seconds",
                          "Age of the feed's calibration block",
                          ("node",))
        self._feed_errors["tc_util"] = 0.0
        try:
            tc = TcUtilFile(self.tc_path)
            cal_full = tc.read_calibration_full()
            if cal_full is not None:
                cal, cal_ts = cal_full
                g_cal_max.set((self.node_name,),
                              float(max(e for _, e in cal)))
                if cal_ts:
                    g_cal_age.set((self.node_name,), _age_seconds(cal_ts))
            for chip in self.chips:
                rec = tc.read_device(chip.index)
                if rec is not None:
                    labels = (self.node_name, chip.uuid, str(chip.index))
                    g_util.set(labels, float(rec.device_util))
                    if rec.timestamp_ns:
                        g_feed_age.set(labels,
                                       _age_seconds(rec.timestamp_ns))
                    for proc in rec.procs:
                        # a process outside the ledger of unknown use
                        # (-1) adds nothing
                        util = max(0, proc.util)
                        key = (proc.owner_token, chip.index)
                        util_by_token[key] = \
                            util_by_token.get(key, 0) + util
                        proc_utils.append((proc.owner_token, chip.index,
                                           proc.pid, util))
            tc.close()
        except (OSError, ValueError):
            # absent feed (no TCWatcher on this node) is normal; only a
            # file that EXISTS but cannot be read is a scrape error
            if os.path.exists(self.tc_path):
                self._feed_errors["tc_util"] = 1.0
        gauges += [g_util, g_feed_age, g_cal_max, g_cal_age]

        # ---- vmem ledger: usage + heartbeat ----
        vmem = None
        self._feed_errors["vmem"] = 0.0
        try:
            vmem = VmemLedger(self.vmem_path)
        except (OSError, ValueError):
            if os.path.exists(self.vmem_path):
                self._feed_errors["vmem"] = 1.0
        # per-(tenant, chip) attribution: ledger entries carry the owner
        # token (fnv64 of pod_uid/container) AND the chip, so co-tenants
        # are never conflated and a multi-chip container's rows stay
        # per-device (a token-only sum would double every uuid row)
        usage_by_token: dict[tuple[int, int], int] = {}
        used_by_chip: dict[int, int] = {}
        heartbeat_by_token: dict[int, int] = {}   # newest last_update_ns
        ledger_entries = []
        if vmem is not None:
            ledger_entries = list(vmem.entries())
            vmem.close()
        for entry in ledger_entries:
            key = (entry.owner_token, entry.host_index)
            usage_by_token[key] = usage_by_token.get(key, 0) + entry.bytes
            used_by_chip[entry.host_index] = \
                used_by_chip.get(entry.host_index, 0) + entry.bytes
            heartbeat_by_token[entry.owner_token] = max(
                heartbeat_by_token.get(entry.owner_token, 0),
                entry.last_update_ns)
        # every chip gets a row — an idle chip's explicit 0 keeps "no
        # usage" distinguishable from "exporter broken"
        for chip in self.chips:
            used = used_by_chip.get(chip.index, 0)
            labels = (self.node_name, chip.uuid, str(chip.index))
            g_mem_used.set(labels, float(used))
            if chip.memory:
                g_mem_util.set(labels,
                               round(100.0 * used / chip.memory, 2))
        gauges += [g_mem_used, g_mem_util]

        # ---- per-container assignment + usage ----
        g_climit = Gauge("vtpu_container_core_limit_percent",
                         "Assigned core percent",
                         ("node", "pod_uid", "container", "uuid"))
        g_mlimit = Gauge("vtpu_container_memory_limit_bytes",
                         "Assigned HBM cap (virtual: oversold claims may "
                         "sum past the chip)",
                         ("node", "pod_uid", "container", "uuid"))
        g_mplimit = Gauge("vtpu_container_memory_limit_physical_bytes",
                          "Assigned cap clamped to physical chip HBM",
                          ("node", "pod_uid", "container", "uuid"))
        g_musage = Gauge("vtpu_container_memory_used_bytes",
                         "HBM bytes recorded by the container's processes",
                         ("node", "pod_uid", "container", "uuid"))
        g_mem_pct = Gauge("vtpu_container_memory_utilization_percent",
                          "Used bytes over the container's cap (0-100)",
                          ("node", "pod_uid", "container", "uuid"))
        g_cutil = Gauge("vtpu_container_utilization_percent",
                        "Chip duty-cycle share attributed to the container",
                        ("node", "pod_uid", "container", "uuid"))
        g_heartbeat = Gauge("vtpu_container_heartbeat_age_seconds",
                            "Seconds since the container's processes last "
                            "touched the ledger (staleness signal)",
                            ("node", "pod_uid", "container"))
        g_assigned = Gauge("vtpu_device_assigned_containers",
                           "Containers sharing each chip",
                           ("node", "uuid"))
        g_peak = Gauge("vtpu_device_assigned_containers_peak",
                       "Peak concurrent containers per chip since monitor "
                       "start",
                       ("node", "uuid"))
        g_cores_total = Gauge("vtpu_device_cores_total_percent",
                              "Allocatable core budget per chip (100)",
                              ("node", "uuid", "index"))
        g_cores_assigned = Gauge("vtpu_device_cores_assigned_percent",
                                 "Sum of assigned core percents per chip",
                                 ("node", "uuid", "index"))
        g_dev_assigned_mem = Gauge(
            "vtpu_device_memory_assigned_bytes",
            "Sum of assigned caps per chip (virtual)",
            ("node", "uuid", "index"))
        g_dev_assigned_pmem = Gauge(
            "vtpu_device_memory_assigned_physical_bytes",
            "Sum of physically-clamped assigned caps per chip",
            ("node", "uuid", "index"))
        g_proc_mem = Gauge("vtpu_process_memory_used_bytes",
                           "Per-process HBM bytes from the ledger",
                           ("node", "pod_uid", "container", "uuid", "pid"))
        g_proc_util = Gauge("vtpu_process_utilization_percent",
                            "Per-process duty-cycle share from the feed",
                            ("node", "pod_uid", "container", "uuid", "pid"))
        g_map_mismatch = Gauge(
            "vtpu_container_pod_mapping_mismatch",
            "1 when the kubelet does not corroborate this config-dir's "
            "pod/container attribution (orphaned dir, spoofed name, or "
            "plugin/kubelet disagreement); 0 when corroborated. Rows "
            "appear only for device-plugin tenants while a kubelet "
            "source is reachable",
            ("node", "pod_uid", "container"))
        g_map_source = Gauge(
            "vtpu_node_pod_mapping_source",
            "Attribution cross-check source: 3=socket+checkpoint "
            "(pair-keyed, strongest), 2=pod-resources socket only, "
            "1=kubelet checkpoint only, 0=none reachable",
            ("node",))

        assigned: dict[str, int] = {}
        cores_assigned: dict[int, int] = {}
        mem_assigned: dict[int, int] = {}
        pmem_assigned: dict[int, int] = {}
        tenant_by_token: dict[int, tuple[str, str]] = {}
        now_ns = time.monotonic_ns()
        configs = self._container_configs()
        # dial the kubelet only when there is something it can judge: a
        # DRA-only node (or an empty one) must not pay a gRPC List (up to
        # 2 s) per scrape for a result every tenant would skip
        view = None

        def publish_source(v) -> None:
            g_map_source.set((self.node_name,),
                             {"podresources+checkpoint": 3.0,
                              "podresources": 2.0,
                              "checkpoint": 1.0}.get(v.source, 0.0))

        if any(not is_dra for _, _, _, is_dra, _ in configs):
            view = self._kubelet_view()
            publish_source(view)
        for pod_uid, container, cfg, is_dra, cfg_mtime in configs:
            # DRA tenants flow through the kubelet's DRA path, which the
            # device-plugin-era pod-resources v1alpha1 API does not
            # report — only device-plugin tenants are judgeable
            if not is_dra and view is not None:
                verdict = view.corroborates(pod_uid, container)
                if verdict is False and self._kubelet_view_was_cached:
                    # never alarm off a stale view: a tenant started
                    # after the cached fetch would read as a mismatch
                    # until the TTL expired — refetch once and re-judge
                    view = self._kubelet_view(force=True)
                    verdict = view.corroborates(pod_uid, container)
                    # the gauge must advertise the source the remaining
                    # judgments actually use (a forced refetch can come
                    # back from another source, e.g. checkpoint only)
                    publish_source(view)
                if verdict is False and (
                        time.time() - cfg_mtime < STARTUP_GRACE_S):
                    # just-allocated tenant: the checkpoint can lag the
                    # allocation even on a fresh view, so a config dir
                    # younger than the grace window is unjudgeable
                    verdict = None
                if verdict is not None:
                    g_map_mismatch.set(
                        (self.node_name, pod_uid, container),
                        0.0 if verdict else 1.0)
                    if not verdict:
                        log.warning(
                            "config dir %s_%s not corroborated by kubelet "
                            "%s view", pod_uid, container, view.source)
            token = fnv64(f"{pod_uid}/{container}")
            tenant_by_token[token] = (pod_uid, container)
            for dev in cfg.devices:
                labels = (self.node_name, pod_uid, container, dev.uuid)
                phys_cap = (min(dev.total_memory, dev.real_memory)
                            if dev.real_memory else dev.total_memory)
                used = usage_by_token.get((token, dev.host_index), 0)
                g_climit.set(labels, float(dev.hard_core))
                g_mlimit.set(labels, float(dev.total_memory))
                g_mplimit.set(labels, float(phys_cap))
                g_musage.set(labels, float(used))
                if dev.total_memory:
                    g_mem_pct.set(labels,
                                  round(100.0 * used / dev.total_memory, 2))
                g_cutil.set(labels, float(
                    util_by_token.get((token, dev.host_index), 0)))
                if dev.host_index not in chip_by_index:
                    # stale config naming a removed/undiscovered chip:
                    # keep the container row (it reflects on-disk truth)
                    # but keep it OUT of chip/node aggregates, else
                    # sum(per-device rows) != node totals
                    continue
                assigned[dev.uuid] = assigned.get(dev.uuid, 0) + 1
                cores_assigned[dev.host_index] = \
                    cores_assigned.get(dev.host_index, 0) + dev.hard_core
                mem_assigned[dev.host_index] = \
                    mem_assigned.get(dev.host_index, 0) + dev.total_memory
                pmem_assigned[dev.host_index] = \
                    pmem_assigned.get(dev.host_index, 0) + phys_cap
            ts = heartbeat_by_token.get(token)
            if ts:
                g_heartbeat.set((self.node_name, pod_uid, container),
                                round(_age_seconds(ts, now_ns), 3))

        for chip in self.chips:
            labels = (self.node_name, chip.uuid, str(chip.index))
            g_cores_total.set(labels, 100.0)
            g_cores_assigned.set(
                labels, float(cores_assigned.get(chip.index, 0)))
            g_dev_assigned_mem.set(
                labels, float(mem_assigned.get(chip.index, 0)))
            g_dev_assigned_pmem.set(
                labels, float(pmem_assigned.get(chip.index, 0)))
        for uuid, count in assigned.items():
            g_assigned.set((self.node_name, uuid), float(count))
            self._peak_shared[uuid] = max(self._peak_shared.get(uuid, 0),
                                          count)
        for uuid, peak in self._peak_shared.items():
            g_peak.set((self.node_name, uuid), float(peak))

        # per-process breakdown, attributed through the owner token; rows
        # whose token matches no live container config are skipped (stale
        # tenants are the reaper's business, not the scrape's)
        for entry in ledger_entries:
            tenant = tenant_by_token.get(entry.owner_token)
            chip = chip_by_index.get(entry.host_index)
            if tenant is None or chip is None:
                continue
            g_proc_mem.set((self.node_name, tenant[0], tenant[1],
                            chip.uuid, str(entry.pid)), float(entry.bytes))
        for token, index, pid, util in proc_utils:
            tenant = tenant_by_token.get(token)
            chip = chip_by_index.get(index)
            if tenant is None or chip is None:
                continue
            g_proc_util.set((self.node_name, tenant[0], tenant[1],
                             chip.uuid, str(pid)), float(util))

        gauges += [g_climit, g_mlimit, g_mplimit, g_musage, g_mem_pct,
                   g_cutil, g_heartbeat, g_assigned, g_peak, g_cores_total,
                   g_cores_assigned, g_dev_assigned_mem, g_dev_assigned_pmem,
                   g_proc_mem, g_proc_util, g_map_mismatch, g_map_source]

        # ---- node aggregates + info ----
        g_total = Gauge("vtpu_node_slots_total", "Node vTPU slot capacity",
                        ("node",))
        g_used = Gauge("vtpu_node_slots_assigned", "Assigned vTPU slots",
                       ("node",))
        g_node_mem = Gauge("vtpu_node_memory_total_bytes",
                           "Physical HBM across the node's chips", ("node",))
        g_node_assigned_mem = Gauge(
            "vtpu_node_memory_assigned_bytes",
            "Assigned caps across the node (virtual)", ("node",))
        g_node_assigned_pmem = Gauge(
            "vtpu_node_memory_assigned_physical_bytes",
            "Physically-clamped assigned caps across the node", ("node",))
        g_info = Gauge("vtpu_node_info",
                       "Static node/manager build info (value always 1)",
                       ("node", "version", "resource_domain",
                        "annotation_domain", "chips"))
        g_total.set((self.node_name,),
                    float(sum(c.split_count for c in self.chips)))
        g_used.set((self.node_name,), float(sum(assigned.values())))
        g_node_mem.set((self.node_name,),
                       float(sum(c.memory for c in self.chips)))
        g_node_assigned_mem.set((self.node_name,),
                                float(sum(mem_assigned.values())))
        g_node_assigned_pmem.set((self.node_name,),
                                 float(sum(pmem_assigned.values())))
        g_info.set((self.node_name, vtpu_manager_torch.__version__,
                    consts.resource_domain(), consts.annotation_domain(),
                    str(len(self.chips))), 1.0)
        gauges += [g_total, g_used, g_node_mem, g_node_assigned_mem,
                   g_node_assigned_pmem, g_info]
        return gauges

    def _render_spill(self) -> str:
        """The node's spill series (JAX `collector.py:580-620`): the rings'
        spill signal and events beside the pool directory's own bytes. A
        failed fold costs a warning, never the scrape."""
        from vtpu_manager_torch.overcommit.spill import pool_totals
        try:
            self.oc_ledger.fold()
        except Exception:  # noqa: BLE001 - the scrape goes on
            log.warning("overcommit ledger fold failed", exc_info=True)
        frac, ring_bytes = self.oc_ledger.node_spill_signal()
        pool_files, pool_bytes = pool_totals(self.spill_dir)
        node = f'node="{self.node_name}"'
        families = (
            ("vtpu_node_spill_step_fraction", "gauge", "Fraction of recent "
             "steps that paid a host-tier spill or fill",
             f"{round(frac, 4):g}"),
            ("vtpu_node_spilled_bytes", "gauge", "Live host-pool footprint "
             "reported by tenant step rings", ring_bytes),
            ("vtpu_node_spill_pool_bytes", "gauge", "Bytes currently in the "
             "node's spill pool directory", pool_bytes),
            ("vtpu_node_spill_pool_files", "gauge", "Files currently in the "
             "node's spill pool directory", pool_files),
            ("vtpu_node_spill_events_total", "counter", "HBM->host "
             "demotions observed across tenant step rings",
             self.oc_ledger.spill_events_total),
            ("vtpu_node_fill_events_total", "counter", "host->HBM "
             "promotions observed across tenant step rings",
             self.oc_ledger.fill_events_total))
        lines = []
        for name, kind, help_text, value in families:
            lines += [f"# HELP {name} {help_text}", f"# TYPE {name} {kind}",
                      f"{name}{{{node}}} {value}"]
        return "\n".join(lines) + "\n"

    def render(self) -> str:
        t0 = time.perf_counter()
        text = "\n".join(g.render() for g in self.collect() if g.samples
                         or True) + "\n"
        # the step rings: per-pod histograms and the node pressure
        # rollup. No rings renders the headers only.
        self._feed_errors["telemetry"] = 0.0
        try:
            if self.telemetry.scan():
                # rings that EXIST but won't read: their tenants' series
                # are being served stale — same posture as a wedged
                # tc_util/vmem file
                self._feed_errors["telemetry"] = 1.0
        except OSError:
            self._feed_errors["telemetry"] = 1.0
            log.warning("step-telemetry scan failed", exc_info=True)
        text += self.telemetry.render(self.node_name)
        text += self.telemetry.render_pressure(
            self.node_name, sum(c.memory for c in self.chips))
        # the compile cache's node counters; no cache root renders the
        # headers only
        text += render_node_metrics(
            os.path.join(self.base_dir, consts.COMPILE_CACHE_SUBDIR),
            self.node_name)
        if self.oc_ledger is not None:
            text += self._render_spill()
        # self-observability: the scrape's own duration and per-feed
        # last-error flags, rendered last so a wedged feed still reports
        self._last_scrape_s = time.perf_counter() - t0
        g_dur = Gauge("vtpu_node_scrape_duration_seconds",
                      "Wall time of this collector scrape (gauges + "
                      "telemetry fold)", ("node",))
        g_dur.set((self.node_name,), round(self._last_scrape_s, 6))
        g_err = Gauge("vtpu_node_scrape_last_error",
                      "1 when the feed's last read failed (stale gauges "
                      "are being served)", ("node", "feed"))
        for feed in sorted(self._feed_errors):
            g_err.set((self.node_name, feed), self._feed_errors[feed])
        return text + g_dur.render() + "\n" + g_err.render() + "\n"
