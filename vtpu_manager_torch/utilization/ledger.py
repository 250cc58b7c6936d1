"""The node's utilization ledger: each tenant's allocated against used share.

The port of the JAX package's `utilization/ledger.py`, whole. Per tenant
(pod_uid, container) x chip it keeps

    allocated_core_pct / used_core_pct / allocated_hbm /
    hbm_highwater / throttle_wait_frac

from what the port's node-side parts write: each container's `vtpu.config`
(the allocation, `config/tenantdirs.py`), the node watcher's feed (each
tenant's measured share of the card, keyed by owner token,
`config/tc_watcher.py`) and each tenant's step ring (`telemetry/stepring.py`,
written by the interposer or the tenant's Python writer). `used_core_pct`
takes the feed's share where the feed has the tenant, else the ring's busy
fraction, (duration - throttle wait) / the fold's window, as an EWMA with
an EWMA variance beside it. A metered step's record holds its time off
the card as its throttle wait and its bucket's wait apart
(`stepring.FLAG_BUCKET_WAIT`); `throttle_wait_frac`, which the quota
market reads as throttle-bound, is the bucket's wait over the steps'
time, as the reference's records give it. A chip's reclaimable headroom is

    sum over fresh tenants of
        max(0, allocated - (used_ewma + K * sigma)) * confidence

so a bursty tenant's quota is judged by its envelope, not its mean; HBM's
by the ring's high-water. Each tenant's confidence falls linearly from 1
at its last sample to 0 over STALENESS_S, and a tenant without signal
reclaims nothing.

`fold(budget_s=...)` is time-boxed: it folds rings round-robin from where
the previous fold stopped and counts the rings it did not reach, so a
scrape never waits on hundreds of rings. The policy's publisher folds on
its thread while Allocate reads, so a lock guards the state.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time

from vtpu_manager_torch.config.tc_watcher import TcUtilFile
from vtpu_manager_torch.config.tenantdirs import iter_container_configs
from vtpu_manager_torch.config.vmem import fnv64
from vtpu_manager_torch.resilience import failpoints
from vtpu_manager_torch.telemetry import stepring
from vtpu_manager_torch.util import consts
from vtpu_manager_torch.utilization.headroom import ChipHeadroom, NodeHeadroom

log = logging.getLogger(__name__)

# EWMA smoothing for the used-core samples; about 3-4 windows dominate
EWMA_ALPHA = 0.3
# the burstiness discount: reclaimable is judged against mean + K * sigma
BURST_SIGMA_K = 2.0
# a tenant with no sample for this long is no signal (confidence 0)
STALENESS_S = 120.0

ALLOC_CORE = "vtpu_utilization_allocated_core_percent"
USED_CORE = "vtpu_utilization_used_core_percent"
ALLOC_HBM = "vtpu_utilization_allocated_hbm_bytes"
HBM_HW = "vtpu_utilization_hbm_highwater_bytes"
WAIT_FRAC = "vtpu_utilization_throttle_wait_fraction"
CONFIDENCE = "vtpu_utilization_confidence"
RECLAIM_CORE = "vtpu_reclaimable_headroom_core_percent"
RECLAIM_HBM = "vtpu_reclaimable_headroom_hbm_bytes"
RECLAIM_CONF = "vtpu_reclaimable_headroom_confidence"
FOLDS_DROPPED = "vtpu_utilization_folds_dropped_total"
FOLD_SECONDS = "vtpu_utilization_fold_seconds"


def _decayed(samples: int, last_wall: float, now_wall: float) -> float:
    """1 at a sample, 0 after STALENESS_S; never sampled is 0, and a clock
    that stepped back reads fresh."""
    if not samples or not last_wall:
        return 0.0
    age = now_wall - last_wall
    if age < 0:
        return 1.0
    return max(0.0, 1.0 - age / STALENESS_S)


class _CommStat:
    """One ring's measured communication: EWMAs over the records whose
    comm block is not zero (an unarmed ring writes zeros, which are no
    signal, not a measured zero)."""

    __slots__ = ("duty_ewma", "bytes_per_step_ewma", "collectives_total",
                 "samples", "last_sample_wall")

    def __init__(self) -> None:
        self.duty_ewma = 0.0          # comm seconds per wall second
        self.bytes_per_step_ewma = 0.0
        self.collectives_total = 0
        self.samples = 0
        self.last_sample_wall = 0.0

    def observe(self, duty_frac: float, bytes_per_step: float,
                collectives: int, now_wall: float) -> None:
        duty_frac = min(max(duty_frac, 0.0), 1.0)
        if self.samples == 0:
            # seeded with the first sample, not 0
            self.duty_ewma = duty_frac
            self.bytes_per_step_ewma = bytes_per_step
        else:
            self.duty_ewma += EWMA_ALPHA * (duty_frac - self.duty_ewma)
            self.bytes_per_step_ewma += EWMA_ALPHA * (
                bytes_per_step - self.bytes_per_step_ewma)
        self.collectives_total += collectives
        self.samples += 1
        self.last_sample_wall = now_wall

    def confidence(self, now_wall: float) -> float:
        return _decayed(self.samples, self.last_sample_wall, now_wall)


class _TenantChip:
    """The EWMA state of one (pod_uid, container) x chip."""

    __slots__ = ("pod_uid", "container", "pod_name", "pod_namespace",
                 "trace_id", "host_index", "uuid", "alloc_core_pct",
                 "alloc_hbm", "used_ewma", "used_var", "wait_frac",
                 "hbm_highwater", "last_sample_wall", "samples",
                 "workload_class", "used_source")

    def __init__(self, pod_uid: str, container: str, host_index: int,
                 uuid: str):
        self.pod_uid = pod_uid
        self.container = container
        self.pod_name = ""
        self.pod_namespace = ""
        self.trace_id = ""
        self.host_index = host_index
        self.uuid = uuid
        self.alloc_core_pct = 0.0
        self.alloc_hbm = 0
        self.used_ewma = 0.0
        self.used_var = 0.0
        self.wait_frac = 0.0
        self.hbm_highwater = 0
        self.last_sample_wall = 0.0
        self.samples = 0
        # the config's workload class (keys the overcommit policy's
        # per-class ratios and the annotation's class mix)
        self.workload_class = 0
        # where the last used sample came from: "feed", "ring" or ""
        # (not on the wire; the card's checks read it)
        self.used_source = ""

    def observe_used(self, used_pct: float, now_wall: float) -> None:
        used_pct = min(max(used_pct, 0.0), 100.0)
        if self.samples == 0:
            # seeded with the first sample: from 0 a steady tenant would
            # read as reclaimable through the warm-up
            self.used_ewma = used_pct
            self.used_var = 0.0
        else:
            delta = used_pct - self.used_ewma
            self.used_ewma += EWMA_ALPHA * delta
            self.used_var = ((1.0 - EWMA_ALPHA) * self.used_var
                             + EWMA_ALPHA * delta * delta)
        self.samples += 1
        self.last_sample_wall = now_wall

    def confidence(self, now_wall: float) -> float:
        return _decayed(self.samples, self.last_sample_wall, now_wall)

    def reclaim_core_pct(self, now_wall: float) -> float:
        conf = self.confidence(now_wall)
        if conf <= 0.0:
            return 0.0
        envelope = self.used_ewma + BURST_SIGMA_K * math.sqrt(
            max(self.used_var, 0.0))
        return max(0.0, self.alloc_core_pct - envelope) * conf

    def reclaim_hbm_bytes(self, now_wall: float) -> int:
        conf = self.confidence(now_wall)
        if conf <= 0.0:
            return 0
        return int(max(0, self.alloc_hbm - self.hbm_highwater) * conf)

    def to_wire(self, now_wall: float) -> dict:
        return {
            "pod_uid": self.pod_uid,
            "container": self.container,
            "pod_name": self.pod_name,
            "pod_namespace": self.pod_namespace,
            "trace_id": self.trace_id,
            "chip_index": self.host_index,
            "chip_uuid": self.uuid,
            "allocated_core_pct": round(self.alloc_core_pct, 2),
            "used_core_pct": round(self.used_ewma, 2),
            "allocated_hbm_bytes": self.alloc_hbm,
            "hbm_highwater_bytes": self.hbm_highwater,
            "throttle_wait_frac": round(self.wait_frac, 4),
            "reclaimable_core_pct": round(
                self.reclaim_core_pct(now_wall), 2),
            "reclaimable_hbm_bytes": self.reclaim_hbm_bytes(now_wall),
            "confidence": round(self.confidence(now_wall), 3),
            "stale": self.confidence(now_wall) <= 0.0,
        }


class _RingCursor:
    __slots__ = ("cursor", "last_poll_monotonic")

    def __init__(self) -> None:
        self.cursor = 0
        # None = never polled; 0.0 is a real stamp under a test's clock
        self.last_poll_monotonic: float | None = None


class UtilizationLedger:
    """One node's fold of rings, configs and the watcher's feed."""

    _CLASS_KEYS = {1: "lat", 2: "thr"}     # the config's class -> wire key

    def __init__(self, node_name: str, chips: list,
                 base_dir: str = consts.MANAGER_BASE_DIR,
                 tc_path: str | None = None):
        self.node_name = node_name
        self.chips = list(chips)
        self.base_dir = base_dir
        self.tc_path = tc_path
        self._states: dict[tuple[str, str, int], _TenantChip] = {}
        self._cursors: dict[tuple[str, str], _RingCursor] = {}
        # where the budgeted fold resumes
        self._resume = 0
        self.folds_dropped_total = 0
        self.last_fold_s = 0.0
        self.last_fold_wall = 0.0
        # per ring: (steps, steps that spilled or filled, spilled bytes of
        # the newest record, wall time) of the last fold with records, and
        # the event totals the exporter's spill series count
        self._ring_spill: dict[tuple[str, str],
                               tuple[int, int, int, float]] = {}
        self.spill_events_total = 0
        self.fill_events_total = 0
        # per ring: the comm block's EWMAs, and the movement totals
        self._ring_comm: dict[tuple[str, str], _CommStat] = {}
        self.comm_bytes_total = 0
        self.collectives_total = 0
        self._lock = threading.RLock()

    # -- the inputs ------------------------------------------------------

    def _configs(self) -> list[tuple[str, str, object]]:
        """(pod_uid, container label, config) of every device-plugin and
        DRA tenant, by the walk the collector uses: the owner-token join
        with the feed holds only if both make the same labels."""
        return [(pod_uid, label, cfg)
                for pod_uid, label, cfg, _is_dra, _mtime
                in iter_container_configs(self.base_dir)]

    def _tc_util_by_token(self) -> dict[tuple[int, int], int]:
        """(owner token, chip index) -> the feed's measured share %; empty
        without a feed or when it cannot be read (the ring then serves)."""
        out: dict[tuple[int, int], int] = {}
        if not self.tc_path:
            return out
        try:
            tc = TcUtilFile(self.tc_path)
            try:
                for chip in self.chips:
                    rec = tc.read_device(chip.index)
                    if rec is None:
                        continue
                    for proc in rec.procs:
                        key = (proc.owner_token, chip.index)
                        out[key] = out.get(key, 0) + proc.util
            finally:
                tc.close()
        except (OSError, ValueError):
            return {}
        return out

    # -- the fold --------------------------------------------------------

    def fold(self, budget_s: float | None = None,
             now_mono: float | None = None,
             now_wall: float | None = None) -> int:
        """One pass: the configs (the allocation), each tenant's ring since
        its cursor, the feed. Returns how many existing rings could not be
        read. Past `budget_s` the remaining rings are counted as dropped
        and the next pass starts with them; the budget is checked after
        each ring, so every pass folds at least one."""
        failpoints.fire("util.fold", node=self.node_name)
        t0 = time.perf_counter()
        now_mono = time.monotonic() if now_mono is None else now_mono
        now_wall = time.time() if now_wall is None else now_wall
        with self._lock:
            return self._fold(t0, budget_s, now_mono, now_wall)

    def _fold(self, t0: float, budget_s: float | None, now_mono: float,
              now_wall: float) -> int:
        failed = 0
        live_keys: set[tuple[str, str, int]] = set()
        ring_keys: list[tuple[str, str]] = []
        token_of: dict[tuple[str, str], int] = {}
        devices_of: dict[tuple[str, str], list] = {}
        for pod_uid, container, cfg in self._configs():
            tkey = (pod_uid, container)
            token_of[tkey] = fnv64(f"{pod_uid}/{container}")
            if tkey not in devices_of:
                ring_keys.append(tkey)
            devices_of.setdefault(tkey, []).extend(cfg.devices)
            for dev in cfg.devices:
                key = (pod_uid, container, dev.host_index)
                live_keys.add(key)
                state = self._states.get(key)
                if state is None:
                    state = self._states[key] = _TenantChip(
                        pod_uid, container, dev.host_index, dev.uuid)
                state.pod_name = cfg.pod_name
                state.pod_namespace = cfg.pod_namespace
                state.alloc_core_pct = float(dev.hard_core)
                state.alloc_hbm = int(dev.total_memory)
                state.workload_class = int(cfg.workload_class)
        # a removed tenant's rows go with it
        for key in list(self._states):
            if key not in live_keys:
                del self._states[key]
        for tkey in list(self._cursors):
            if tkey not in devices_of:
                del self._cursors[tkey]
                self._ring_spill.pop(tkey, None)
                self._ring_comm.pop(tkey, None)

        tc_util = self._tc_util_by_token()
        n = len(ring_keys)
        folded = 0
        for i in range(n):
            tkey = ring_keys[(self._resume + i) % n]
            folded += 1
            failed += self._fold_ring(tkey, token_of[tkey],
                                      devices_of[tkey], tc_util,
                                      now_mono, now_wall)
            if budget_s is not None and folded < n and \
                    time.perf_counter() - t0 > budget_s:
                self.folds_dropped_total += n - folded
                self._resume = (self._resume + folded) % max(n, 1)
                break
        else:
            self._resume = 0
        self.last_fold_s = time.perf_counter() - t0
        self.last_fold_wall = now_wall
        return failed

    def _fold_ring(self, tkey: tuple[str, str], token: int,
                   devices: list, tc_util: dict,
                   now_mono: float, now_wall: float) -> int:
        pod_uid, container = tkey
        entry = f"{pod_uid}_{container.split('/', 1)[0]}"
        ring_path = os.path.join(self.base_dir, entry,
                                 consts.TELEMETRY_SUBDIR,
                                 consts.STEP_RING_NAME)
        cur = self._cursors.get(tkey)
        if cur is None:
            cur = self._cursors[tkey] = _RingCursor()
        total_alloc = sum(float(d.hard_core) for d in devices) or 1.0
        total_hbm = sum(int(d.total_memory) for d in devices) or 1

        records: list[stepring.StepRecord] = []
        trace_id = ""
        if os.path.isfile(ring_path):
            try:
                reader = stepring.StepRingReader(ring_path)
            except (OSError, ValueError) as e:
                log.warning("utilization: ring %s unreadable: %s",
                            ring_path, e)
                return 1
            try:
                trace_id = reader.trace_id
                records, cur.cursor, _ = reader.poll(cur.cursor)
            finally:
                reader.close()

        if records:
            # the spill signal: steps that paid a tier transition in this
            # window and the newest record's footprint; a quiet ring keeps
            # its last value and ages out by its wall time
            spilling = sum(1 for r in records
                           if r.spill_events or r.fill_events)
            self._ring_spill[tkey] = (len(records), spilling,
                                      records[-1].spilled_bytes, now_wall)
            self.spill_events_total += sum(r.spill_events
                                           for r in records)
            self.fill_events_total += sum(r.fill_events for r in records)
        window_s = (now_mono - cur.last_poll_monotonic
                    if cur.last_poll_monotonic is not None else 0.0)
        # a window whose comm blocks are all zero is no signal
        comm_ns = sum(r.comm_time_ns for r in records)
        comm_bytes = sum(r.bytes_transferred for r in records)
        collectives = sum(r.collective_count for r in records)
        if comm_ns or comm_bytes or collectives:
            # the totals count every record, the first fold's backlog too;
            # the EWMA needs a window
            self.comm_bytes_total += comm_bytes
            self.collectives_total += collectives
            if window_s > 0:
                stat = self._ring_comm.get(tkey)
                if stat is None:
                    stat = self._ring_comm[tkey] = _CommStat()
                stat.observe(comm_ns / 1e9 / window_s,
                             comm_bytes / len(records), collectives,
                             now_wall)
        dur_sum = sum(r.duration_ns for r in records) / 1e9
        wait_sum = sum(r.throttle_wait_ns for r in records) / 1e9
        hbm_hw = max((r.hbm_highwater_bytes for r in records), default=0)
        busy_frac = 0.0
        if window_s > 0:
            busy_frac = max(0.0, dur_sum - wait_sum) / window_s
        # throttle-bound is the bucket's wait alone, never the time a
        # metered step spends behind co-tenants' slices
        bucket_sum = sum(r.bucket_wait_ns for r in records) / 1e9
        wait_frac = bucket_sum / dur_sum if dur_sum else 0.0

        for dev in devices:
            state = self._states.get((pod_uid, container, dev.host_index))
            if state is None:
                continue
            state.trace_id = trace_id or state.trace_id
            # the feed's measured share wins; the ring's busy fraction,
            # shared out by allocated core (the ring is per tenant, not
            # per chip), is the fallback
            tc_sample = tc_util.get((token, dev.host_index))
            if tc_sample is not None:
                state.observe_used(float(tc_sample), now_wall)
                state.used_source = "feed"
            elif records and window_s > 0:
                share = float(dev.hard_core) / total_alloc
                state.observe_used(100.0 * busy_frac * share, now_wall)
                state.used_source = "ring"
            # a ring with no new record is no sample: the confidence goes
            # on decaying (a dead writer must not read as steadily idle)
            if records:
                state.wait_frac = wait_frac
                hbm_share = int(dev.total_memory) / total_hbm
                state.hbm_highwater = max(
                    state.hbm_highwater, int(hbm_hw * hbm_share))
        cur.last_poll_monotonic = now_mono
        return 0

    # -- the overcommit policy's inputs ----------------------------------

    def hbm_fraction_samples(self, now_wall: float | None = None
                             ) -> dict[str, list[tuple[float, float]]]:
        """Per workload class, (high-water / allocated, confidence) of
        each sampled tenant x chip: the policy's percentile input."""
        now_wall = time.time() if now_wall is None else now_wall
        out: dict[str, list[tuple[float, float]]] = {}
        with self._lock:
            for s in self._states.values():
                if s.alloc_hbm <= 0 or not s.samples:
                    continue
                key = self._CLASS_KEYS.get(s.workload_class, "def")
                out.setdefault(key, []).append(
                    (min(s.hbm_highwater / s.alloc_hbm, 1.0),
                     s.confidence(now_wall)))
        return out

    def node_spill_signal(self, now_wall: float | None = None
                          ) -> tuple[float, int]:
        """(fraction of recent steps that spilled or filled, spilled bytes
        summed over the rings); a ring quiet past STALENESS_S drops out."""
        now_wall = time.time() if now_wall is None else now_wall
        steps = spilling = spilled = 0
        with self._lock:
            rings = list(self._ring_spill.values())
        for n, spill_n, gauge, ts in rings:
            if now_wall - ts > STALENESS_S:
                continue
            steps += n
            spilling += spill_n
            spilled += gauge
        frac = spilling / steps if steps else 0.0
        return min(max(frac, 0.0), 1.0), spilled

    # -- measured communication --------------------------------------------

    def comm_signals(self, now_wall: float | None = None
                     ) -> dict[tuple[str, str], tuple[float, float]]:
        """Per tenant ring with a live confidence, (comm duty EWMA,
        confidence); a stale writer leaves the map."""
        now_wall = time.time() if now_wall is None else now_wall
        out: dict[tuple[str, str], tuple[float, float]] = {}
        with self._lock:
            for tkey, stat in self._ring_comm.items():
                conf = stat.confidence(now_wall)
                if conf > 0.0:
                    out[tkey] = (stat.duty_ewma, conf)
        return out

    def _compute_duty_of(self, tkey: tuple[str, str]) -> float:
        """The tenant's mean measured compute duty over its chips, in
        [0, 1]."""
        vals = [s.used_ewma / 100.0 for s in self._states.values()
                if (s.pod_uid, s.container) == tkey and s.samples]
        return sum(vals) / len(vals) if vals else 0.0

    def comm_rows(self, now_wall: float | None = None) -> list[dict]:
        """Per tenant, the measured communication rows of /utilization."""
        now_wall = time.time() if now_wall is None else now_wall
        rows = []
        with self._lock:
            for tkey in sorted(self._ring_comm):
                stat = self._ring_comm[tkey]
                conf = stat.confidence(now_wall)
                compute_duty = self._compute_duty_of(tkey)
                rows.append({
                    "pod_uid": tkey[0],
                    "container": tkey[1],
                    # comm seconds per wall second
                    "comm_duty_frac": round(stat.duty_ewma, 4),
                    "comm_bytes_per_step": int(stat.bytes_per_step_ewma),
                    "collectives_total": stat.collectives_total,
                    # link duty per unit of compute duty
                    "comm_intensity": round(
                        stat.duty_ewma / compute_duty, 3)
                        if compute_duty > 0 else None,
                    "confidence": round(conf, 3),
                    "stale": conf <= 0.0,
                })
        return rows

    def class_mix(self) -> dict[str, int]:
        """Distinct resident tenants per classified workload class (the
        annotation's mix segment); unclassified tenants are left out, so
        a node that stamps no class publishes the mix-less bytes."""
        seen: dict[str, set] = {}
        with self._lock:
            for s in self._states.values():
                key = self._CLASS_KEYS.get(s.workload_class)
                if key is not None:
                    seen.setdefault(key, set()).add((s.pod_uid, s.container))
        return {k: len(v) for k, v in seen.items()}

    # -- the outputs ------------------------------------------------------

    def tenants(self) -> list[_TenantChip]:
        with self._lock:
            return sorted(self._states.values(),
                          key=lambda s: (s.pod_uid, s.container,
                                         s.host_index))

    def chip_rollup(self, now_wall: float | None = None
                    ) -> dict[int, dict]:
        """Per chip, the sums over its tenants: the headroom rollup."""
        now_wall = time.time() if now_wall is None else now_wall
        out: dict[int, dict] = {}
        for chip in self.chips:
            out[chip.index] = {
                "index": chip.index, "uuid": chip.uuid,
                "alloc_core_pct": 0.0, "used_core_pct": 0.0,
                "alloc_hbm_bytes": 0, "hbm_highwater_bytes": 0,
                "reclaim_core_pct": 0.0, "reclaim_hbm_bytes": 0,
                "confidence": 1.0, "tenants": 0,
            }
        with self._lock:
            states = list(self._states.values())
        for s in states:
            row = out.get(s.host_index)
            if row is None:
                continue        # a stale config naming a removed chip
            conf = s.confidence(now_wall)
            row["alloc_core_pct"] += s.alloc_core_pct
            row["used_core_pct"] += s.used_ewma * conf
            row["alloc_hbm_bytes"] += s.alloc_hbm
            row["hbm_highwater_bytes"] += s.hbm_highwater
            row["reclaim_core_pct"] += s.reclaim_core_pct(now_wall)
            row["reclaim_hbm_bytes"] += s.reclaim_hbm_bytes(now_wall)
            row["confidence"] = min(row["confidence"], conf)
            row["tenants"] += 1
        for row in out.values():
            row["used_core_pct"] = round(row["used_core_pct"], 2)
            row["reclaim_core_pct"] = round(row["reclaim_core_pct"], 2)
            row["alloc_core_pct"] = round(row["alloc_core_pct"], 2)
            row["confidence"] = round(row["confidence"], 3)
        return out

    def headroom(self, now_wall: float | None = None) -> NodeHeadroom:
        """The annotation's payload (`utilization/headroom.py`)."""
        now_wall = time.time() if now_wall is None else now_wall
        chips = {}
        for idx, row in self.chip_rollup(now_wall).items():
            chips[idx] = ChipHeadroom(
                alloc_core_pct=row["alloc_core_pct"],
                used_core_pct=row["used_core_pct"],
                reclaim_core_pct=row["reclaim_core_pct"],
                reclaim_hbm_bytes=row["reclaim_hbm_bytes"])
        return NodeHeadroom(chips=chips, ts=now_wall,
                            class_mix=self.class_mix())

    def to_wire(self, now_wall: float | None = None) -> dict:
        now_wall = time.time() if now_wall is None else now_wall
        chips = list(self.chip_rollup(now_wall).values())
        return {
            "node": self.node_name,
            "chips": chips,
            "tenants": [s.to_wire(now_wall) for s in self.tenants()],
            "reclaimable_core_pct": round(
                sum(c["reclaim_core_pct"] for c in chips), 2),
            "reclaimable_hbm_bytes": sum(
                c["reclaim_hbm_bytes"] for c in chips),
            "folds_dropped_total": self.folds_dropped_total,
            "last_fold_s": round(self.last_fold_s, 6),
        }

    def render(self, now_wall: float | None = None) -> str:
        """The exporter's vtpu_utilization_* and vtpu_reclaimable_*
        families (gate on only)."""
        now_wall = time.time() if now_wall is None else now_wall
        node = self.node_name
        tenants = self.tenants()

        def tlabels(s: _TenantChip) -> str:
            return (f'node="{node}",pod_uid="{s.pod_uid}",'
                    f'container="{s.container}",uuid="{s.uuid}"')

        per_tenant = (
            (ALLOC_CORE, "Assigned core percent (vtuse ledger view)",
             lambda s: f"{s.alloc_core_pct:g}"),
            (USED_CORE, "EWMA of the tenant's measured core use on the chip",
             lambda s: f"{round(s.used_ewma, 2):g}"),
            (ALLOC_HBM, "Assigned HBM cap (vtuse ledger view)",
             lambda s: f"{s.alloc_hbm}"),
            (HBM_HW, "Step-ring HBM high-water attributed to the tenant's "
             "share of the chip", lambda s: f"{s.hbm_highwater}"),
            (WAIT_FRAC, "Fraction of step time stalled in the throttle over "
             "the last fold window", lambda s: f"{round(s.wait_frac, 4):g}"),
            (CONFIDENCE, "Sample freshness in [0,1]; 0 = no-signal (dead "
             "writer decayed out)",
             lambda s: f"{round(s.confidence(now_wall), 3):g}"))
        lines = []
        for name, help_text, fmt in per_tenant:
            lines += [f"# HELP {name} {help_text}", f"# TYPE {name} gauge"]
            lines += [f"{name}{{{tlabels(s)}}} {fmt(s)}" for s in tenants]

        rollup = self.chip_rollup(now_wall)
        per_chip = (
            (RECLAIM_CORE, "Allocated-but-unused core % per chip, EWMA + "
             "burstiness discounted",
             lambda row: f'{row["reclaim_core_pct"]:g}'),
            (RECLAIM_HBM, "Allocated-minus-high-water HBM per chip, "
             "confidence discounted",
             lambda row: f'{row["reclaim_hbm_bytes"]}'),
            (RECLAIM_CONF, "Min tenant confidence feeding the chip's "
             "reclaim figures (0 = no-signal)",
             lambda row: f'{row["confidence"] if row["tenants"] else 0.0:g}'))
        for name, help_text, fmt in per_chip:
            lines += [f"# HELP {name} {help_text}", f"# TYPE {name} gauge"]
            lines += [f'{name}{{node="{node}",uuid="{rollup[idx]["uuid"]}",'
                      f'index="{idx}"}} {fmt(rollup[idx])}'
                      for idx in sorted(rollup)]
        lines += [f"# HELP {FOLDS_DROPPED} Ring folds skipped because "
                  f"the scrape-time budget ran out (resumed next pass)",
                  f"# TYPE {FOLDS_DROPPED} counter",
                  f'{FOLDS_DROPPED}{{node="{node}"}} '
                  f"{self.folds_dropped_total}",
                  f"# HELP {FOLD_SECONDS} Wall time of the last ledger "
                  f"fold",
                  f"# TYPE {FOLD_SECONDS} gauge",
                  f'{FOLD_SECONDS}{{node="{node}"}} '
                  f"{round(self.last_fold_s, 6):g}"]
        return "\n".join(lines) + "\n"


class HeadroomPublisher:
    """The device plugin's loop: fold the ledger, patch the node's
    reclaimable-headroom annotation every `interval_s`. A failed tick is
    logged; the annotation's stamp ages a silent publisher out."""

    def __init__(self, client, node_name: str, ledger: UtilizationLedger,
                 policy=None, interval_s: float = 15.0):
        from vtpu_manager_torch.resilience.policy import RetryPolicy
        self.client = client
        self.node_name = node_name
        self.ledger = ledger
        self.policy = policy or RetryPolicy(max_attempts=3, deadline_s=10.0)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def publish_once(self) -> NodeHeadroom:
        self.ledger.fold()
        hr = self.ledger.headroom()
        self.policy.run(
            lambda: self.client.patch_node_annotations(
                self.node_name,
                {consts.node_reclaimable_headroom_annotation():
                 hr.encode()}),
            op="utilization.headroom_patch")
        return hr

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.publish_once()
                except Exception:  # noqa: BLE001 - advisory; next tick
                    log.warning("headroom publish failed", exc_info=True)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="vtuse-headroom")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()


def utilization_stats_for_pod(base_dir: str, *keys: str) -> list[dict]:
    """One pod's used against allocated rows, read off its rings and
    configs at once (the `vtrace --pod` splice). `keys` match the config
    directory's pod uid or the ring's trace id. The window is the resident
    records' own span (first start to last end): a one-shot read has no
    second poll."""
    from vtpu_manager_torch.config import vtpu_config as vc
    wanted = {k for k in keys if k}
    out: list[dict] = []
    if not wanted or not os.path.isdir(base_dir):
        return out
    for entry in sorted(os.listdir(base_dir)):
        ring_path = os.path.join(base_dir, entry, consts.TELEMETRY_SUBDIR,
                                 consts.STEP_RING_NAME)
        if not os.path.isfile(ring_path):
            continue
        pod_uid, _, container = entry.partition("_")
        try:
            reader = stepring.StepRingReader(ring_path)
        except (OSError, ValueError):
            continue
        try:
            if not (wanted & {pod_uid, reader.trace_id}):
                continue
            records, _, _ = reader.poll(0)
            trace_id = reader.trace_id
        finally:
            reader.close()
        alloc_core = 0.0
        alloc_hbm = 0
        cfg_path = os.path.join(base_dir, entry, "config", "vtpu.config")
        try:
            cfg = vc.read_config(cfg_path)
            alloc_core = float(sum(d.hard_core for d in cfg.devices))
            alloc_hbm = int(sum(d.total_memory for d in cfg.devices))
        except (OSError, ValueError):
            pass
        dur_sum = sum(r.duration_ns for r in records) / 1e9
        wait_sum = sum(r.throttle_wait_ns for r in records) / 1e9
        bucket_sum = sum(r.bucket_wait_ns for r in records) / 1e9
        span_s = 0.0
        if records:
            first = min(r.start_mono_ns for r in records)
            last = max(r.start_mono_ns + r.duration_ns for r in records)
            span_s = max((last - first) / 1e9, 1e-9)
        used_pct = 100.0 * max(0.0, dur_sum - wait_sum) / span_s \
            if span_s else 0.0
        out.append({
            "pod_uid": pod_uid,
            "container": container,
            "trace_id": trace_id,
            "allocated_core_pct": alloc_core,
            "used_core_pct": round(min(used_pct, 100.0), 2),
            "allocated_hbm_bytes": alloc_hbm,
            "hbm_highwater_bytes": max(
                (r.hbm_highwater_bytes for r in records), default=0),
            "throttle_wait_frac": round(
                bucket_sum / dur_sum, 4) if dur_sum else 0.0,
        })
    return out
