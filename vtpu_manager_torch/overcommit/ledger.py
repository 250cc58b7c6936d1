"""The overcommit policy's evidence: each tenant's memory high-water
against its cap, and the node's spill activity, from the step rings.

The port of the two readers of the JAX package's utilization ledger that
`overcommit/policy.py` calls (`vtpu_manager/utilization/ledger.py:490
hbm_fraction_samples`, `:507 node_spill_signal`), with the part of its
fold (`:268-455`) that feeds them: the per-container configs (each
device's cap and the tenant's workload class), the watcher's feed (a
tenant's measured use, keyed by owner token) and each tenant's ring,
tailed by its own cursor (`telemetry/stepring.py`, the reader the
exporter's fold uses). The rest of that ledger (the used-core EWMA, the
reclaimable headroom, communication) belongs to the utilization plane,
which is not ported.

A tenant x device is sampled when the feed has its use or its ring gained
records since the previous fold; its confidence is 1 at a sample and
decays to 0 over STALENESS_S, so a class whose tenants went quiet decays
back to ratio 1.0.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from vtpu_manager_torch.config.tc_watcher import TcUtilFile
from vtpu_manager_torch.config.tenantdirs import iter_container_configs
from vtpu_manager_torch.config.vmem import fnv64
from vtpu_manager_torch.telemetry import stepring
from vtpu_manager_torch.util import consts

log = logging.getLogger(__name__)

# a tenant with no sample for this long is no signal (confidence 0)
STALENESS_S = 120.0

_CLASS_KEYS = {1: "lat", 2: "thr"}     # the config's class -> wire key


class _TenantDevice:
    __slots__ = ("alloc_hbm", "hbm_highwater", "workload_class", "samples",
                 "last_sample_wall")

    def __init__(self) -> None:
        self.alloc_hbm = 0
        self.hbm_highwater = 0
        self.workload_class = 0
        self.samples = 0
        self.last_sample_wall = 0.0

    def confidence(self, now_wall: float) -> float:
        if not self.samples or not self.last_sample_wall:
            return 0.0
        age = now_wall - self.last_sample_wall
        if age < 0:
            return 1.0      # a clock step backwards: fresh, not garbage
        return max(0.0, 1.0 - age / STALENESS_S)


class OvercommitLedger:
    """One node's fold of configs, feed and rings for the policy."""

    def __init__(self, chips: list, base_dir: str = consts.MANAGER_BASE_DIR,
                 tc_path: str | None = None):
        self.chips = list(chips)
        self.base_dir = base_dir
        self.tc_path = tc_path
        self._states: dict[tuple[str, str, int], _TenantDevice] = {}
        # per ring: its cursor and the monotonic time of its last fold
        self._cursors: dict[tuple[str, str], list] = {}
        # per ring: (steps, steps that spilled or filled, spilled bytes of
        # the newest record, wall time) of the last fold with records
        self._ring_spill: dict[tuple[str, str],
                               tuple[int, int, int, float]] = {}
        self.spill_events_total = 0
        self.fill_events_total = 0
        # the publisher folds on its thread while Allocate reads
        self._lock = threading.Lock()

    def _tc_util_by_token(self) -> dict[tuple[int, int], int]:
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

    def fold(self, now_mono: float | None = None,
             now_wall: float | None = None) -> int:
        """One pass over every tenant; returns how many existing rings
        could not be read."""
        now_mono = time.monotonic() if now_mono is None else now_mono
        now_wall = time.time() if now_wall is None else now_wall
        with self._lock:
            return self._fold(now_mono, now_wall)

    def _fold(self, now_mono: float, now_wall: float) -> int:
        live: set[tuple[str, str, int]] = set()
        devices_of: dict[tuple[str, str], list] = {}
        for pod_uid, label, cfg, _is_dra, _mtime in \
                iter_container_configs(self.base_dir):
            tkey = (pod_uid, label)
            devices_of.setdefault(tkey, []).extend(cfg.devices)
            for dev in cfg.devices:
                key = (pod_uid, label, dev.host_index)
                live.add(key)
                state = self._states.setdefault(key, _TenantDevice())
                state.alloc_hbm = int(dev.total_memory)
                state.workload_class = int(cfg.workload_class)
        for key in list(self._states):
            if key not in live:
                del self._states[key]
        for tkey in list(self._cursors):
            if tkey not in devices_of:
                del self._cursors[tkey]
                self._ring_spill.pop(tkey, None)
        tc_util = self._tc_util_by_token()
        failed = 0
        for tkey, devices in devices_of.items():
            failed += self._fold_ring(tkey, devices, tc_util, now_mono,
                                      now_wall)
        return failed

    def _fold_ring(self, tkey: tuple[str, str], devices: list,
                   tc_util: dict, now_mono: float, now_wall: float) -> int:
        pod_uid, label = tkey
        ring_path = os.path.join(
            self.base_dir, f"{pod_uid}_{label.split('/', 1)[0]}",
            consts.TELEMETRY_SUBDIR, consts.STEP_RING_NAME)
        cur = self._cursors.setdefault(tkey, [0, None])
        records: list = []
        if os.path.isfile(ring_path):
            try:
                reader = stepring.StepRingReader(ring_path)
            except (OSError, ValueError) as e:
                log.warning("overcommit: ring %s unreadable: %s",
                            ring_path, e)
                return 1
            try:
                records, cur[0], _ = reader.poll(cur[0])
            finally:
                reader.close()
        if records:
            spilling = sum(1 for r in records
                           if r.spill_events or r.fill_events)
            self._ring_spill[tkey] = (len(records), spilling,
                                      records[-1].spilled_bytes, now_wall)
            self.spill_events_total += sum(r.spill_events for r in records)
            self.fill_events_total += sum(r.fill_events for r in records)
        window_s = now_mono - cur[1] if cur[1] is not None else 0.0
        hbm_hw = max((r.hbm_highwater_bytes for r in records), default=0)
        total_hbm = sum(int(d.total_memory) for d in devices) or 1
        token = fnv64(f"{pod_uid}/{label}")
        for dev in devices:
            state = self._states.get((pod_uid, label, dev.host_index))
            if state is None:
                continue
            if (token, dev.host_index) in tc_util or \
                    (records and window_s > 0):
                state.samples += 1
                state.last_sample_wall = now_wall
            if records:
                # the ring is the tenant's, its high-water shared out by cap
                share = int(dev.total_memory) / total_hbm
                state.hbm_highwater = max(state.hbm_highwater,
                                          int(hbm_hw * share))
        cur[1] = now_mono
        return 0

    def hbm_fraction_samples(self, now_wall: float | None = None
                             ) -> dict[str, list[tuple[float, float]]]:
        """Per workload class, (high-water / cap, confidence) of each
        sampled tenant x device."""
        now_wall = time.time() if now_wall is None else now_wall
        out: dict[str, list[tuple[float, float]]] = {}
        with self._lock:
            states = list(self._states.values())
        for s in states:
            if s.alloc_hbm <= 0 or not s.samples:
                continue
            key = _CLASS_KEYS.get(s.workload_class, "def")
            out.setdefault(key, []).append(
                (min(s.hbm_highwater / s.alloc_hbm, 1.0),
                 s.confidence(now_wall)))
        return out

    def node_spill_signal(self, now_wall: float | None = None
                          ) -> tuple[float, int]:
        """(fraction of recent steps that spilled or filled, spilled bytes
        summed over the rings); a ring silent past STALENESS_S drops out."""
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
