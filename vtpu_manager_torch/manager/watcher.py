"""The node's utilization watcher.

The port of the JAX package's `manager/watcher.py:32-130`. Every 80 ms the
daemon samples each card's utilization, shares it among the card's
residents in the memory ledger by the growth of their launch counters
since the last tick (equal shares when nobody launched), and writes the
result to the feed (`config/tc_watcher.py`) that every tenant's
interposer reads.

On a card the sampler is NVML's `nvmlDeviceGetUtilizationRates().gpu`:
the percent of NVML's own sample period (driver-dependent, about 1/6 s to
1 s) in which a kernel ran, so consecutive ticks may repeat a value.

Processes outside the ledger. A process on the card that no interposer
meters (a tenant started around the device plugin, a node daemon) has no
ledger entry, yet it takes time slices beside the tenants. Where the
sampler also lists the card's processes (NVML's
`nvmlDeviceGetComputeRunningProcesses_v3`: who is on the card and its
memory), each process that no ledger resident of the card accounts for is
written into the feed as a resident with `owner_token` 0, its memory and
its utilization: NVML's `nvmlDeviceGetProcessUtilization` SM percent where
NVML gives it, else `UTIL_UNKNOWN` (-1; NVML on the H100 machine lists the
contexts and refuses their utilization with NOT_SUPPORTED). The rest of the
card's utilization (the device's less the known shares) is shared among
the ledger's residents as above. A tenant's interposer then measures its
long kernels by its slice clock beside a busy one, and beside one of
unknown use once a window or the clock shows its slices; its charges do
not come from these percentages. They move only the feed's shares, which
assume that NVML's per-process SM percent tracks the process's share of
the card's time; that has not been measured on a card. The sampler stops
asking for a reading NVML refuses for good (INVALID_ARGUMENT,
NOT_SUPPORTED); any other failure costs that tick's reading only.

Which processes the ledger accounts for (`outside_processes`): NVML names
pids in the host's namespace and the ledger in each tenant's, so a pid
proves a match only where the two share a namespace. When any NVML pid of
the card is a resident's pid they do, and every NVML process that is no
resident's pid is outside. Otherwise (the device plugin's DaemonSet runs
without the host's pid namespace) the count decides: with no more NVML
processes than residents, none is outside; with k more, the k left after
pairing each resident, largest ledger bytes first, with the process of
least NVML memory at or above its bytes (NVML adds each context's own
memory to what the interposer granted), else the largest left. With no
per-process reading, or every process accounted for, the feed is byte for
byte what the JAX watcher writes.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import NamedTuple, Protocol

from vtpu_manager_torch.config.tc_watcher import (DeviceUtil, ProcUtil,
                                                  TcUtilFile)
from vtpu_manager_torch.config.vmem import VmemLedger
from vtpu_manager_torch.tpu import discovery
from vtpu_manager_torch.tpu.discovery import Nvml, NvmlError
from vtpu_manager_torch.util import consts

log = logging.getLogger(__name__)


# NVML's per-process samples are 1/6 s to 1 s apart; an older one is stale
PROC_SAMPLE_MAX_AGE_US = 1_000_000
# a process whose utilization NVML does not give
UTIL_UNKNOWN = -1
# NVML's answers that no later call will change
REFUSED = (discovery.NVML_ERROR_INVALID_ARGUMENT,
           discovery.NVML_ERROR_NOT_SUPPORTED)


class ProcReading(NamedTuple):
    """One process on the card, as the sampler sees it."""
    pid: int
    util: int  # SM percent, or UTIL_UNKNOWN
    mem: int   # bytes


class UtilSampler(Protocol):
    def sample(self, host_index: int) -> int:
        """Device utilization percent (0..100)."""
        ...

    # optional: `processes(host_index) -> list[ProcReading] | None`, every
    # process on the card, None when the sampler cannot read them


class FakeSampler:
    def __init__(self):
        self.values: dict[int, int] = {}
        self.procs: dict[int, list[ProcReading]] = {}

    def sample(self, host_index: int) -> int:
        return self.values.get(host_index, 0)

    def processes(self, host_index: int) -> list[ProcReading] | None:
        return self.procs.get(host_index)


class NvmlSampler:
    """NVML's utilization by host index (NVML's own index order). Raises
    when NVML is missing or fails: a node with cards never falls back to
    a made-up value."""

    def __init__(self, nvml: Nvml | None = None):
        self.nvml = nvml or Nvml.load()
        if self.nvml is None:
            raise NvmlError(f"{__name__}: no NVML library on this node")
        self._handles: dict[int, object] = {}
        # host index -> pid -> (timestamp us, SM percent) of its newest sample
        self._samples: dict[int, dict[int, tuple[int, int]]] = {}
        # False once NVML refused the process list: processes() is None
        self.per_process = True
        # False once NVML refused per-process utilization: UTIL_UNKNOWN
        self.per_process_util = True

    def _handle(self, host_index: int):
        handle = self._handles.get(host_index)
        if handle is None:
            handle = self._handles[host_index] = self.nvml.handle(host_index)
        return handle

    def sample(self, host_index: int) -> int:
        return self.nvml.utilization(self._handle(host_index))

    def processes(self, host_index: int) -> list[ProcReading] | None:
        """Each compute process on the card with its newest SM percent (0
        when NVML has no sample of it within a second; UTIL_UNKNOWN once
        NVML refused per-process utilization); None when NVML gave no
        process list this time, and from then on once it refused it."""
        if not self.per_process:
            return None
        handle = self._handle(host_index)
        seen = self._samples.setdefault(host_index, {})
        try:
            running = self.nvml.compute_processes(handle)
        except NvmlError as e:
            if e.code in REFUSED:
                log.warning("no process list (%s); the feed carries the "
                            "ledger's residents only", e)
                self.per_process = False
            return None
        if not self.per_process_util:
            return [ProcReading(pid, UTIL_UNKNOWN, mem)
                    for pid, mem in running]
        try:
            since = max((ts for ts, _ in seen.values()), default=0)
            for pid, ts, sm in self.nvml.process_utilization(handle, since):
                if ts >= seen.get(pid, (0, 0))[0]:
                    seen[pid] = (ts, sm)
        except NvmlError as e:
            if e.code in REFUSED:
                log.warning("no per-process utilization (%s); processes "
                            "outside the ledger enter the feed of unknown "
                            "use", e)
                self.per_process_util = False
                return [ProcReading(pid, UTIL_UNKNOWN, mem)
                        for pid, mem in running]
            # this tick's samples only: the newest ones still stand
        now_us = time.time_ns() // 1000
        live = {pid for pid, _ in running}
        for pid in list(seen):
            if pid not in live:
                del seen[pid]
        return [ProcReading(pid, seen[pid][1] if pid in seen and now_us -
                            seen[pid][0] <= PROC_SAMPLE_MAX_AGE_US else 0,
                            mem) for pid, mem in running]


def outside_processes(readings: list[ProcReading], residents: list
                      ) -> list[ProcReading]:
    """The processes on a card that none of its ledger residents accounts
    for (the rule is in the module's docstring)."""
    pids = {e.pid for e in residents}
    if any(r.pid in pids for r in readings):
        return [r for r in readings if r.pid not in pids]
    if len(readings) <= len(residents):
        return []
    left = sorted(readings, key=lambda r: r.mem)
    for e in sorted(residents, key=lambda e: -e.bytes):
        at_or_above = [r for r in left if r.mem >= e.bytes]
        left.remove(at_or_above[0] if at_or_above else left[-1])
    return left


class TcWatcherDaemon:
    def __init__(self, device_indices: list[int], sampler: UtilSampler,
                 tc_path: str = consts.TC_UTIL_CONFIG,
                 vmem_path: str = consts.VMEM_NODE_CONFIG,
                 interval_ms: int = consts.NODE_WATCHER_INTERVAL_MS):
        self.device_indices = device_indices
        self.sampler = sampler
        self.interval_ms = interval_ms
        self.tc_file = TcUtilFile(tc_path, create=True, reset=True)
        try:
            self.vmem = VmemLedger(vmem_path, create=True)
        except (OSError, ValueError):
            self.vmem = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0
        self.errors = 0
        # (pid, host_index, owner_token) -> launch counter at the last
        # tick; the token is in the key because pids are namespace-local
        self._last_activity: dict[tuple[int, int, int], int] = {}

    def tick(self, now_ns: int | None = None) -> None:
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        entries = self.vmem.entries() if self.vmem is not None else []
        seen: set[tuple[int, int, int]] = set()
        for index in self.device_indices:
            util = max(0, min(100, self.sampler.sample(index)))
            residents = [e for e in entries if e.host_index == index]
            readings = (self.sampler.processes(index)
                        if hasattr(self.sampler, "processes") else None)
            outside = outside_processes(readings or [], residents)
            outside_util = min(util, sum(max(0, r.util) for r in outside))
            procs = []
            if residents:
                deltas = []
                for e in residents:
                    key = (e.pid, e.host_index, e.owner_token)
                    seen.add(key)
                    prev = self._last_activity.get(key, e.activity)
                    deltas.append(max(0, e.activity - prev))
                    self._last_activity[key] = e.activity
                total = sum(deltas)
                rest = util - outside_util
                for e, delta in zip(residents, deltas):
                    share = (rest * delta // total if total
                             else rest // len(residents))
                    procs.append(ProcUtil(pid=e.pid, util=share,
                                          mem_used=e.bytes,
                                          owner_token=e.owner_token))
            # the outside processes' own shares, capped at the device's
            left = outside_util
            for r in outside:
                share = (UTIL_UNKNOWN if r.util < 0
                         else min(r.util, left))
                left -= max(0, share)
                procs.append(ProcUtil(pid=r.pid, util=share, mem_used=r.mem,
                                      owner_token=0))
            self.tc_file.write_device(index, DeviceUtil(
                timestamp_ns=now_ns, device_util=util, procs=procs))
        # a departed resident's baseline must not pass to a recycled pid
        for key in list(self._last_activity):
            if key not in seen:
                del self._last_activity[key]
        self.ticks += 1

    def start(self) -> None:
        def loop():
            interval = self.interval_ms / 1000.0 / max(
                1, (len(self.device_indices) + 3) // 4)
            while not self._stop.wait(interval):
                try:
                    self.tick()
                except Exception:
                    self.errors += 1
                    log.exception("utilization watcher tick failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="vtpu-tc-watcher")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self.tc_file.close()
        if self.vmem is not None:
            self.vmem.close()
