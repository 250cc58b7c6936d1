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
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Protocol

from vtpu_manager_torch.config.tc_watcher import (DeviceUtil, ProcUtil,
                                                  TcUtilFile)
from vtpu_manager_torch.config.vmem import VmemLedger
from vtpu_manager_torch.tpu.discovery import Nvml, NvmlError
from vtpu_manager_torch.util import consts

log = logging.getLogger(__name__)


class UtilSampler(Protocol):
    def sample(self, host_index: int) -> int:
        """Device utilization percent (0..100)."""
        ...


class FakeSampler:
    def __init__(self):
        self.values: dict[int, int] = {}

    def sample(self, host_index: int) -> int:
        return self.values.get(host_index, 0)


class NvmlSampler:
    """NVML's utilization by host index (NVML's own index order). Raises
    when NVML is missing or fails: a node with cards never falls back to
    a made-up value."""

    def __init__(self, nvml: Nvml | None = None):
        self.nvml = nvml or Nvml.load()
        if self.nvml is None:
            raise NvmlError(f"{__name__}: no NVML library on this node")
        self._handles: dict[int, object] = {}

    def sample(self, host_index: int) -> int:
        handle = self._handles.get(host_index)
        if handle is None:
            handle = self._handles[host_index] = self.nvml.handle(host_index)
        return self.nvml.utilization(handle)


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
                for e, delta in zip(residents, deltas):
                    share = (util * delta // total if total
                             else util // len(residents))
                    procs.append(ProcUtil(pid=e.pid, util=share,
                                          mem_used=e.bytes,
                                          owner_token=e.owner_token))
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
