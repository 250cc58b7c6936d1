"""DeviceManager: the node's device inventory, its registration and health.

The port of the JAX package's `manager/device_manager.py:63-268`
(`DeviceManager`, `HealthWatcher`, `make_external_probe`). Discovery goes
through `tpu/discovery.py` (NVML on a GPU node); the node config shapes the
devices; `register_node` publishes the registry the scheduler reads and a
heartbeat. A GPU's device node is `/dev/nvidia<minor>`, the minor from NVML.

Not ported: the observation calibration (`obs_excess_table` stays None, so
each tenant's interposer runs its own idle-time probe).
"""

from __future__ import annotations

import logging
import os
import subprocess
import threading
import time
from dataclasses import replace
from typing import Callable

from vtpu_manager_torch.client.kube import KubeClient, KubeError
from vtpu_manager_torch.config.node_config import NodeConfig, shape_chips
from vtpu_manager_torch.device.types import (ChipSpec, MeshSpec,
                                             NodeDeviceRegistry)
from vtpu_manager_torch.resilience import failpoints
from vtpu_manager_torch.resilience.policy import RetryPolicy
from vtpu_manager_torch.tpu.discovery import DiscoveryBackend, discover
from vtpu_manager_torch.util import consts

log = logging.getLogger(__name__)


def make_external_probe(cmd: str, timeout_s: float = 5.0):
    """A per-device health probe running `<cmd> <index> <uuid>`: exit 0 is
    healthy (True), another exit or a timeout is sick (False), and a
    probe that cannot be launched says nothing (None)."""

    def probe(chip) -> bool | None:
        try:
            return subprocess.run(
                [cmd, str(chip.index), chip.uuid],
                timeout=timeout_s, capture_output=True).returncode == 0
        except subprocess.TimeoutExpired:
            log.error("health probe %s timed out (%ss) for %s", cmd,
                      timeout_s, chip.uuid)
            return False
        except OSError as e:
            log.error("health probe %s failed to launch: %s", cmd, e)
            return None

    return probe


class DeviceManager:
    """Owns the node's device inventory and its published view."""

    def __init__(self, node_name: str, client: KubeClient,
                 node_config: NodeConfig | None = None,
                 backends: list[DiscoveryBackend] | None = None,
                 mesh_domain: str = ""):
        self.node_name = node_name
        self.client = client
        self.node_config = node_config or NodeConfig()
        self.backends = backends
        self.mesh_domain = mesh_domain
        self.chips: list[ChipSpec] = []
        self.mesh: MeshSpec = MeshSpec()
        self.minors: dict[int, int] = {}     # host index -> device minor
        # not calibrated: tenants' interposers use their own probe
        self.obs_excess_table: str | None = None
        self._health_listeners: list[Callable[[ChipSpec], None]] = []
        self._stop = threading.Event()
        # the register annotation is what makes the node schedulable:
        # ride out a transient API-server error
        self._registration_policy = RetryPolicy(max_attempts=3,
                                                base_delay_s=0.1,
                                                deadline_s=10.0)

    # -- inventory ----------------------------------------------------------

    def init_devices(self) -> list[ChipSpec]:
        """Discovers the devices and applies the node config."""
        result = discover(self.backends)
        if result is None:
            raise RuntimeError("no devices discovered on this node")
        self.chips = shape_chips(result.chips, self.node_config,
                                 self.node_name)
        self.mesh = result.mesh
        self.minors = dict(result.minors)
        return self.chips

    def registry(self) -> NodeDeviceRegistry:
        return NodeDeviceRegistry(chips=self.chips, mesh=self.mesh,
                                  mesh_domain=self.mesh_domain)

    def device_node(self, host_index: int) -> str:
        """Raises KeyError for a device whose discovery gave no minor
        (TorchBackend): a guessed node could be another card's."""
        if host_index not in self.minors:
            raise KeyError(f"device {host_index} has no device-node minor "
                           "(discover by NVML to name /dev/nvidia<minor>)")
        return f"/dev/nvidia{self.minors[host_index]}"

    # -- registration / heartbeat --------------------------------------------

    def register_node(self) -> None:
        """Publishes the register and heartbeat annotations."""
        anns = {consts.node_device_register_annotation():
                self.registry().encode(),
                consts.node_device_heartbeat_annotation(): str(time.time())}
        self._registration_policy.run(
            lambda: self.client.patch_node_annotations(self.node_name, anns),
            op="manager.register_node")

    def start_heartbeat(self, interval_s: float = 30.0) -> None:
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.register_node()
                except KubeError:
                    log.warning("heartbeat registration failed")

        threading.Thread(target=loop, daemon=True,
                         name="vtpu-heartbeat").start()

    def stop(self) -> None:
        self._stop.set()

    # -- health ---------------------------------------------------------------

    def on_unhealthy(self, listener: Callable[[ChipSpec], None]) -> None:
        """Plugins subscribe to re-advertise devices on health flips."""
        self._health_listeners.append(listener)

    def _set_health(self, uuid: str, healthy: bool) -> None:
        for i, chip in enumerate(self.chips):
            if chip.uuid == uuid and chip.healthy != healthy:
                self.chips[i] = replace(chip, healthy=healthy)
                for listener in self._health_listeners:
                    listener(self.chips[i])
                try:
                    self.register_node()
                except KubeError:
                    log.warning("health re-registration failed")

    def mark_unhealthy(self, uuid: str) -> None:
        self._set_health(uuid, False)

    def mark_healthy(self, uuid: str) -> None:
        self._set_health(uuid, True)


def device_node_probe(manager: DeviceManager):
    """The default probe: a device is healthy while its node exists."""
    return lambda chip: os.path.exists(manager.device_node(chip.index))


class HealthWatcher:
    """Polls device health and flips the manager's view: unhealthy after
    `flip_after` consecutive failed probes, healthy again at the first
    good one. A None verdict (the probe did not run) changes nothing."""

    def __init__(self, manager, probe: Callable[[ChipSpec], "bool | None"],
                 interval_s: float = 10.0, flip_after: int = 3):
        self.manager = manager
        self.probe = probe
        self.interval_s = interval_s
        self.flip_after = max(1, int(flip_after))
        self._fail_streak: dict[str, int] = {}
        self._stop = threading.Event()

    def check_once(self) -> None:
        for chip in list(self.manager.chips):
            failpoints.fire("health.probe", chip=chip.uuid)
            ok: bool | None = False
            try:
                ok = self.probe(chip)
            except Exception:  # noqa: BLE001 - a raising probe reads sick
                log.warning("health probe raised for %s; treating as "
                            "unhealthy", chip.uuid, exc_info=True)
            if ok is None:
                continue
            if not ok:
                streak = self._fail_streak.get(chip.uuid, 0) + 1
                self._fail_streak[chip.uuid] = streak
                if streak >= self.flip_after and chip.healthy:
                    log.error("device %s failed %d consecutive health "
                              "probes", chip.uuid, streak)
                    self.manager.mark_unhealthy(chip.uuid)
                continue
            self._fail_streak.pop(chip.uuid, None)
            if not chip.healthy:
                log.info("device %s recovered", chip.uuid)
                self.manager.mark_healthy(chip.uuid)

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                self.check_once()

        threading.Thread(target=loop, daemon=True,
                         name="vtpu-health").start()

    def stop(self) -> None:
        self._stop.set()
