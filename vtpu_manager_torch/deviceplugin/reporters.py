"""The vtpu-cores and vtpu-memory reporter plugins.

The port of the JAX package's `deviceplugin/reporters.py`, behind the
CorePlugin and MemoryPlugin gates. They only advertise capacity, so that
requests and limits add up across the cluster; the vtpu-number plugin
carries every allocation.
"""

from __future__ import annotations

from vtpu_manager_torch.deviceplugin.api import messages as api
from vtpu_manager_torch.deviceplugin.base import DevicePluginServicer
from vtpu_manager_torch.util import consts

MIB = 2**20


def _health(chip) -> str:
    return "Healthy" if chip.healthy else "Unhealthy"


class VcorePlugin(DevicePluginServicer):
    """100 core-percent devices per card."""

    def __init__(self, manager):
        self.manager = manager
        self.resource_name = consts.vtpu_cores_resource()
        self.socket_name = "vtpu-cores.sock"

    def list_devices(self) -> list[api.Device]:
        return [api.Device(ID=f"{chip.uuid}::core-{pct}",
                           health=_health(chip))
                for chip in self.manager.chips for pct in range(100)]


class VmemPlugin(DevicePluginServicer):
    """One device per `mem_unit_mib` MiB of the card's usable memory."""

    def __init__(self, manager, mem_unit_mib: int = 256):
        self.manager = manager
        self.mem_unit_mib = mem_unit_mib
        self.resource_name = consts.vtpu_memory_resource()
        self.socket_name = "vtpu-memory.sock"

    def list_devices(self) -> list[api.Device]:
        return [api.Device(ID=f"{chip.uuid}::mem-{unit}",
                           health=_health(chip))
                for chip in self.manager.chips
                for unit in range(chip.memory // (self.mem_unit_mib * MIB))]
