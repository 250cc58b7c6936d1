"""Finding the CUDA cards of a node.

The port of the JAX package's `tpu/discovery.py:31-175`, kept at the same
module path so the node agent's imports read alike. Three backends, each
returning the same `DiscoveryResult` (`ChipSpec` per card, a 1 x N
`MeshSpec`, and each card's device-node minor: `/dev/nvidia<minor>`);
`discover()` takes the first that finds cards:

1. NvmlBackend: NVML over ctypes (`libnvidia-ml.so.1`), the node agent's
   view: NVML's index order is PCI order, and the UUID (`GPU-...`) is
   the identity that matches a card across NVML, CUDA and torch.
2. TorchBackend: `torch.cuda`, for a process that has torch and a card.
3. FakeBackend: synthetic cards for tests.

NVML's library missing means "no cards here" (None); NVML failing once it
loaded raises, so a broken driver is never mistaken for an empty node.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Protocol

from vtpu_manager_torch.device.types import ChipSpec, MeshSpec

# Card models: (device memory bytes, SMs) from NVIDIA's data sheets.
CHIP_MODELS = {
    "nvidia-h100-sxm": (80 * 2**30, 132),
    "nvidia-h100-pcie": (80 * 2**30, 114),
}
DEFAULT_CHIP_TYPE = "nvidia-h100-sxm"
NVML_LIBRARY = "libnvidia-ml.so.1"
NVML_BUFFER = 96          # NVML_DEVICE_UUID_V2_BUFFER_SIZE, _NAME_V2_


@dataclass
class DiscoveryResult:
    chips: list[ChipSpec]
    mesh: MeshSpec
    chip_type: str
    minors: dict[int, int] = field(default_factory=dict)  # index -> minor


class DiscoveryBackend(Protocol):
    def discover(self) -> DiscoveryResult | None: ...


def chip_type_for(name: str) -> str:
    """The CHIP_MODELS key for a card's marketing name ("NVIDIA H100 80GB
    HBM3" is the SXM part), or a generic type for another card."""
    if "H100" in name:
        return "nvidia-h100-pcie" if "PCIe" in name else "nvidia-h100-sxm"
    return "nvidia-" + name.lower().removeprefix("nvidia ").replace(" ", "-")


def _result(chips: list[ChipSpec], minors: dict[int, int]
            ) -> DiscoveryResult:
    return DiscoveryResult(chips=chips, mesh=MeshSpec((1, len(chips), 1)),
                           chip_type=chips[0].chip_type if chips else "",
                           minors=minors)


class NvmlError(RuntimeError):
    """An NVML call that failed; `code` is NVML's return code (None when
    no call was made)."""

    def __init__(self, msg: str, code: int | None = None):
        super().__init__(msg)
        self.code = code


class _NvmlMemory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class _NvmlMemoryV2(ctypes.Structure):
    _fields_ = [("version", ctypes.c_uint), ("total", ctypes.c_ulonglong),
                ("reserved", ctypes.c_ulonglong),
                ("free", ctypes.c_ulonglong), ("used", ctypes.c_ulonglong)]


# NVML_STRUCT_VERSION(Memory, 2): the struct's size, version in the top byte
NVML_MEMORY_V2 = ctypes.sizeof(_NvmlMemoryV2) | (2 << 24)
NVML_ERROR_INVALID_ARGUMENT = 2
NVML_ERROR_NOT_SUPPORTED = 3
NVML_ERROR_NOT_FOUND = 6
NVML_ERROR_INSUFFICIENT_SIZE = 7
NVML_VALUE_NOT_AVAILABLE = 2**64 - 1
NVML_CLOCK_SM = 1


class _NvmlProcessInfo(ctypes.Structure):
    """nvmlProcessInfo_t (v2 and v3 share it)."""
    _fields_ = [("pid", ctypes.c_uint), ("usedGpuMemory", ctypes.c_ulonglong),
                ("gpuInstanceId", ctypes.c_uint),
                ("computeInstanceId", ctypes.c_uint)]


class _NvmlProcessUtilizationSample(ctypes.Structure):
    _fields_ = [("pid", ctypes.c_uint), ("timeStamp", ctypes.c_ulonglong),
                ("smUtil", ctypes.c_uint), ("memUtil", ctypes.c_uint),
                ("encUtil", ctypes.c_uint), ("decUtil", ctypes.c_uint)]


class _NvmlUtilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class Nvml:
    """The few NVML calls the node side makes. `lib` is the loaded
    library, or anything with the same functions (tests pass a stub)."""

    def __init__(self, lib):
        self.lib = lib
        self._call("nvmlInit_v2")

    @classmethod
    def load(cls) -> "Nvml | None":
        """None when the node has no NVML library."""
        try:
            lib = ctypes.CDLL(NVML_LIBRARY)
        except OSError:
            return None
        return cls(lib)

    def _call(self, name: str, *args) -> None:
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise NvmlError(f"{name} failed: NVML error {rc}", rc)

    def count(self) -> int:
        n = ctypes.c_uint(0)
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def handle(self, index: int):
        h = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", ctypes.c_uint(index),
                   ctypes.byref(h))
        return h

    def _string(self, name: str, handle) -> str:
        buf = ctypes.create_string_buffer(NVML_BUFFER)
        self._call(name, handle, buf, ctypes.c_uint(NVML_BUFFER))
        return buf.value.decode()

    def uuid(self, handle) -> str:
        return self._string("nvmlDeviceGetUUID", handle)

    def name(self, handle) -> str:
        return self._string("nvmlDeviceGetName", handle)

    def memory_total(self, handle) -> int:
        """The card's memory as NVML counts it, firmware's share included."""
        mem = _NvmlMemory()
        self._call("nvmlDeviceGetMemoryInfo", handle, ctypes.byref(mem))
        return int(mem.total)

    def memory_reserved(self, handle) -> int:
        """What the driver and firmware keep of `memory_total`: no CUDA
        context can allocate it (nvmlDeviceGetMemoryInfo_v2)."""
        mem = _NvmlMemoryV2(version=NVML_MEMORY_V2)
        self._call("nvmlDeviceGetMemoryInfo_v2", handle, ctypes.byref(mem))
        return int(mem.reserved)

    def memory_usable(self, handle) -> int:
        """The memory a CUDA context sees as the card's total."""
        return self.memory_total(handle) - self.memory_reserved(handle)

    def minor(self, handle) -> int:
        """The card's device node is /dev/nvidia<minor>."""
        n = ctypes.c_uint(0)
        self._call("nvmlDeviceGetMinorNumber", handle, ctypes.byref(n))
        return n.value

    def utilization(self, handle) -> int:
        """Percent of NVML's last sample period with a kernel running."""
        util = _NvmlUtilization()
        self._call("nvmlDeviceGetUtilizationRates", handle,
                   ctypes.byref(util))
        return int(util.gpu)

    def sm_clock_mhz(self, handle) -> int:
        """The SM clock now (nvmlDeviceGetClockInfo, NVML_CLOCK_SM)."""
        n = ctypes.c_uint(0)
        self._call("nvmlDeviceGetClockInfo", handle,
                   ctypes.c_int(NVML_CLOCK_SM), ctypes.byref(n))
        return n.value

    def power_mw(self, handle) -> int:
        """The card's power draw now, in milliwatts."""
        n = ctypes.c_uint(0)
        self._call("nvmlDeviceGetPowerUsage", handle, ctypes.byref(n))
        return n.value

    def clocks_event_reasons(self, handle) -> int:
        """The bit mask of why the clocks are below their maximum now
        (nvmlDeviceGetCurrentClocksEventReasons; the older name on a
        driver that lacks it)."""
        n = ctypes.c_ulonglong(0)
        name = ("nvmlDeviceGetCurrentClocksEventReasons"
                if hasattr(self.lib, "nvmlDeviceGetCurrentClocksEventReasons")
                else "nvmlDeviceGetCurrentClocksThrottleReasons")
        self._call(name, handle, ctypes.byref(n))
        return n.value

    def compute_processes(self, handle) -> list[tuple[int, int]]:
        """(pid, bytes) of each process with a compute context on the
        card, pids in NVML's namespace (the host's); bytes 0 where NVML
        cannot say (a container without the host's pid namespace)."""
        count, buf = ctypes.c_uint(0), None
        while True:
            rc = self.lib.nvmlDeviceGetComputeRunningProcesses_v3(
                handle, ctypes.byref(count), buf)
            if rc == 0:
                return [] if buf is None else [
                    (int(p.pid), 0 if p.usedGpuMemory ==
                     NVML_VALUE_NOT_AVAILABLE else int(p.usedGpuMemory))
                    for p in buf[:count.value]]
            if rc != NVML_ERROR_INSUFFICIENT_SIZE:
                raise NvmlError("nvmlDeviceGetComputeRunningProcesses_v3 "
                                f"failed: NVML error {rc}", rc)
            # room for processes that start between the two calls
            count = ctypes.c_uint(count.value + 8)
            buf = (_NvmlProcessInfo * count.value)()

    def process_utilization(self, handle, since_us: int
                            ) -> list[tuple[int, int, int]]:
        """(pid, timestamp us, SM percent) of each per-process sample NVML
        took after `since_us` (its CPU clock, microseconds); empty when
        none is newer."""
        count, buf = ctypes.c_uint(0), None
        while True:
            rc = self.lib.nvmlDeviceGetProcessUtilization(
                handle, buf, ctypes.byref(count), ctypes.c_ulonglong(since_us))
            if rc == NVML_ERROR_NOT_FOUND or (rc == 0 and buf is None):
                return []
            if rc == 0:
                return [(int(s.pid), int(s.timeStamp), int(s.smUtil))
                        for s in buf[:count.value]]
            if rc != NVML_ERROR_INSUFFICIENT_SIZE:
                raise NvmlError("nvmlDeviceGetProcessUtilization failed: "
                                f"NVML error {rc}", rc)
            buf = (_NvmlProcessUtilizationSample * count.value)()


class NvmlBackend:
    def __init__(self, nvml: Nvml | None = None):
        self._nvml = nvml

    def discover(self) -> DiscoveryResult | None:
        nvml = self._nvml or Nvml.load()
        if nvml is None:
            return None
        chips, minors = [], {}
        for i in range(nvml.count()):
            h = nvml.handle(i)
            minors[i] = nvml.minor(h)
            name = nvml.name(h)
            chip_type = chip_type_for(name)
            _, cores = CHIP_MODELS.get(chip_type, (0, 0))
            chips.append(ChipSpec(uuid=nvml.uuid(h), index=i,
                                  chip_type=chip_type,
                                  memory=nvml.memory_usable(h),
                                  core_count=cores, coords=(0, i, 0)))
        return _result(chips, minors) if chips else None


class TorchBackend:
    """The cards torch sees, in CUDA's order. Torch knows no device-node
    minor, and CUDA's index is not one (CUDA index 0 has been
    /dev/nvidia2, 3 and 6 on H100 hosts), so the result carries no
    minors: a node agent that must name device nodes discovers by NVML."""

    def discover(self) -> DiscoveryResult | None:
        import torch
        if not torch.cuda.is_available():
            return None
        chips = []
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            chips.append(ChipSpec(uuid=f"GPU-{props.uuid}", index=i,
                                  chip_type=chip_type_for(props.name),
                                  memory=int(props.total_memory),
                                  core_count=props.multi_processor_count,
                                  coords=(0, i, 0)))
        return _result(chips, {}) if chips else None


class FakeBackend:
    def __init__(self, n_chips: int = 4, chip_type: str = DEFAULT_CHIP_TYPE):
        self.n_chips = n_chips
        self.chip_type = chip_type

    def discover(self) -> DiscoveryResult | None:
        mem, cores = CHIP_MODELS.get(self.chip_type,
                                     CHIP_MODELS[DEFAULT_CHIP_TYPE])
        return _result([ChipSpec(uuid=f"fake-{i}", index=i,
                                 chip_type=self.chip_type, memory=mem,
                                 core_count=cores, coords=(0, i, 0))
                        for i in range(self.n_chips)],
                       {i: i for i in range(self.n_chips)})


def discover(backends: list[DiscoveryBackend] | None = None
             ) -> DiscoveryResult | None:
    """The first backend that finds cards wins."""
    for backend in backends or [NvmlBackend(), TorchBackend()]:
        result = backend.discover()
        if result is not None and result.chips:
            return result
    return None
