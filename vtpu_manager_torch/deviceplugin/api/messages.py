"""The v1beta1 device-plugin messages as plain dataclasses.

Field names are the proto's (`deviceplugin_pb2`), so `base.py` converts a
message to its counterpart field by field, and the plugin and a caller
that plays kubelet (the tests, `bench_allocate`) need no protobuf.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class DevicePluginOptions:
    pre_start_required: bool = False
    get_preferred_allocation_available: bool = False


@dataclass
class NUMANode:
    ID: int = 0


@dataclass
class TopologyInfo:
    nodes: list[NUMANode] = field(default_factory=list)


@dataclass
class Device:
    ID: str = ""
    health: str = ""
    topology: TopologyInfo | None = None


@dataclass
class ContainerPreferredAllocationRequest:
    available_deviceIDs: list[str] = field(default_factory=list)
    must_include_deviceIDs: list[str] = field(default_factory=list)
    allocation_size: int = 0


@dataclass
class PreferredAllocationRequest:
    container_requests: list[ContainerPreferredAllocationRequest] = \
        field(default_factory=list)


@dataclass
class ContainerPreferredAllocationResponse:
    deviceIDs: list[str] = field(default_factory=list)


@dataclass
class PreferredAllocationResponse:
    container_responses: list[ContainerPreferredAllocationResponse] = \
        field(default_factory=list)


@dataclass
class ContainerAllocateRequest:
    devicesIDs: list[str] = field(default_factory=list)


@dataclass
class AllocateRequest:
    container_requests: list[ContainerAllocateRequest] = \
        field(default_factory=list)


@dataclass
class Mount:
    container_path: str = ""
    host_path: str = ""
    read_only: bool = False


@dataclass
class DeviceSpec:
    container_path: str = ""
    host_path: str = ""
    permissions: str = ""


@dataclass
class ContainerAllocateResponse:
    envs: dict[str, str] = field(default_factory=dict)
    mounts: list[Mount] = field(default_factory=list)
    devices: list[DeviceSpec] = field(default_factory=list)
    annotations: dict[str, str] = field(default_factory=dict)


@dataclass
class AllocateResponse:
    container_responses: list[ContainerAllocateResponse] = \
        field(default_factory=list)


@dataclass
class PreStartContainerRequest:
    devicesIDs: list[str] = field(default_factory=list)


@dataclass
class PreStartContainerResponse:
    pass


@dataclass
class ListAndWatchResponse:
    devices: list[Device] = field(default_factory=list)
