"""The v1beta1 DRA plugin messages as plain dataclasses.

Field names are the proto's (`dra_pb2`), so the driver converts a message
to its counterpart field by field at the socket, and the driver and a
caller that plays kubelet (the tests, `bench_dra`) need no protobuf.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Claim:
    uid: str = ""
    name: str = ""
    namespace: str = ""


@dataclass
class NodePrepareResourcesRequest:
    claims: list[Claim] = field(default_factory=list)


@dataclass
class Device:
    requests: list[str] = field(default_factory=list)
    pool_name: str = ""
    device_name: str = ""
    cdi_device_ids: list[str] = field(default_factory=list)


@dataclass
class NodePrepareResourceResponse:
    devices: list[Device] = field(default_factory=list)
    error: str = ""


@dataclass
class NodePrepareResourcesResponse:
    claims: dict[str, NodePrepareResourceResponse] = \
        field(default_factory=dict)


@dataclass
class NodeUnprepareResourcesRequest:
    claims: list[Claim] = field(default_factory=list)


@dataclass
class NodeUnprepareResourceResponse:
    error: str = ""


@dataclass
class NodeUnprepareResourcesResponse:
    claims: dict[str, NodeUnprepareResourceResponse] = \
        field(default_factory=dict)
