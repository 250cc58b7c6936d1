"""What discovery returns (one chip, the node's mesh) and what a node
publishes about them (the registry).

The port's own copy of `ChipSpec`, `MeshSpec` and `NodeDeviceRegistry`
from the JAX package's `device/types.py:34-165`, field for field, so a
node registry built by either package encodes the same wire form and the
JAX scheduler reads the port's. On a GPU node `core_count` is the card's
SM count and the mesh is a 1 x N line.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

_REG_PREFIX = "v1:"


@dataclass(frozen=True)
class ChipSpec:
    """Static description of one physical device as a node advertises it.

    uuid: stable device id (NVML's `GPU-...` on a card).
    index: host device index (NVML's index space).
    chip_type: e.g. "nvidia-h100-80gb".
    memory: physical device memory in bytes.
    core_count: compute units (SMs on a GPU); quota math is percent-based.
    split_count: how many slots this device advertises.
    coords: (x, y, z) position in the node's mesh.
    host_id, numa: board and NUMA node of the device's PCIe attachment.
    healthy: health as of the last register heartbeat.
    """

    uuid: str
    index: int
    chip_type: str = "tpu-v5e"
    memory: int = 16 * 2**30
    core_count: int = 1
    split_count: int = 10
    coords: tuple[int, int, int] = (0, 0, 0)
    host_id: int = 0
    numa: int = 0
    healthy: bool = True

    def to_wire(self) -> list:
        return [self.uuid, self.index, self.chip_type, self.memory,
                self.core_count, self.split_count, list(self.coords),
                self.host_id, self.numa, 1 if self.healthy else 0]

    @staticmethod
    def from_wire(raw: list) -> "ChipSpec":
        if not (isinstance(raw, list) and len(raw) == 10):
            raise ValueError(f"malformed chip spec {raw!r}")
        return ChipSpec(uuid=str(raw[0]), index=int(raw[1]),
                        chip_type=str(raw[2]), memory=int(raw[3]),
                        core_count=int(raw[4]), split_count=int(raw[5]),
                        coords=tuple(int(v) for v in raw[6]),
                        host_id=int(raw[7]), numa=int(raw[8]),
                        healthy=bool(raw[9]))


@dataclass(frozen=True)
class MeshSpec:
    """The node-local device mesh: shape and wrap flags per axis."""

    shape: tuple[int, int, int] = (1, 1, 1)
    wrap: tuple[bool, bool, bool] = (False, False, False)

    def to_wire(self) -> dict:
        return {"shape": list(self.shape),
                "wrap": [1 if w else 0 for w in self.wrap]}

    @staticmethod
    def from_wire(raw: dict) -> "MeshSpec":
        shape = tuple(int(v) for v in raw.get("shape", [1, 1, 1]))
        wrap = tuple(bool(v) for v in raw.get("wrap", [0, 0, 0]))
        while len(shape) < 3:
            shape += (1,)
        while len(wrap) < 3:
            wrap += (False,)
        return MeshSpec(shape[:3], wrap[:3])


@dataclass
class NodeDeviceRegistry:
    """What a node publishes about its devices (the register annotation)."""

    chips: list[ChipSpec] = field(default_factory=list)
    mesh: MeshSpec = field(default_factory=MeshSpec)
    mesh_domain: str = ""      # multi-host domain id ("" = none)

    def encode(self) -> str:
        payload = {"chips": [c.to_wire() for c in self.chips],
                   "mesh": self.mesh.to_wire()}
        if self.mesh_domain:
            payload["domain"] = self.mesh_domain
        return _REG_PREFIX + json.dumps(payload, separators=(",", ":"))

    @staticmethod
    def decode(value: str) -> "NodeDeviceRegistry":
        if not value.startswith(_REG_PREFIX):
            raise ValueError(f"unknown registry encoding {value[:16]!r}")
        payload = json.loads(value[len(_REG_PREFIX):])
        return NodeDeviceRegistry(
            chips=[ChipSpec.from_wire(c) for c in payload.get("chips", [])],
            mesh=MeshSpec.from_wire(payload.get("mesh", {})),
            mesh_domain=str(payload.get("domain", "")))

    def chip_by_uuid(self) -> dict[str, ChipSpec]:
        return {c.uuid: c for c in self.chips}
