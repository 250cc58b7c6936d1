"""What discovery returns: one chip, and the node's mesh.

The port's own copy of `ChipSpec` and `MeshSpec` from the JAX package's
`device/types.py:34-105`, field for field, so a node registry built from
either package encodes the same wire form. On a GPU node `core_count` is
the card's SM count and the mesh is a 1 x N line.
"""

from __future__ import annotations

from dataclasses import dataclass


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
