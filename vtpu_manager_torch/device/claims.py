"""Device claims: the annotation wire format between scheduler and node.

The port's own copy of the JAX package's `device/claims.py:26-199`
(`DeviceClaim`, `PodDeviceClaims`, `try_decode`), so the port's device
plugin reads the claims the JAX scheduler writes and writes the ones it
reads. The scheduler commits a `pre-allocated` claim set; the plugin
confirms it with `real-allocated`.

Wire format (annotation value)::

    v1:{"<container>":[["<uuid>",<host_index>,<cores>,<memory_bytes>],...],...}

Containers keep their order (JSON object order is insertion order).
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass, field

_VERSION_PREFIX = "v1:"


@dataclass(frozen=True)
class DeviceClaim:
    """One container's claim on one physical device.

    cores: percent of the device's compute (0..100; 0 = unmetered).
    memory: device memory bytes carved out of the device.
    """

    uuid: str
    host_index: int
    cores: int
    memory: int

    def to_wire(self) -> list:
        return [self.uuid, self.host_index, self.cores, self.memory]

    @staticmethod
    def from_wire(raw: list) -> "DeviceClaim":
        if not (isinstance(raw, list) and len(raw) == 4):
            raise ValueError(f"malformed device claim {raw!r}")
        uuid, host_index, cores, memory = raw
        return DeviceClaim(str(uuid), int(host_index), int(cores), int(memory))


@dataclass
class PodDeviceClaims:
    """Per-container claims for one pod, in container order."""

    containers: dict[str, list[DeviceClaim]] = field(default_factory=dict)

    def add(self, container: str, claim: DeviceClaim) -> None:
        self.containers.setdefault(container, []).append(claim)

    def container_claims(self, container: str) -> list[DeviceClaim]:
        return self.containers.get(container, [])

    def all_claims(self) -> list[DeviceClaim]:
        return [c for claims in self.containers.values() for c in claims]

    def is_empty(self) -> bool:
        return not any(self.containers.values())

    def encode(self) -> str:
        payload = {name: [c.to_wire() for c in claims]
                   for name, claims in self.containers.items()}
        return _VERSION_PREFIX + json.dumps(payload, separators=(",", ":"))

    @staticmethod
    def decode(value: str) -> "PodDeviceClaims":
        if not value.startswith(_VERSION_PREFIX):
            raise ValueError(f"unknown claim encoding: {value[:16]!r}")
        payload = json.loads(value[len(_VERSION_PREFIX):])
        if not isinstance(payload, dict):
            raise ValueError("claim payload must be an object")
        out = PodDeviceClaims()
        for name, claims in payload.items():
            out.containers[str(name)] = [DeviceClaim.from_wire(c)
                                         for c in claims]
        return out

    def copy(self) -> "PodDeviceClaims":
        """A mutable copy (the per-container lists are copied): take one
        before changing anything `try_decode` returned, which is shared."""
        out = PodDeviceClaims()
        out.containers = {c: list(claims)
                          for c, claims in self.containers.items()}
        return out


def try_decode(value: str | None) -> PodDeviceClaims | None:
    """Decode, or None for an absent or malformed value (a malformed
    annotation on a resident pod must not wedge its reader). Results are
    cached by the annotation string and shared: treat them as read-only."""
    if not value:
        return None
    return _try_decode_cached(value)


@functools.lru_cache(maxsize=4096)
def _try_decode_cached(value: str) -> PodDeviceClaims | None:
    try:
        return PodDeviceClaims.decode(value)
    except (ValueError, TypeError, KeyError, AttributeError):
        return None
