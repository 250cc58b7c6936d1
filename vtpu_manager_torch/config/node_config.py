"""Node configuration: how this node's devices are split and scaled.

The port of the JAX package's `config/node_config.py:21-157`: a file with
a `default` section and per-node overrides (by name or glob) that set the
split count, memory scaling and excluded devices, and a store that keeps
synthetic device ids stable across restarts.

A JSON file needs nothing beyond the standard library. A YAML file needs
`yaml`, imported only to read one: where it is missing, reading a YAML
file raises ImportError naming the file, and is never skipped.
"""

from __future__ import annotations

import fnmatch
import json
import logging
import os
from dataclasses import dataclass, replace

log = logging.getLogger(__name__)


@dataclass
class NodeConfig:
    """Effective config for one node."""

    device_split_count: int = 10        # slots per device
    core_scaling: float = 1.0           # advertised cores multiplier
    memory_scaling: float = 1.0         # advertised memory multiplier
    memory_overused: bool = False       # allow oversold memory claims
    exclude_devices: tuple[str, ...] = ()   # uuids or host indices ("0","2")
    compat_mode: str = "host"           # host|cgroup|client|open-kernel

    def excludes(self, uuid: str, index: int) -> bool:
        return uuid in self.exclude_devices or \
            str(index) in self.exclude_devices

    def validate(self) -> None:
        if self.device_split_count < 1:
            raise ValueError("deviceSplitCount must be >= 1")
        if not 0 < self.core_scaling <= 16:
            raise ValueError("coreScaling out of range (0, 16]")
        if not 0 < self.memory_scaling <= 16:
            raise ValueError("memoryScaling out of range (0, 16]")
        if self.compat_mode not in ("host", "cgroup", "client",
                                    "open-kernel"):
            raise ValueError(f"unknown compatMode {self.compat_mode!r}")


_FIELDS = {
    "deviceSplitCount": "device_split_count",
    "coreScaling": "core_scaling",
    "memoryScaling": "memory_scaling",
    "memoryOverused": "memory_overused",
    "excludeDevices": "exclude_devices",
    "compatMode": "compat_mode",
}


def _apply(cfg: NodeConfig, section: dict) -> None:
    for key, attr in _FIELDS.items():
        if key in section:
            value = section[key]
            if attr == "exclude_devices":
                # a scalar ("10") is one device, not the characters of one
                if isinstance(value, (str, int)):
                    value = (str(value),)
                else:
                    value = tuple(str(v) for v in value)
            setattr(cfg, attr, value)


def _read_document(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text) if text.strip() else {}
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"node config {path} is YAML, and the yaml module "
                          f"is not installed") from e
    return yaml.safe_load(text) or {}


def load_node_config(path: str | None, node_name: str) -> NodeConfig:
    """The effective config as a layered merge: built-in defaults <- the
    file's `default` section <- every matching glob override in file
    order <- the exact-name override last. A layer overrides only the
    keys it sets."""
    cfg = NodeConfig()
    if not path:
        return cfg
    doc = _read_document(path)
    _apply(cfg, doc.get("default") or {})
    overrides = doc.get("nodes") or []
    exact = [o for o in overrides if o.get("name") == node_name]
    globbed = [o for o in overrides
               if o.get("name") != node_name
               and fnmatch.fnmatch(node_name, o.get("name", ""))]
    for section in globbed + exact[:1]:   # exact wins, applied last
        _apply(cfg, section)
    cfg.validate()
    return cfg


def shape_chips(chips, cfg: NodeConfig, node_name: str,
                id_store: "DeviceIDStore | None" = None):
    """Applies the node config to discovered devices: stable ids,
    exclusions, split count, memory scaling."""
    out = []
    for chip in chips:
        uuid = chip.uuid
        if id_store is not None:
            uuid = id_store.uuid_for(node_name, chip.index, hw_serial=None)
        if cfg.excludes(uuid, chip.index):
            log.info("device %s (%d) excluded by node config", uuid,
                     chip.index)
            continue
        out.append(replace(chip, uuid=uuid,
                           split_count=cfg.device_split_count,
                           memory=int(chip.memory * cfg.memory_scaling)))
    return out


class DeviceIDStore:
    """Persistent device-uuid store, so synthetic ids (`<node>-chip-<i>`,
    for devices discovered without a hardware id) survive restarts."""

    def __init__(self, path: str):
        self.path = path
        self._ids: dict[str, str] = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self._ids = json.load(f)
            except (json.JSONDecodeError, OSError):
                self._ids = {}

    def uuid_for(self, node_name: str, index: int,
                 hw_serial: str | None = None) -> str:
        key = str(index)
        if hw_serial:
            if self._ids.get(key) != hw_serial:
                self._ids[key] = hw_serial
                self._save()
            return hw_serial
        if key not in self._ids:
            self._ids[key] = f"{node_name}-chip-{index}"
            self._save()
        return self._ids[key]

    def _save(self) -> None:
        # best effort: on a read-only file system the ids stay stable in
        # this process, and losing persistence must not stop advertisement
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._ids, f)
            os.replace(tmp, self.path)
        except OSError as e:
            log.warning("device-id store %s not persisted: %s", self.path, e)
