"""Kubelet's device-manager checkpoint: which pod holds which device ids.

The port of the JAX package's `deviceplugin/checkpoint.py`. The kubelet
writes `kubelet_internal_checkpoint` as JSON (`Data.PodDeviceEntries`);
the node exporter reads it to judge whether a config directory belongs to
a container the kubelet really gave devices to. A missing, truncated or
malformed file reads as no entries, and a wrong-typed field costs only its
own entry.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

KUBELET_CHECKPOINT = \
    "/var/lib/kubelet/device-plugins/kubelet_internal_checkpoint"


@dataclass(frozen=True)
class CheckpointEntry:
    pod_uid: str
    container: str
    resource: str
    device_ids: tuple[str, ...]


def _string_ids(chunk) -> list[str]:
    """Only a list of strings gives ids: a bare string would iterate into
    characters, and a garbage id must never read as a device."""
    if not isinstance(chunk, list):
        return []
    return [d for d in chunk if isinstance(d, str)]


def read_checkpoint(path: str = KUBELET_CHECKPOINT) -> list[CheckpointEntry]:
    if not os.path.exists(path):
        return []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return []
    if not isinstance(doc, dict):
        return []
    data = doc.get("Data")
    raw_entries = data.get("PodDeviceEntries") if isinstance(data, dict) \
        else None
    if not isinstance(raw_entries, list):
        return []
    entries = []
    for entry in raw_entries:
        if not isinstance(entry, dict):
            continue
        ids: list[str] = []
        dev_map = entry.get("DeviceIDs") or {}
        if isinstance(dev_map, dict):
            for chunk in dev_map.values():
                ids.extend(_string_ids(chunk))
        else:
            ids = _string_ids(dev_map)
        entries.append(CheckpointEntry(
            pod_uid=str(entry.get("PodUID") or ""),
            container=str(entry.get("ContainerName") or ""),
            resource=str(entry.get("ResourceName") or ""),
            device_ids=tuple(ids)))
    return entries


def devices_for_resource(resource: str,
                         path: str = KUBELET_CHECKPOINT) -> dict[str, set]:
    """pod_uid -> the device ids it holds of one resource."""
    out: dict[str, set] = {}
    for entry in read_checkpoint(path):
        if entry.resource == resource:
            out.setdefault(entry.pod_uid, set()).update(entry.device_ids)
    return out
