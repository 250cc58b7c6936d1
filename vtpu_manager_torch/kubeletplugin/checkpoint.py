"""The DRA plugin's checkpoint: the prepared claims, across restarts.

The port's own copy of the JAX package's `kubeletplugin/checkpoint.py:
22-100`, so either package reads the other's file and both write the same
bytes for the same claims: `{"checksum": crc32, "data": {"version": 2,
"claims": {uid: PreparedClaim}}}`, the checksum over the payload's
canonical JSON, a version 1 file (a flat {uid: [devices]} map) migrated
on load. A prepared device entry keeps the JAX package's keys (`device`,
`uuid`, `hostIndex`, `cores`, `memory`, and `request`, `cdi` for a
multi-request claim); a card's device-node minor is looked up from
discovery, never stored.
"""

from __future__ import annotations

import json
import logging
import os
import zlib
from dataclasses import dataclass, field

log = logging.getLogger(__name__)

CURRENT_VERSION = 2


@dataclass
class PreparedClaim:
    claim_uid: str
    namespace: str
    name: str
    devices: list[dict] = field(default_factory=list)
    cdi_devices: list[str] = field(default_factory=list)

    def to_doc(self) -> dict:
        return {"claimUID": self.claim_uid, "namespace": self.namespace,
                "name": self.name, "devices": self.devices,
                "cdiDevices": self.cdi_devices}

    @staticmethod
    def from_doc(doc: dict) -> "PreparedClaim":
        return PreparedClaim(claim_uid=doc.get("claimUID", ""),
                             namespace=doc.get("namespace", ""),
                             name=doc.get("name", ""),
                             devices=list(doc.get("devices", [])),
                             cdi_devices=list(doc.get("cdiDevices", [])))


def _checksum(payload: dict) -> int:
    canon = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return zlib.crc32(canon.encode())


def _migrate_v1(doc: dict) -> dict:
    claims = {}
    for uid, devices in (doc.get("claims") or {}).items():
        claims[uid] = {"claimUID": uid, "namespace": "", "name": "",
                       "devices": devices, "cdiDevices": []}
    return {"version": CURRENT_VERSION, "claims": claims}


class Checkpoint:
    def __init__(self, path: str):
        self.path = path
        self.claims: dict[str, PreparedClaim] = {}

    def load(self) -> None:
        """Raises ValueError on a checksum mismatch or an unknown version;
        a file without a checksum (version 1) is accepted."""
        if not os.path.exists(self.path):
            self.claims = {}
            return
        with open(self.path) as f:
            wrapper = json.load(f)
        payload = wrapper.get("data") or {}
        stored_sum = wrapper.get("checksum")
        if stored_sum is not None and _checksum(payload) != stored_sum:
            raise ValueError(f"checkpoint {self.path} checksum mismatch")
        version = payload.get("version", 1)
        if version == 1:
            log.warning("migrating checkpoint v1 -> v%d", CURRENT_VERSION)
            payload = _migrate_v1(payload)
        elif version != CURRENT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        self.claims = {uid: PreparedClaim.from_doc(doc)
                       for uid, doc in (payload.get("claims") or {}).items()}

    def save(self) -> None:
        """Written whole and renamed into place, after an fsync."""
        payload = {"version": CURRENT_VERSION,
                   "claims": {uid: claim.to_doc()
                              for uid, claim in self.claims.items()}}
        wrapper = {"checksum": _checksum(payload), "data": payload}
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(wrapper, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def diff_and_log(self, before: dict[str, PreparedClaim]) -> None:
        added = set(self.claims) - set(before)
        removed = set(before) - set(self.claims)
        if added or removed:
            log.info("checkpoint delta: +%s -%s", sorted(added),
                     sorted(removed))
