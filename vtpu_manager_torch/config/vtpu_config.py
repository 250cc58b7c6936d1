"""The per-container `vtpu.config` file: what the device plugin writes and
the interposer reads.

The port's own copy of the JAX package's `config/vtpu_config.py:22-281`
(layout version 6), byte for byte: one device plugin can then write the
file for a TPU tenant and a GPU tenant alike, and the CUDA interposer
(`csrc/shim/vtpu_abi.h`) reads the same bytes the PJRT shim reads.
`tests/test_torch_config_abi.py` holds the two writers to identical output.

Layout: little-endian, explicitly padded, fixed-size NUL-terminated
strings, an FNV-1a checksum over every preceding byte, then a zero pad.
Files are replaced by rename, so a reader never sees a partial write; the
checksum rejects a torn one.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

MAGIC = 0x55505456          # "VTPU" little-endian
VERSION = 6
MAX_DEVICE_COUNT = 64
UUID_LEN = 64
NAME_LEN = 64
POD_UID_LEN = 48
CACHE_DIR_LEN = 64

WORKLOAD_CLASS_NONE = 0
WORKLOAD_CLASS_LATENCY = 1
WORKLOAD_CLASS_THROUGHPUT = 2

CORE_LIMIT_NONE = 0
CORE_LIMIT_HARD = 1      # fixed policy: clamp at hard_core
CORE_LIMIT_SOFT = 2      # balance policy: elastic hard_core..soft_core

# device: uuid[64], total_memory u64, real_memory u64, hard_core,
# soft_core, core_limit, memory_limit, memory_oversold, host_index,
# mesh_x/y/z, lease_core (i32 each), virtual_hbm_bytes u64,
# spill_budget_bytes u64, ici_link_pct i32, pad u32
_DEVICE_FMT = "<64sQQ10iQQiI"
DEVICE_SIZE = struct.calcsize(_DEVICE_FMT)
assert DEVICE_SIZE == 144

# header: magic, version, pod_uid[48], pod_name[64], pod_namespace[64],
# container_name[64], device_count, compat_mode, compile_cache_dir[64],
# workload_class, quota_epoch, migration_freeze, freeze_epoch
_HEADER_FMT = "<II48s64s64s64sii64siIiI"
HEADER_SIZE = struct.calcsize(_HEADER_FMT)
assert HEADER_SIZE == 336

_FOOTER_FMT = "<II"        # checksum u32, pad u32
CONFIG_SIZE = HEADER_SIZE + MAX_DEVICE_COUNT * DEVICE_SIZE + \
    struct.calcsize(_FOOTER_FMT)
assert CONFIG_SIZE == 9560


def fnv1a(data: bytes) -> int:
    h = 0x811C9DC5
    for b in data:
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


def _cstr(s: str, size: int) -> bytes:
    raw = s.encode()[: size - 1]
    return raw + b"\0" * (size - len(raw))


def _from_cstr(raw: bytes) -> str:
    return raw.split(b"\0", 1)[0].decode(errors="replace")


@dataclass
class DeviceConfig:
    """One device's enforcement parameters."""

    uuid: str
    total_memory: int          # memory cap in bytes
    real_memory: int           # physical device memory in bytes
    hard_core: int = 100       # percent
    soft_core: int = 100       # percent (balance ceiling)
    core_limit: int = CORE_LIMIT_NONE
    memory_limit: bool = True
    memory_oversold: bool = False
    host_index: int = 0
    mesh: tuple[int, int, int] = (0, 0, 0)
    lease_core: int = 0
    virtual_hbm_bytes: int = 0
    spill_budget_bytes: int = 0
    ici_link_pct: int = 0

    def pack(self) -> bytes:
        return struct.pack(
            _DEVICE_FMT, _cstr(self.uuid, UUID_LEN), self.total_memory,
            self.real_memory, self.hard_core, self.soft_core,
            self.core_limit, 1 if self.memory_limit else 0,
            1 if self.memory_oversold else 0, self.host_index,
            self.mesh[0], self.mesh[1], self.mesh[2], self.lease_core,
            self.virtual_hbm_bytes, self.spill_budget_bytes,
            self.ici_link_pct, 0)

    @staticmethod
    def unpack(raw: bytes) -> "DeviceConfig":
        (uuid, total, real, hard, soft, climit, mlimit, oversold, hidx,
         mx, my, mz, lease, virt, spill, ici,
         _pad) = struct.unpack(_DEVICE_FMT, raw)
        return DeviceConfig(uuid=_from_cstr(uuid), total_memory=total,
                            real_memory=real, hard_core=hard, soft_core=soft,
                            core_limit=climit, memory_limit=bool(mlimit),
                            memory_oversold=bool(oversold), host_index=hidx,
                            mesh=(mx, my, mz), lease_core=lease,
                            virtual_hbm_bytes=virt, spill_budget_bytes=spill,
                            ici_link_pct=ici)


@dataclass
class VtpuConfig:
    """The whole per-container config file."""

    pod_uid: str = ""
    pod_name: str = ""
    pod_namespace: str = ""
    container_name: str = ""
    compat_mode: int = 0
    compile_cache_dir: str = ""
    workload_class: int = WORKLOAD_CLASS_NONE
    quota_epoch: int = 0
    migration_freeze: int = 0
    freeze_epoch: int = 0
    devices: list[DeviceConfig] = field(default_factory=list)

    def pack(self) -> bytes:
        if len(self.devices) > MAX_DEVICE_COUNT:
            raise ValueError(
                f"{len(self.devices)} devices > {MAX_DEVICE_COUNT}")
        body = struct.pack(
            _HEADER_FMT, MAGIC, VERSION, _cstr(self.pod_uid, POD_UID_LEN),
            _cstr(self.pod_name, NAME_LEN),
            _cstr(self.pod_namespace, NAME_LEN),
            _cstr(self.container_name, NAME_LEN),
            len(self.devices), self.compat_mode,
            _cstr(self.compile_cache_dir, CACHE_DIR_LEN),
            self.workload_class, self.quota_epoch & 0xFFFFFFFF,
            self.migration_freeze, self.freeze_epoch & 0xFFFFFFFF)
        for dev in self.devices:
            body += dev.pack()
        body += b"\0" * (DEVICE_SIZE * (MAX_DEVICE_COUNT - len(self.devices)))
        body += struct.pack(_FOOTER_FMT, fnv1a(body), 0)
        assert len(body) == CONFIG_SIZE
        return body

    @staticmethod
    def unpack(raw: bytes) -> "VtpuConfig":
        if len(raw) != CONFIG_SIZE:
            raise ValueError(f"config size {len(raw)} != {CONFIG_SIZE}")
        checksum, pad = struct.unpack_from(_FOOTER_FMT, raw, CONFIG_SIZE - 8)
        if pad != 0:
            raise ValueError("nonzero footer padding (corruption?)")
        if fnv1a(raw[: CONFIG_SIZE - 8]) != checksum:
            raise ValueError("config checksum mismatch (torn write?)")
        (magic, version, pod_uid, pod_name, pod_ns, cont_name, count,
         compat, cache_dir, wl_class, quota_epoch, migration_freeze,
         freeze_epoch) = struct.unpack_from(_HEADER_FMT, raw, 0)
        if magic != MAGIC:
            raise ValueError(f"bad magic {magic:#x}")
        if version != VERSION:
            raise ValueError(f"unsupported config version {version}")
        if not 0 <= count <= MAX_DEVICE_COUNT:
            raise ValueError(f"bad device count {count}")
        cfg = VtpuConfig(pod_uid=_from_cstr(pod_uid),
                         pod_name=_from_cstr(pod_name),
                         pod_namespace=_from_cstr(pod_ns),
                         container_name=_from_cstr(cont_name),
                         compat_mode=compat,
                         compile_cache_dir=_from_cstr(cache_dir),
                         workload_class=wl_class, quota_epoch=quota_epoch,
                         migration_freeze=migration_freeze,
                         freeze_epoch=freeze_epoch)
        for i in range(count):
            off = HEADER_SIZE + i * DEVICE_SIZE
            cfg.devices.append(
                DeviceConfig.unpack(raw[off: off + DEVICE_SIZE]))
        return cfg


def write_config(path: str, cfg: VtpuConfig) -> None:
    """Atomic write: a temporary file, then rename over `path`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(cfg.pack())
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def read_config(path: str) -> VtpuConfig:
    with open(path, "rb") as f:
        return VtpuConfig.unpack(f.read())


# Field offsets, held against vtpu_abi.h by the ABI test.
DEVICE_OFFSETS = {
    "uuid": 0, "total_memory": 64, "real_memory": 72, "hard_core": 80,
    "soft_core": 84, "core_limit": 88, "memory_limit": 92,
    "memory_oversold": 96, "host_index": 100, "mesh_x": 104, "mesh_y": 108,
    "mesh_z": 112, "lease_core": 116, "virtual_hbm_bytes": 120,
    "spill_budget_bytes": 128, "ici_link_pct": 136,
}
HEADER_OFFSETS = {
    "magic": 0, "version": 4, "pod_uid": 8, "pod_name": 56,
    "pod_namespace": 120, "container_name": 184, "device_count": 248,
    "compat_mode": 252, "compile_cache_dir": 256, "workload_class": 320,
    "quota_epoch": 324, "migration_freeze": 328, "freeze_epoch": 332,
}
