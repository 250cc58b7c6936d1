"""The node's cross-process memory ledger (`vmem_node.config`).

The port's own copy of the JAX package's `config/vmem.py:26-360` (layout
version 3: 1,024 entries of 48 bytes). Every tenant process records its
device bytes here, so the interposer's allocation check can count a
tenant's sibling processes against its cap and every tenant on a card
against the card's physical memory; the node watcher reads the entries'
activity counters to share the card's utilization among residents.

Slots are keyed by (pid, host_index) and claimed or updated under an flock
on `<path>.lock`, the protocol the interposer (`csrc/shim/enforce_mem.cc`)
uses too. Identity across pid namespaces goes by the owner token, never by
the pid alone. An entry whose pid is dead in this namespace is reaped once
it is also stale (`VTPU_VMEM_STALE_S`, default 120 s), since a foreign
namespace's pid cannot be probed.
"""

from __future__ import annotations

import mmap
import os
import struct
import time
from dataclasses import dataclass

from vtpu_manager_torch.util import consts
from vtpu_manager_torch.util.flock import FileLock

MAGIC = 0x4D454D56          # "VMEM"
VERSION = 3
MAX_ENTRIES = 1024

_HEADER_FMT = "<IIii"       # magic, version, max_entries, pad
HEADER_SIZE = struct.calcsize(_HEADER_FMT)
# pid i32, host_index i32, bytes u64, last_update_ns u64, owner_token u64,
# activity u64 (launches, bumped by the interposer), spilled u64
_ENTRY_FMT = "<iiQQQQQ"
ENTRY_SIZE = struct.calcsize(_ENTRY_FMT)
assert ENTRY_SIZE == 48
FILE_SIZE = HEADER_SIZE + MAX_ENTRIES * ENTRY_SIZE


def stale_reap_ns() -> int:
    """The staleness window, clamped as the interposer clamps it
    (`VmemStaleReapNsFromEnv` in vtpu_abi.h): unparsable, <= 0 or NaN is
    120 s, huge values cap at 1e10 s."""
    try:
        s = float(os.environ.get(consts.ENV_VMEM_STALE_S, "120"))
    except ValueError:
        s = 120.0
    if not s > 0:
        s = 120.0
    s = min(s, 1e10)
    return int(s * 1e9)


def fnv64(data: str) -> int:
    h = 0xCBF29CE484222325
    for b in data.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def owner_token_from_env() -> int:
    """Stable per-container token: pod uid and container name when the
    device plugin injected them, else this process's boot-scoped
    identity (pid and start time from /proc/self/stat)."""
    pod_uid = os.environ.get(consts.ENV_POD_UID, "")
    cont = os.environ.get(consts.ENV_CONTAINER_NAME, "")
    if pod_uid:
        return fnv64(f"{pod_uid}/{cont}")
    try:
        with open("/proc/self/stat") as f:
            starttime = f.read().rsplit(")", 1)[1].split()[19]
    except (OSError, IndexError):
        starttime = "0"
    return fnv64(f"proc-{os.getpid()}-{starttime}")


@dataclass
class VmemEntry:
    pid: int
    host_index: int
    bytes: int
    last_update_ns: int
    owner_token: int = 0
    activity: int = 0
    spilled: int = 0


_FREE = VmemEntry(0, 0, 0, 0, 0)


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


class VmemLedger:
    def __init__(self, path: str = consts.VMEM_NODE_CONFIG,
                 create: bool = False):
        self.path = path
        self._lock = FileLock(path + ".lock")
        if create:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with FileLock(path + ".create.lock"):
                if (not os.path.exists(path)
                        or os.path.getsize(path) != FILE_SIZE):
                    tmp = f"{path}.tmp.{os.getpid()}"
                    with open(tmp, "wb") as f:
                        f.write(struct.pack(_HEADER_FMT, MAGIC, VERSION,
                                            MAX_ENTRIES, 0))
                        f.write(b"\0" * (FILE_SIZE - HEADER_SIZE))
                    os.rename(tmp, path)
        self._fd = os.open(path, os.O_RDWR)
        try:
            self._mm = mmap.mmap(self._fd, FILE_SIZE)
        except (ValueError, OSError):
            os.close(self._fd)
            self._fd = None
            raise
        magic, version, _, _ = struct.unpack_from(_HEADER_FMT, self._mm, 0)
        if magic != MAGIC or version != VERSION:
            self.close()
            raise ValueError(f"bad vmem ledger {path}")

    def close(self) -> None:
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
            self._mm = None
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)
            self._fd = None

    def _entry(self, i: int) -> VmemEntry:
        return VmemEntry(*struct.unpack_from(
            _ENTRY_FMT, self._mm, HEADER_SIZE + i * ENTRY_SIZE))

    def _write_entry(self, i: int, e: VmemEntry) -> None:
        struct.pack_into(_ENTRY_FMT, self._mm, HEADER_SIZE + i * ENTRY_SIZE,
                         e.pid, e.host_index, e.bytes, e.last_update_ns,
                         e.owner_token, e.activity, e.spilled)

    def _free_slot_locked(self) -> int | None:
        for i in range(MAX_ENTRIES):
            if self._entry(i).pid == 0:
                return i
        self._reap_locked()
        for i in range(MAX_ENTRIES):
            if self._entry(i).pid == 0:
                return i
        return None

    def record(self, pid: int, host_index: int, nbytes: int,
               owner_token: int | None = None) -> None:
        """Set this pid's bytes on a device (0 clears the slot)."""
        now = time.monotonic_ns()
        token = owner_token if owner_token is not None \
            else owner_token_from_env()
        with self._lock:
            for i in range(MAX_ENTRIES):
                e = self._entry(i)
                if e.pid == pid and e.host_index == host_index:
                    if nbytes == 0 and e.spilled == 0:
                        self._write_entry(i, _FREE)
                    else:
                        # an update keeps the activity counter
                        self._write_entry(
                            i, VmemEntry(pid, host_index, nbytes, now,
                                         token, e.activity, e.spilled))
                    return
            if nbytes == 0:
                return
            slot = self._free_slot_locked()
            if slot is None:
                raise RuntimeError("vmem ledger full")
            self._write_entry(slot, VmemEntry(pid, host_index, nbytes, now,
                                              token))

    def device_total(self, host_index: int,
                     exclude_pid: int | None = None,
                     exclude_token: int | None = None) -> int:
        """Live bytes recorded for a device; dead and stale entries are
        reaped on the way."""
        total = 0
        now = time.monotonic_ns()
        stale_ns = stale_reap_ns()
        with self._lock:
            for i in range(MAX_ENTRIES):
                e = self._entry(i)
                if e.pid == 0 or e.host_index != host_index:
                    continue
                if exclude_pid is not None and e.pid == exclude_pid:
                    continue
                if exclude_token is not None and \
                        e.owner_token == exclude_token:
                    continue
                if not pid_alive(e.pid) and \
                        now - e.last_update_ns > stale_ns:
                    self._write_entry(i, _FREE)
                    continue
                total += e.bytes
        return total

    def record_spilled(self, pid: int, host_index: int, spilled: int,
                       owner_token: int | None = None) -> None:
        """Set this pid's host-pool bytes on a device. One row per (pid,
        device) holds both sides, so the reap covers both; a spill by a
        process with no resident bytes claims a zero-byte slot."""
        now = time.monotonic_ns()
        token = owner_token if owner_token is not None \
            else owner_token_from_env()
        with self._lock:
            for i in range(MAX_ENTRIES):
                e = self._entry(i)
                if e.pid == pid and e.host_index == host_index:
                    if spilled == 0 and e.bytes == 0:
                        self._write_entry(i, _FREE)
                    else:
                        e.spilled = spilled
                        e.last_update_ns = now
                        self._write_entry(i, e)
                    return
            if spilled == 0:
                return
            slot = self._free_slot_locked()
            if slot is None:
                raise RuntimeError("vmem ledger full")
            self._write_entry(slot, VmemEntry(pid, host_index, 0, now, token,
                                              spilled=spilled))

    def node_spilled_total(self, exclude_pid: int | None = None) -> int:
        """Live spilled bytes across the node, what the spill budget
        bounds; dead and stale entries are reaped on the way."""
        total = 0
        now = time.monotonic_ns()
        stale_ns = stale_reap_ns()
        with self._lock:
            for i in range(MAX_ENTRIES):
                e = self._entry(i)
                if e.pid == 0:
                    continue
                if exclude_pid is not None and e.pid == exclude_pid:
                    continue
                if not pid_alive(e.pid) and \
                        now - e.last_update_ns > stale_ns:
                    self._write_entry(i, _FREE)
                    continue
                total += e.spilled
        return total

    def bump_activity(self, pid: int, host_index: int, n: int = 1,
                      owner_token: int | None = None) -> None:
        """A Python-side launch tick (the interposer bumps its own entry
        lock-free). A tenant with no entry claims a zero-byte slot."""
        token = owner_token if owner_token is not None \
            else owner_token_from_env()
        now = time.monotonic_ns()
        with self._lock:
            free_slot = None
            for i in range(MAX_ENTRIES):
                e = self._entry(i)
                if e.pid == pid and e.host_index == host_index and \
                        (e.owner_token == 0 or e.owner_token == token):
                    e.activity += n
                    e.last_update_ns = now
                    self._write_entry(i, e)
                    return
                if e.pid == 0 and free_slot is None:
                    free_slot = i
            if free_slot is not None:
                self._write_entry(free_slot, VmemEntry(
                    pid, host_index, 0, now, token, n))

    def entries(self) -> list[VmemEntry]:
        with self._lock:
            return [e for i in range(MAX_ENTRIES)
                    if (e := self._entry(i)).pid != 0]

    def reap_dead(self) -> int:
        with self._lock:
            return self._reap_locked()

    def _reap_locked(self) -> int:
        reaped = 0
        now = time.monotonic_ns()
        stale_ns = stale_reap_ns()
        for i in range(MAX_ENTRIES):
            e = self._entry(i)
            if e.pid != 0 and not pid_alive(e.pid) and \
                    now - e.last_update_ns > stale_ns:
                self._write_entry(i, _FREE)
                reaped += 1
        return reaped
