"""The node watcher's utilization feed (`tc_util.config`, layout v2).

The port's own copy of the JAX package's `config/tc_watcher.py:30-285`.
The node daemon (`manager/watcher.py`) samples each device's utilization
every 80 ms and writes it here with the share of each resident process;
every tenant's interposer maps the file read-only and reads it on its
10 ms tick instead of asking NVML itself.

Each device record is a seqlock: the writer makes `seq` odd, writes, and
makes it even; a reader retries while `seq` is odd or changed. Writers
exclude each other with an OFD byte-range lock per record. The
calibration block after the records is written and read so the file is
the JAX one; the interposer does not adopt it yet.
"""

from __future__ import annotations

import contextlib
import errno
import fcntl
import mmap
import os
import struct
import time
from dataclasses import dataclass, field

from vtpu_manager_torch.util import consts
from vtpu_manager_torch.util.flock import FileLock

MAGIC = 0x55544356            # "VCTU"
VERSION = 2
MAX_DEVICE_COUNT = 64
MAX_PROCS = 32
MAX_EXCESS_POINTS = 8

_HEADER_FMT = "<IIii"         # magic, version, device_count, pad
HEADER_SIZE = struct.calcsize(_HEADER_FMT)
assert HEADER_SIZE == 16
# proc: pid i32, util i32 (percent of the device), mem_used u64,
# owner_token u64
_PROC_FMT = "<iiQQ"
PROC_SIZE = struct.calcsize(_PROC_FMT)
assert PROC_SIZE == 24
# record: seq u64, timestamp_ns u64, device_util i32, proc_count i32,
# procs[32]
_RECORD_HEAD_FMT = "<QQii"
_RECORD_HEAD_SIZE = struct.calcsize(_RECORD_HEAD_FMT)
RECORD_SIZE = _RECORD_HEAD_SIZE + MAX_PROCS * PROC_SIZE
assert RECORD_SIZE == 24 + 32 * 24
# calibration: seq u64, timestamp_ns u64, n_points i32, pad i32,
# gap_us[8] i64, excess_us[8] i64
_CAL_FMT = f"<QQii{MAX_EXCESS_POINTS}q{MAX_EXCESS_POINTS}q"
CAL_SIZE = struct.calcsize(_CAL_FMT)
assert CAL_SIZE == 24 + 2 * 8 * MAX_EXCESS_POINTS
CAL_OFFSET = HEADER_SIZE + MAX_DEVICE_COUNT * RECORD_SIZE
FILE_SIZE = CAL_OFFSET + CAL_SIZE

_F_OFD_SETLK = 37
_STRUCT_FLOCK = "hhqqi4x"


def _ofd_lock(fd: int, ltype: int, offset: int, length: int) -> None:
    fcntl.fcntl(fd, _F_OFD_SETLK, struct.pack(
        _STRUCT_FLOCK, ltype, os.SEEK_SET, offset, length, 0))


@contextlib.contextmanager
def byte_range_write_lock(fd: int, offset: int, length: int,
                          timeout_s: float = consts.LOCK_TIMEOUT_S):
    """An OFD write lock on [offset, offset + length) of an open file."""
    deadline = time.monotonic() + timeout_s
    backoff = 0.001
    while True:
        try:
            _ofd_lock(fd, fcntl.F_WRLCK, offset, length)
            break
        except OSError as e:
            if e.errno not in (errno.EAGAIN, errno.EACCES):
                raise
        if time.monotonic() >= deadline:
            raise TimeoutError(f"byte-range lock fd={fd} @{offset}+{length}")
        time.sleep(backoff)
        backoff = min(backoff * 2, 0.010)
    try:
        yield
    finally:
        _ofd_lock(fd, fcntl.F_UNLCK, offset, length)


@dataclass
class ProcUtil:
    pid: int
    util: int            # percent of the device this process used
    mem_used: int        # bytes
    owner_token: int = 0


@dataclass
class DeviceUtil:
    timestamp_ns: int
    device_util: int     # device utilization, percent
    procs: list[ProcUtil] = field(default_factory=list)

    def is_fresh(self, window_s: float = consts.EXTERNAL_WATCHER_FRESH_S,
                 now_ns: int | None = None) -> bool:
        """A timestamp ahead of now is stale too (the file outlives a
        reboot; CLOCK_MONOTONIC does not)."""
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        return 0 <= (now_ns - self.timestamp_ns) <= window_s * 1e9


def record_offset(index: int) -> int:
    return HEADER_SIZE + index * RECORD_SIZE


class TcUtilFile:
    """Writer and reader over the shared mapping."""

    def __init__(self, path: str = consts.TC_UTIL_CONFIG,
                 device_count: int = MAX_DEVICE_COUNT, create: bool = False,
                 reset: bool = False):
        """create: build the file when missing or wrong-sized (by rename:
        truncating in place would fault every reader's mapping). reset:
        zero every record (daemon start)."""
        self.path = path
        if create:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with FileLock(path + ".create.lock"):
                size = os.path.getsize(path) if os.path.exists(path) else -1
                if size == CAL_OFFSET and self._magic_ok(path):
                    # v1 -> v2: grow in place, so running readers keep
                    # their mapping of the records
                    fd = os.open(path, os.O_RDWR)
                    try:
                        os.ftruncate(fd, FILE_SIZE)
                        os.pwrite(fd, struct.pack("<I", VERSION), 4)
                    finally:
                        os.close(fd)
                elif size != FILE_SIZE:
                    tmp = f"{path}.tmp.{os.getpid()}"
                    with open(tmp, "wb") as f:
                        f.write(struct.pack(_HEADER_FMT, MAGIC, VERSION,
                                            device_count, 0))
                        f.write(b"\0" * (FILE_SIZE - HEADER_SIZE))
                    os.rename(tmp, path)
        self._fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(self._fd).st_size
            self._mm = mmap.mmap(self._fd, min(size, FILE_SIZE))
        except (ValueError, OSError):
            os.close(self._fd)
            self._fd = None
            raise
        magic, version, self.device_count, _ = struct.unpack_from(
            _HEADER_FMT, self._mm, 0)
        if magic != MAGIC or not 1 <= version <= VERSION:
            self.close()
            raise ValueError(f"bad tc_util file {path}")
        self._has_cal = version >= 2 and len(self._mm) >= FILE_SIZE
        if reset:
            empty = DeviceUtil(timestamp_ns=0, device_util=0)
            for i in range(MAX_DEVICE_COUNT):
                self.write_device(i, empty)

    @staticmethod
    def _magic_ok(path: str) -> bool:
        try:
            with open(path, "rb") as f:
                return struct.unpack("<I", f.read(4))[0] == MAGIC
        except (OSError, struct.error):
            return False

    def close(self) -> None:
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
            self._mm = None
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)
            self._fd = None

    def write_device(self, index: int, util: DeviceUtil) -> None:
        if not 0 <= index < MAX_DEVICE_COUNT:
            raise IndexError(index)
        procs = util.procs[:MAX_PROCS]
        off = record_offset(index)
        with byte_range_write_lock(self._fd, off, RECORD_SIZE):
            seq, = struct.unpack_from("<Q", self._mm, off)
            # odd while writing, even if a crashed writer left it odd
            wseq = seq | 1
            struct.pack_into("<Q", self._mm, off, wseq)
            struct.pack_into(_RECORD_HEAD_FMT, self._mm, off, wseq,
                             util.timestamp_ns, util.device_util, len(procs))
            poff = off + _RECORD_HEAD_SIZE
            for i, p in enumerate(procs):
                struct.pack_into(_PROC_FMT, self._mm, poff + i * PROC_SIZE,
                                 p.pid, p.util, p.mem_used, p.owner_token)
            struct.pack_into("<Q", self._mm, off, wseq + 1)

    def write_calibration(self, table: list[tuple[int, int]],
                          now_ns: int | None = None) -> None:
        """Publish a (gap_us, excess_us) table: ascending gaps, the last
        input wins on a duplicate gap, a long table keeps its first 7
        points and its last."""
        if not self._has_cal:
            raise ValueError("tc_util file has no calibration block (v1)")
        by_gap: dict[int, int] = {}
        for g, e in table:
            by_gap[g] = e
        pts = sorted(by_gap.items())
        if len(pts) > MAX_EXCESS_POINTS:
            pts = pts[:MAX_EXCESS_POINTS - 1] + [pts[-1]]
        now_ns = time.monotonic_ns() if now_ns is None else now_ns
        gaps = [g for g, _ in pts] + [0] * (MAX_EXCESS_POINTS - len(pts))
        exc = [e for _, e in pts] + [0] * (MAX_EXCESS_POINTS - len(pts))
        with byte_range_write_lock(self._fd, CAL_OFFSET, CAL_SIZE):
            seq, = struct.unpack_from("<Q", self._mm, CAL_OFFSET)
            wseq = seq | 1
            struct.pack_into("<Q", self._mm, CAL_OFFSET, wseq)
            struct.pack_into(_CAL_FMT, self._mm, CAL_OFFSET, wseq, now_ns,
                             len(pts), 0, *gaps, *exc)
            struct.pack_into("<Q", self._mm, CAL_OFFSET, wseq + 1)

    def read_calibration(self, retries: int = 8
                         ) -> list[tuple[int, int]] | None:
        """The table, or None when absent, empty or mid-write throughout."""
        if not self._has_cal:
            return None
        for _ in range(retries):
            seq1, = struct.unpack_from("<Q", self._mm, CAL_OFFSET)
            if seq1 & 1:
                time.sleep(0.0002)
                continue
            vals = struct.unpack_from(_CAL_FMT, self._mm, CAL_OFFSET)
            seq2, = struct.unpack_from("<Q", self._mm, CAL_OFFSET)
            if seq1 != seq2:
                continue
            n = max(0, min(vals[2], MAX_EXCESS_POINTS))
            if n == 0:
                return None
            gaps = vals[4:4 + MAX_EXCESS_POINTS]
            exc = vals[4 + MAX_EXCESS_POINTS:4 + 2 * MAX_EXCESS_POINTS]
            return [(gaps[i], exc[i]) for i in range(n)]
        return None

    def read_device(self, index: int, retries: int = 8) -> DeviceUtil | None:
        """Lock-free seqlock read; None when the record is mid-write for
        every retry."""
        if not 0 <= index < MAX_DEVICE_COUNT:
            raise IndexError(index)
        off = record_offset(index)
        for _ in range(retries):
            seq1, = struct.unpack_from("<Q", self._mm, off)
            if seq1 & 1:
                time.sleep(0.0002)
                continue
            _, ts, dev_util, count = struct.unpack_from(
                _RECORD_HEAD_FMT, self._mm, off)
            count = max(0, min(count, MAX_PROCS))
            poff = off + _RECORD_HEAD_SIZE
            procs = [ProcUtil(*struct.unpack_from(
                _PROC_FMT, self._mm, poff + i * PROC_SIZE))
                for i in range(count)]
            seq2, = struct.unpack_from("<Q", self._mm, off)
            if seq1 == seq2:
                return DeviceUtil(timestamp_ns=ts, device_util=dev_util,
                                  procs=procs)
        return None
