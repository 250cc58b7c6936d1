"""The step ring: one ring of fixed-width step records per tenant container.

The port of the JAX package's `telemetry/stepring.py:31-377`, ring layout
v4 byte for byte, so either package's reader reads either's rings. The
ring lives under the container's config directory on the host
(`<base>/<uid>_<cont>/telemetry/step_telemetry.ring`), mounted read-write
at `MANAGER_BASE_DIR/telemetry` in the container. The tenant's step loop
writes it (`runtime/client.step_telemetry`); the node reads it by cursor.

Each record carries its own seqlock (the writer makes `seq | 1` odd before
the payload and even after; a reader retries on an odd or changed seq).
One writer per ring, held by an OFD write lock on the header taken when it
opens the ring; recording takes no lock and makes no system call.

Slot = index % capacity; the oldest records are overwritten. The header's
`writes` counter is the head. A reader that fell more than a ring behind
counts the overwritten records as drops, and every record it validates
names its own index, so a slot overwritten mid-read is never taken for
another step. The port's interposer measures no spill, fill or
communication yet: those fields are written as zeros, the JAX package's
contract when their gates are off.
"""

from __future__ import annotations

import mmap
import os
import struct
import time
from dataclasses import dataclass
from typing import ClassVar

from vtpu_manager_torch.config.tc_watcher import byte_range_write_lock

MAGIC = 0x54535456          # "VTST" little-endian
# v2 added the spill block (spilled_bytes, spill/fill events), v3 the
# communication block (comm time, bytes moved, collective count), v4
# spill_fill_time_ns. A reader checks the version strictly: rings are made
# anew per container, and plugin, interposer and reader ship together.
VERSION = 4
RING_CAPACITY = 256          # records; ~memory of the last 256 steps
TRACE_ID_LEN = 48            # same bound as vtpu_config's pod_uid

# header: magic u32, version u32, capacity i32, record_size i32,
# writer_pid i32, pad i32, writes u64 (total records ever published),
# trace_id[48] (vtrace join key; one per ring — a ring is one tenant
# process's step stream)
_HEADER_FMT = "<IIiiiiQ48s"
HEADER_SIZE = struct.calcsize(_HEADER_FMT)
assert HEADER_SIZE == 80

# record: seq u64 (per-record seqlock), index u64, start_mono_ns u64,
# duration_ns u64, throttle_wait_ns u64, hbm_highwater_bytes u64,
# flags u32, pad u32 (the port's bucket_wait_us under FLAG_BUCKET_WAIT),
# spilled_bytes u64, spill_events u32,
# fill_events u32 (v2 spill block, vtovc), comm_time_ns u64,
# bytes_transferred u64, collective_count u32, pad2 u32 (v3 comm
# block, vtcomm; zeros when CommTelemetry is off),
# spill_fill_time_ns u64 (v4, vtslo; zeros when the spill tier never
# measured a demotion/promotion span)
_RECORD_FMT = "<QQQQQQIIQIIQQIIQ"
RECORD_SIZE = struct.calcsize(_RECORD_FMT)
assert RECORD_SIZE == 104

FILE_SIZE = HEADER_SIZE + RING_CAPACITY * RECORD_SIZE

FLAG_COMPILE = 0x1           # step paid a compile / first-execute
# vtheal: the step's Execute (or a transfer inside it) returned an
# error the shim/runtime recovered from. A NEW BIT in the existing v4
# flags field — no layout change, no version bump: v4 readers that
# don't know the bit see it as reserved-zero semantics (they only test
# FLAG_COMPILE), and the health plane's signals.py reads trailing
# streaks of it as dead-chip evidence (one errored step is a retry;
# a streak is a chip that stopped executing).
FLAG_EXEC_ERROR = 0x2
# The port's bit (csrc/shim/vtpu_telemetry_abi.h kStepFlagBucketWait): the
# record's throttle_wait_ns is the step's time off the card, and the pad
# after the flags holds the bucket's own wait in us (`bucket_wait_us`). A
# reader that does not know the bit reads the JAX layout as before.
FLAG_BUCKET_WAIT = 0x4

_WRITES_OFFSET = 24          # header offset of the u64 writes counter
_TRACE_ID_OFFSET = 32
_RECORD = struct.Struct(_RECORD_FMT)


def _words(mm) -> memoryview:
    """The mapping as native u64 words (little-endian on every host the
    port runs on). A word is loaded and stored whole: struct.pack_into
    zero-fills its bytes before it writes them, so a reader in another
    process could see a seq or head pass through 0 or a partial value,
    twice in a row when the writer is preempted between the two."""
    return memoryview(mm).cast("Q")


def record_offset(slot: int) -> int:
    return HEADER_SIZE + slot * RECORD_SIZE


@dataclass
class StepRecord:
    index: int
    start_mono_ns: int
    duration_ns: int
    throttle_wait_ns: int = 0
    hbm_highwater_bytes: int = 0
    flags: int = 0
    spilled_bytes: int = 0       # host-pool footprint at step end (gauge)
    spill_events: int = 0        # HBM→host demotions since last record
    fill_events: int = 0         # host→HBM promotions since last record
    comm_time_ns: int = 0        # measured collective+transfer span time
    bytes_transferred: int = 0   # bytes observed moving since last record
    collective_count: int = 0    # multi-chip dispatches since last record
    spill_fill_time_ns: int = 0  # measured host-tier spill+fill span time
    # the port's, with FLAG_BUCKET_WAIT: set on the instance by the reader,
    # outside the fields, so a record compares and unpacks as the JAX one
    bucket_wait_us: ClassVar[int] = 0

    @property
    def bucket_wait_ns(self) -> int:
        """The step's wait in the bucket: carried apart when the record's
        throttle wait is its time off the card, else that wait."""
        if self.flags & FLAG_BUCKET_WAIT:
            return self.bucket_wait_us * 1000
        return self.throttle_wait_ns

    @property
    def compiled(self) -> bool:
        return bool(self.flags & FLAG_COMPILE)

    @property
    def exec_error(self) -> bool:
        return bool(self.flags & FLAG_EXEC_ERROR)


class StepRingWriter:
    """Tenant-side writer. Construction does the one-time work (file
    create, mmap, writer-exclusion lock); ``record()`` is the hot path —
    mmap stores only, no locks, no syscalls."""

    def __init__(self, path: str, trace_id: str = "",
                 lock_timeout_s: float = 2.0):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path) or os.path.getsize(path) != FILE_SIZE:
            # atomic create (tmp + rename): a reader mmaping the final
            # path must never observe a partial file
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(struct.pack(
                    _HEADER_FMT, MAGIC, VERSION, RING_CAPACITY,
                    RECORD_SIZE, os.getpid(), 0, 0,
                    trace_id.encode()[:TRACE_ID_LEN]))
                f.write(b"\0" * (FILE_SIZE - HEADER_SIZE))
            os.rename(tmp, path)
        self._fd = os.open(path, os.O_RDWR)
        try:
            # writer exclusion across container restarts: held for the
            # ring's lifetime (the kernel releases it on crash), taken
            # once here — never on the step path. Short timeout: a held
            # lock means another LIVE writer owns this ring, and waiting
            # the full lock budget would stall tenant startup
            self._lock_ctx = byte_range_write_lock(self._fd, 0, HEADER_SIZE,
                                                   timeout_s=lock_timeout_s)
            self._lock_ctx.__enter__()
            self._mm = mmap.mmap(self._fd, FILE_SIZE)
        except (ValueError, OSError):
            os.close(self._fd)
            self._fd = None
            raise
        self._w = _words(self._mm)
        magic, version, cap, rec_size, _, _, writes, _ = struct.unpack_from(
            _HEADER_FMT, self._mm, 0)
        if magic != MAGIC or version != VERSION or cap != RING_CAPACITY \
                or rec_size != RECORD_SIZE:
            self.close()
            raise ValueError(f"bad step ring {path}")
        # a restarted container continues the sequence: the reader's
        # cursor stays monotone across writer generations
        self._writes = writes
        struct.pack_into("<i", self._mm, 16, os.getpid())
        if trace_id:
            struct.pack_into(f"<{TRACE_ID_LEN}s", self._mm,
                             _TRACE_ID_OFFSET,
                             trace_id.encode()[:TRACE_ID_LEN])

    @property
    def writes(self) -> int:
        return self._writes

    def record(self, duration_ns: int, throttle_wait_ns: int = 0,
               hbm_highwater_bytes: int = 0, compiled: bool = False,
               start_mono_ns: int | None = None, spilled_bytes: int = 0,
               spill_events: int = 0, fill_events: int = 0,
               comm_time_ns: int = 0, bytes_transferred: int = 0,
               collective_count: int = 0,
               spill_fill_time_ns: int = 0,
               exec_error: bool = False,
               bucket_wait_ns: int | None = None) -> None:
        """Publish one step record (the hot path). Seqlock bracket per
        the shared-mmap protocol: odd seq first, payload, even seq last
        — ``seq | 1`` so a crashed writer's odd leftover can't invert
        parity and let torn reads validate."""
        if start_mono_ns is None:
            start_mono_ns = time.monotonic_ns() - duration_ns
        index = self._writes
        off = record_offset(index % RING_CAPACITY)
        seq_word = off // 8
        wseq = self._w[seq_word] | 1
        self._w[seq_word] = wseq                         # odd: writing
        flags = (FLAG_COMPILE if compiled else 0) | \
            (FLAG_EXEC_ERROR if exec_error else 0)
        bucket_us = 0
        if bucket_wait_ns is not None:
            # throttle_wait_ns is then the step's time off the card
            flags |= FLAG_BUCKET_WAIT
            bucket_us = min(bucket_wait_ns // 1000, 0xFFFFFFFF)
        payload = _RECORD.pack(wseq, index,
                               start_mono_ns, duration_ns, throttle_wait_ns,
                               hbm_highwater_bytes, flags, bucket_us,
                               spilled_bytes, spill_events, fill_events,
                               comm_time_ns, bytes_transferred,
                               collective_count, 0, spill_fill_time_ns)
        # everything after the seq, copied over the old bytes (no zero-fill)
        self._mm[off + 8:off + RECORD_SIZE] = payload[8:]
        self._w[seq_word] = wseq + 1                     # even: stable
        self._writes = index + 1
        self._w[_WRITES_OFFSET // 8] = self._writes

    def close(self) -> None:
        if getattr(self, "_w", None) is not None:
            self._w.release()
            self._w = None
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
            self._mm = None
        if getattr(self, "_lock_ctx", None) is not None:
            try:
                self._lock_ctx.__exit__(None, None, None)
            # the kernel drops the OFD lock with the fd regardless, and at
            # interpreter shutdown even the unlock can fail
            except Exception:  # noqa: BLE001
                pass
            self._lock_ctx = None
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)
            self._fd = None


class StepRingReader:
    """Monitor-side reader: lock-free seqlock reads, cursor-tailed."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        try:
            self._mm = mmap.mmap(self._fd, FILE_SIZE,
                                 prot=mmap.PROT_READ)
        except (ValueError, OSError):
            os.close(self._fd)
            self._fd = None
            raise
        self._w = _words(self._mm)
        magic, version, cap, rec_size, pid, _, _, raw_tid = \
            struct.unpack_from(_HEADER_FMT, self._mm, 0)
        if magic != MAGIC or version != VERSION or cap != RING_CAPACITY \
                or rec_size != RECORD_SIZE:
            self.close()
            raise ValueError(f"bad step ring {path}")
        self.writer_pid = pid
        # the ring is writable by the TENANT: the trace id read back is
        # untrusted bytes headed for a Prometheus label — keep only the
        # charset real trace ids use (hex/uuid/word chars) so quotes or
        # newlines can't inject forged series into the node scrape
        raw = raw_tid.split(b"\0", 1)[0].decode(errors="replace")
        self.trace_id = "".join(
            c for c in raw if c.isalnum() or c in "._-")[:TRACE_ID_LEN]

    def close(self) -> None:
        if getattr(self, "_w", None) is not None:
            self._w.release()
            self._w = None
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
            self._mm = None
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)
            self._fd = None

    def _writes(self) -> int | None:
        """The head counter, double-read until stable: a u64 store is
        not atomic for a byte-wise mmap reader, and a torn head must
        never bound the scan. None when it never stabilizes — the
        caller skips that poll; advancing the monotone cursor to a torn
        value would stall the tenant's telemetry forever."""
        for _ in range(8):
            w1 = self._w[_WRITES_OFFSET // 8]
            w2 = self._w[_WRITES_OFFSET // 8]
            if w1 == w2:
                return w1
        return None

    def head(self) -> int | None:
        """Public head counter (total records ever published), or None
        when it never stabilizes — the vtheal stall signal polls this
        instead of tailing records: progress is the head advancing."""
        return self._writes()

    def read_record(self, index: int, retries: int = 8
                    ) -> StepRecord | None:
        """Seqlock read of one logical record; None when the slot is
        mid-write for all retries or was overwritten by a newer index."""
        off = record_offset(index % RING_CAPACITY)
        for _ in range(retries):
            seq1 = self._w[off // 8]
            if seq1 & 1:
                time.sleep(0.0002)
                continue
            (_, rec_index, start_ns, dur_ns, wait_ns, hbm, flags,
             bucket_us, spilled, spills, fills, comm_ns, comm_bytes,
             collectives, _pad2, spill_fill_ns) = _RECORD.unpack_from(
                 self._mm, off)
            seq2 = self._w[off // 8]
            if seq1 != seq2:
                continue
            if rec_index != index:
                return None     # lapped: slot already holds a newer step
            rec = StepRecord(rec_index, start_ns, dur_ns, wait_ns, hbm,
                             flags, spilled, spills, fills, comm_ns,
                             comm_bytes, collectives, spill_fill_ns)
            if bucket_us:
                rec.bucket_wait_us = bucket_us
            return rec
        return None

    def poll(self, cursor: int) -> tuple[list[StepRecord], int, int]:
        """(records, new_cursor, dropped) — every record with index in
        [cursor, head) still resident in the ring, in order. ``dropped``
        counts records the writer overwrote before this poll reached
        them (reader lagged by more than RING_CAPACITY). The returned
        cursor is monotone within one ring generation; a stable head
        BELOW the cursor means the file was recreated (writer reset to
        0), and the tail restarts from the new generation's records
        instead of freezing forever on the stale cursor."""
        head = self._writes()
        if head is None or head == cursor:
            return [], cursor, 0
        if head < cursor:
            cursor = 0
            if head == 0:
                return [], 0, 0
        start = max(cursor, head - RING_CAPACITY)
        dropped = start - cursor
        out: list[StepRecord] = []
        for index in range(start, head):
            rec = self.read_record(index)
            if rec is None:
                # overwritten (or persistently mid-write) while we
                # scanned: everything at or before it is gone too
                dropped += 1
                continue
            out.append(rec)
        return out, head, dropped


# Layout tables (field -> offset), held to the JAX package's by the tests.
HEADER_OFFSETS = {
    "magic": 0, "version": 4, "capacity": 8, "record_size": 12,
    "writer_pid": 16, "pad": 20, "writes": 24, "trace_id": 32,
}
RECORD_OFFSETS = {
    "seq": 0, "index": 8, "start_mono_ns": 16, "duration_ns": 24,
    "throttle_wait_ns": 32, "hbm_highwater_bytes": 40, "flags": 48,
    "spilled_bytes": 56, "spill_events": 64, "fill_events": 68,
    "comm_time_ns": 72, "bytes_transferred": 80, "collective_count": 88,
    "spill_fill_time_ns": 96,
}
