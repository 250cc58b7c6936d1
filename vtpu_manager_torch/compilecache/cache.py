"""The node compile cache's store: checksummed entries, one compile per key
across tenants, eviction and quarantine, and the counters the exporter
reads.

The port of the JAX package's `compilecache/cache.py:95-800`, with the
same files and bytes under one node-shared root, so an entry either
package writes, the other reads:

    <root>/entries/<key>            an entry: header + payload
    <root>/quarantine/<key>.<ns>    entries that failed verification
    <root>/lease/<key>.lease        who is compiling a key
    <root>/tmp/                     entries being written
    <root>/stats/<id>.json          a client's counters
    <root>/stats/<id>.lock          held (flock) while that client lives
    <root>/stats/aggregate.json     exited clients' counters, folded under
                                    stats/aggregate.json.lock

An entry is a 24-byte header (magic "VTCC", version 1, payload length,
FNV-1a 64 of the payload, little-endian) and the payload. It lands by
temp file, fsync and rename; every read verifies it, and one that fails
is moved to `quarantine/` and read as a miss.

A key's lease is a file created by link() already holding `pid@wall_ts`
and already flock'd by its holder for the compile's life: the kernel
drops the lock when the holder dies, in any PID namespace. A waiter takes
over a lease whose lock is free, or whose stamp is older than the stale
budget (a wedged holder); the link decides a race, so two takeovers cost
at most one duplicate compile. A holder releases only the lease whose
bytes are still the ones it wrote.

Counters never fail an operation: a stats write that fails is dropped,
and a put that fails after a compile serves the compiled payload
uncached. `get_or_compile` is the `shim.compile` span of a traced tenant,
followed by its `shim.compile_outcome` event (`cache.py:433-446`). What
the JAX store adds besides (its failpoints and the cluster tier's peer
fetch) is not ported.
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import struct
import time

from vtpu_manager_torch import trace
from vtpu_manager_torch.util import stalecodec
from vtpu_manager_torch.util.flock import FileLock, LockTimeout

log = logging.getLogger(__name__)

MAGIC = 0x43435456            # "VTCC" little-endian
VERSION = 1

# entry header: magic u32, version u32, payload_len u64, fnv64 u64
_ENTRY_HEADER_FMT = "<IIQQ"
ENTRY_HEADER_SIZE = struct.calcsize(_ENTRY_HEADER_FMT)

# A lease older than this is stale even while its lock is held: no compile
# takes longer, and a waiter must make progress.
STALE_LEASE_S = float(os.environ.get("VTPU_CACHE_STALE_LEASE_S", "300"))

# the evictor's default budget (the device plugin's
# --compile-cache-budget-mb overrides it)
DEFAULT_BUDGET_BYTES = 4 << 30

# quarantined entries are kept a day, and at most this many
QUARANTINE_RETENTION_S = 24 * 3600.0
QUARANTINE_KEEP_MAX = 64

# a stats file younger than this is never judged dead, whatever its lock
_STATS_DEAD_AGE_S = 60.0

_POLL_S = 0.05                # a waiter's poll while a lease is held

STAT_FIELDS = ("hits", "misses", "single_flight_waits", "evictions",
               "quarantined", "peer_fetches", "peer_fetch_failures")


def _fnv1a64(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _flock_nb(fd: int) -> bool:
    """One non-blocking exclusive flock attempt."""
    import fcntl
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        return True
    except OSError:
        return False


def _flock_grabbable(path: str) -> bool | None:
    """Whether `path`'s flock is free (its holder is dead); None when the
    probe itself fails (the file vanished)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return None
    try:
        return _flock_nb(fd)
    finally:
        os.close(fd)


def _pid_alive(pid: int) -> bool:
    """A pid probe in this namespace: only the fallback when a lock cannot
    be probed, since a pid means nothing across containers."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class CacheStats:
    """A client's operation counters, written to its stats file after
    every operation (compile-scale rare)."""

    __slots__ = STAT_FIELDS

    def __init__(self) -> None:
        for name in STAT_FIELDS:
            setattr(self, name, 0)

    def as_dict(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in STAT_FIELDS}


class CompileCache:
    """A process's handle on the node-shared store. Construction makes the
    subdirectories; every method is safe against clients in other
    processes and containers."""

    def __init__(self, root: str, stale_lease_s: float = STALE_LEASE_S):
        self.root = root
        self.stale_lease_s = stale_lease_s
        self.entries_dir = os.path.join(root, "entries")
        self.quarantine_dir = os.path.join(root, "quarantine")
        self.lease_dir = os.path.join(root, "lease")
        self.tmp_dir = os.path.join(root, "tmp")
        self.stats_dir = os.path.join(root, "stats")
        for d in (self.entries_dir, self.quarantine_dir, self.lease_dir,
                  self.tmp_dir, self.stats_dir):
            os.makedirs(d, exist_ok=True)
        self.stats = CacheStats()
        # the stats file's name carries a random token (pids collide
        # across containers); the client lives while it holds the flock of
        # its .lock file. Without that lock only the counters are off.
        self._stats_stem = f"{os.getpid()}-{secrets.token_hex(4)}"
        self._stats_lock_fd: int | None = None
        try:
            fd = os.open(self._stats_sentinel_path(),
                         os.O_CREAT | os.O_RDWR, 0o666)
            if _flock_nb(fd):
                self._stats_lock_fd = fd
            else:
                os.close(fd)
        except OSError:
            log.debug("compile cache stats lock unavailable", exc_info=True)
        # key -> (the fd holding the lease's flock, the bytes written)
        self._leases: dict[str, tuple[int, bytes]] = {}

    # -- paths ---------------------------------------------------------------

    def entry_path(self, key: str) -> str:
        return os.path.join(self.entries_dir, key)

    def _lease_path(self, key: str) -> str:
        return os.path.join(self.lease_dir, f"{key}.lease")

    # -- reads ---------------------------------------------------------------

    def get(self, key: str) -> bytes | None:
        """The verified payload, or None; counted as a hit or a miss."""
        payload = self._lookup(key)
        if payload is None:
            self.stats.misses += 1
        else:
            self.stats.hits += 1
        self._flush_stats()
        return payload

    def _lookup(self, key: str) -> bytes | None:
        """A verified read that counts nothing (a waiter polls it). A
        corrupt entry is quarantined; a read refreshes the entry's mtime,
        the evictor's recency."""
        path = self.entry_path(key)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        except OSError as e:
            log.warning("compile cache entry %s unreadable (%s)", key, e)
            return None
        payload = self._verify(raw)
        if payload is None:
            self._quarantine(key)
            return None
        try:
            os.utime(path)
        except OSError:
            pass
        return payload

    @staticmethod
    def _verify(raw: bytes) -> bytes | None:
        if len(raw) < ENTRY_HEADER_SIZE:
            return None
        magic, version, length, checksum = struct.unpack_from(
            _ENTRY_HEADER_FMT, raw, 0)
        if magic != MAGIC or version != VERSION:
            return None
        payload = raw[ENTRY_HEADER_SIZE:]
        if len(payload) != length or _fnv1a64(payload) != checksum:
            return None
        return payload

    def _quarantine(self, key: str) -> None:
        """Moves a corrupt entry aside under a time-stamped name; rename
        succeeds for one racer."""
        src = self.entry_path(key)
        dst = os.path.join(self.quarantine_dir, f"{key}.{time.time_ns()}")
        try:
            os.rename(src, dst)
        except OSError:
            return
        self.stats.quarantined += 1
        self._flush_stats()
        log.error("compile cache entry %s failed verification; "
                  "quarantined to %s", key, dst)

    # -- writes --------------------------------------------------------------

    def put(self, key: str, payload: bytes) -> None:
        """Lands an entry: a temp file with a random name in tmp/ (same
        filesystem), fsync, rename. A crash before the rename leaves a temp
        file the evictor reaps."""
        tmp = os.path.join(
            self.tmp_dir, f"{key}.{os.getpid()}.{secrets.token_hex(4)}")
        header = struct.pack(_ENTRY_HEADER_FMT, MAGIC, VERSION,
                             len(payload), _fnv1a64(payload))
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, self.entry_path(key))

    # -- one compile per key -------------------------------------------------

    def _read_lease(self, path: str) -> tuple[int, float] | None:
        """(pid, wall_ts), None when absent; garbage reads as (0, 0.0), the
        stalest lease there is."""
        try:
            with open(path) as f:
                raw = f.read()
        except OSError:
            return None
        split = stalecodec.split_stamp(raw)
        if split is None:
            return 0, 0.0
        try:
            return int(split[0]), split[1]
        except ValueError:
            return 0, 0.0

    def _lease_stale(self, path: str, pid: int, ts: float) -> bool:
        # a stamp too old, or too far in the future, is stale
        if not stalecodec.is_fresh(ts, max_age_s=self.stale_lease_s,
                                   skew_s=self.stale_lease_s):
            return True
        grabbable = _flock_grabbable(path)
        if grabbable is not None:
            return grabbable
        return not _pid_alive(pid)

    def _link_lease(self, path: str) -> tuple[int, bytes] | None:
        """Creates `path` already holding our pid@ts and our flock (the
        temp inode is locked before the link). (fd, bytes), or None when
        another lease won (EEXIST)."""
        tmp = f"{path}.{os.getpid()}.{secrets.token_hex(4)}.tmp"
        payload = stalecodec.stamp(str(os.getpid()), time.time()).encode()
        fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o666)
        try:
            os.write(fd, payload)
            if not _flock_nb(fd):
                raise OSError("flock on a fresh lease file failed")
            os.link(tmp, path)
        except FileExistsError:
            os.close(fd)
            return None
        except OSError:
            os.close(fd)
            raise
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return fd, payload

    def try_acquire_lease(self, key: str) -> bool:
        """One attempt; True when this process now holds `key`'s lease. A
        dead or stale holder's lease is taken over, after checking it is
        still the one read."""
        path = self._lease_path(key)
        try:
            linked = self._link_lease(path)
        except OSError:
            return False
        if linked is not None:
            self._leases[key] = linked
            return True
        held = self._read_lease(path)
        if held is None or not self._lease_stale(path, *held):
            return False
        if self._read_lease(path) != held:
            return False
        try:
            os.unlink(path)
        except OSError:
            return False
        try:
            linked = self._link_lease(path)
        except OSError:
            return False
        if linked is None:
            return False
        self._leases[key] = linked
        return True

    def release_lease(self, key: str) -> None:
        """Drops the lock, and the lease file if it still holds our bytes
        (a takeover may have replaced it)."""
        fd, payload = self._leases.pop(key, (None, None))
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass
        if payload is None:
            return
        path = self._lease_path(key)
        try:
            with open(path, "rb") as f:
                current = f.read()
        except OSError:
            return
        if current == payload:
            try:
                os.unlink(path)
            except OSError:
                pass

    def get_or_compile(self, key: str, compile_fn,
                       timeout_s: float = 600.0,
                       ctx=None) -> tuple[bytes, str]:
        """(payload, outcome): `hit` (the entry was there), `miss` (this
        process compiled and stored), `wait` (another client compiled
        while this one waited on its lease) or `timeout` (the holder
        outlived `timeout_s`: compiled here, not stored). Each call counts
        one hit or one miss, and a wait besides. With a sampled trace
        context `ctx` the call is the `shim.compile` span, and its outcome
        the `shim.compile_outcome` event after it."""
        with trace.span(ctx, "shim.compile", key=key[:16]):
            payload, outcome = self._get_or_compile(key, compile_fn,
                                                    timeout_s)
        trace.event(ctx, "shim.compile_outcome", outcome=outcome,
                    key=key[:16])
        return payload, outcome

    def _get_or_compile(self, key: str, compile_fn,
                        timeout_s: float) -> tuple[bytes, str]:
        payload = self._lookup(key)
        if payload is not None:
            self.stats.hits += 1
            self._flush_stats()
            return payload, "hit"
        deadline = time.monotonic() + timeout_s
        waited = False
        while True:
            if self.try_acquire_lease(key):
                try:
                    # another client may have stored it before the lease
                    payload = self._lookup(key)
                    if payload is not None:
                        self.release_lease(key)
                        self.stats.hits += 1
                        self._flush_stats()
                        return payload, ("wait" if waited else "hit")
                    payload = compile_fn()
                    try:
                        self.put(key, payload)
                    except OSError:
                        # the compile stands: a broken store costs the
                        # sharing, never the tenant's program
                        log.warning("compile cache put failed for %s; "
                                    "serving uncached", key, exc_info=True)
                    self.release_lease(key)
                    self.stats.misses += 1
                    self._flush_stats()
                    return payload, "miss"
                except Exception:
                    self.release_lease(key)
                    raise
            if not waited:
                waited = True
                self.stats.single_flight_waits += 1
                self._flush_stats()
            if time.monotonic() >= deadline:
                log.warning("compile cache lease for %s held past the "
                            "%.0fs budget; compiling uncached", key,
                            timeout_s)
                self.stats.misses += 1
                self._flush_stats()
                return compile_fn(), "timeout"
            time.sleep(_POLL_S)
            payload = self._lookup(key)
            if payload is not None:
                self.stats.hits += 1
                self._flush_stats()
                return payload, "wait"

    # -- eviction ------------------------------------------------------------

    def evict(self, budget_bytes: int = DEFAULT_BUDGET_BYTES,
              now: float | None = None) -> int:
        """Drops the least recently used entries until entries/ fits the
        budget, reaps stale temp files and old quarantined entries, and
        folds exited clients' counters. Returns the entries dropped."""
        now = time.time() if now is None else now
        entries = []
        total = 0
        for name in self._listdir(self.entries_dir):
            path = os.path.join(self.entries_dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, path))
            total += st.st_size
        evicted = 0
        for _mtime, size, path in sorted(entries):
            if total <= budget_bytes:
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            evicted += 1
        if evicted:
            self.stats.evictions += evicted
            self._flush_stats()
        for name in self._listdir(self.tmp_dir):
            path = os.path.join(self.tmp_dir, name)
            try:
                if now - os.stat(path).st_mtime > self.stale_lease_s:
                    os.unlink(path)
            except OSError:
                continue
        self._reap_quarantine(now)
        self._fold_dead_stats()
        return evicted

    def _reap_quarantine(self, now: float) -> None:
        """Keeps the newest QUARANTINE_KEEP_MAX quarantined entries younger
        than the retention."""
        corpses = []
        for name in self._listdir(self.quarantine_dir):
            path = os.path.join(self.quarantine_dir, name)
            try:
                corpses.append((os.stat(path).st_mtime, path))
            except OSError:
                continue
        corpses.sort(reverse=True)
        for i, (mtime, path) in enumerate(corpses):
            if i < QUARANTINE_KEEP_MAX and \
                    now - mtime <= QUARANTINE_RETENTION_S:
                continue
            try:
                os.unlink(path)
            except OSError:
                continue

    @staticmethod
    def _listdir(path: str) -> list[str]:
        try:
            return os.listdir(path)
        except OSError:
            return []

    # -- counters ------------------------------------------------------------

    def _stats_path(self) -> str:
        return os.path.join(self.stats_dir, f"{self._stats_stem}.json")

    def _stats_sentinel_path(self) -> str:
        return os.path.join(self.stats_dir, f"{self._stats_stem}.lock")

    def _flush_stats(self) -> None:
        if self._stats_lock_fd is None:
            return      # unlocked, the file would be folded as dead
        tmp = f"{self._stats_path()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(self.stats.as_dict(), f)
            os.rename(tmp, self._stats_path())
        except OSError:
            log.debug("compile cache stats flush failed", exc_info=True)

    def close(self) -> None:
        """Drops the stats lock (the kernel does so at exit); the stats
        file stays for the fold."""
        if self._stats_lock_fd is not None:
            try:
                os.close(self._stats_lock_fd)
            except OSError:
                pass
            self._stats_lock_fd = None

    def _fold_dead_stats(self) -> None:
        """Merges exited clients' counters into aggregate.json and removes
        their files, all under the lock `node_totals` takes, so a scrape
        sees neither a dip nor a double count. A client is dead when its
        .lock file's flock is free (or it has none) and its stats file is
        older than _STATS_DEAD_AGE_S."""
        dead: list[str] = []
        for name in self._listdir(self.stats_dir):
            stem, _, ext = name.rpartition(".")
            if ext != "json" or stem in ("", "aggregate"):
                continue
            path = os.path.join(self.stats_dir, name)
            try:
                if time.time() - os.stat(path).st_mtime < _STATS_DEAD_AGE_S:
                    continue
            except OSError:
                continue
            sentinel = os.path.join(self.stats_dir, f"{stem}.lock")
            grabbable = _flock_grabbable(sentinel)
            if grabbable is None:
                if os.path.exists(sentinel):
                    continue
            elif not grabbable:
                continue
            dead.append(path)
        if not dead:
            return
        agg_path = os.path.join(self.stats_dir, "aggregate.json")
        try:
            with FileLock(agg_path + ".lock", timeout_s=2.0):
                agg = _read_stats_file(agg_path) or \
                    dict.fromkeys(STAT_FIELDS, 0)
                for path in dead:
                    counts = _read_stats_file(path)
                    if counts:
                        for field in STAT_FIELDS:
                            agg[field] = agg.get(field, 0) + \
                                int(counts.get(field, 0))
                tmp = agg_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(agg, f)
                os.rename(tmp, agg_path)
                for path in dead:
                    for victim in (path, path[:-len("json")] + "lock"):
                        try:
                            os.unlink(victim)
                        except OSError:
                            pass
        except (OSError, LockTimeout):
            log.debug("compile cache stats fold failed", exc_info=True)


def _read_stats_file(path: str) -> dict | None:
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else None
    except (OSError, ValueError):
        return None


def node_totals(root: str) -> tuple[dict[str, int], int, int]:
    """(summed counters, entry count, entry bytes) under `root`. The sum
    runs under the lock the fold of exited clients holds, so a scrape never
    sees counters mid-fold; a busy lock falls back to reading without it
    rather than stalling the scrape."""
    totals = dict.fromkeys(STAT_FIELDS, 0)
    stats_dir = os.path.join(root, "stats")
    agg_lock = FileLock(os.path.join(stats_dir, "aggregate.json.lock"),
                        timeout_s=0.5)
    locked = os.path.isdir(stats_dir)
    if locked:
        try:
            agg_lock.acquire()
        except (OSError, LockTimeout):
            locked = False
    try:
        try:
            names = os.listdir(stats_dir)
        except OSError:
            names = []
        for name in names:
            if not name.endswith(".json"):
                continue
            counts = _read_stats_file(os.path.join(stats_dir, name))
            if counts:
                for field in STAT_FIELDS:
                    totals[field] += int(counts.get(field, 0))
    finally:
        if locked:
            agg_lock.release()
    count = size = 0
    entries_dir = os.path.join(root, "entries")
    try:
        names = os.listdir(entries_dir)
    except OSError:
        names = []
    for name in names:
        try:
            size += os.stat(os.path.join(entries_dir, name)).st_size
            count += 1
        except OSError:
            continue
    return totals, count, size


def render_node_metrics(root: str, node_name: str) -> str:
    """The exporter's block: the counters and the entry and size gauges;
    no root (no tenant uses the cache) renders the headers only."""
    lines = [
        "# TYPE vtpu_compile_cache_hits_total counter",
        "# TYPE vtpu_compile_cache_misses_total counter",
        "# TYPE vtpu_compile_cache_single_flight_waits_total counter",
        "# TYPE vtpu_compile_cache_evictions_total counter",
        "# TYPE vtpu_compile_cache_quarantined_total counter",
        "# TYPE vtpu_compile_cache_peer_fetches_total counter",
        "# TYPE vtpu_compile_cache_peer_fetch_failures_total counter",
        "# TYPE vtpu_compile_cache_entries gauge",
        "# TYPE vtpu_compile_cache_size_bytes gauge",
    ]
    if os.path.isdir(root):
        totals, count, size = node_totals(root)
        label = f'{{node="{node_name}"}}'
        for field in STAT_FIELDS:
            lines.append(
                f"vtpu_compile_cache_{field}_total{label} {totals[field]}")
        lines.append(f"vtpu_compile_cache_entries{label} {count}")
        lines.append(f"vtpu_compile_cache_size_bytes{label} {size}")
    return "\n".join(lines) + "\n"
