"""The node's host pool for HBMOvercommit, its budget and its reaper.

The port of the JAX package's `overcommit/spill.py`. One node-shared pool
directory holds each spiller's buffers as files, the memory ledger's
per-entry `spilled` field accounts every byte, and the node's spill budget
bounds their sum. Protocol, ordered so that a torn spill cannot corrupt the
accounting:

1. the budget is checked under the pool's lock against the ledger's sum
   (every tenant's) plus the incoming bytes (`spill.budget` fires first);
2. the payload lands in `<name>.tmp.<pid>` and is fsynced
   (`spill.copy` fires between the two: a partial-write leaves only the
   tmp file), then renamed to the pool file, the commit point;
3. only after the rename does the ledger's `spilled` move.

A fill reverses the order: the ledger first, then the file is read and
removed. Pool file names (`<token>-<pid>-<device>-<buf>.spill`) say whose
bytes they hold, so the reaper deletes a dead owner's files and the
ledger's own dead-and-stale rule clears its row: the two converge without
a sidecar index.

The interposer's overflow tier (`csrc/shim/enforce_mem.cc`) keeps no
files: an allocation past the card's physical memory is served from host
memory the driver manages, and the interposer accounts it in the same
ledger field under the same budget, so both sides bound one node-wide sum.
"""

from __future__ import annotations

import logging
import os
import time

from vtpu_manager_torch.config import vmem as vmem_mod
from vtpu_manager_torch.resilience import failpoints
from vtpu_manager_torch.util import consts
from vtpu_manager_torch.util.flock import FileLock

log = logging.getLogger(__name__)

SPILL_SUFFIX = ".spill"


class SpillBudgetError(RuntimeError):
    """The node's spill budget cannot absorb this demotion."""


# Whether an observed (dims, element size) is a safe spill recipe: the
# JAX package's mirror of its interposer's SpillLogicalBytes /
# SpillShapeCaptureOk, kept so both packages classify a buffer alike.
_SPILL_BYTES_CAP = 9_000_000_000_000_000_000


def spill_logical_bytes(dims, elem_bytes: int) -> int:
    """The bytes a (dims, element size) implies; 0 when it is no recipe (a
    dimension or element size not positive, or past int64)."""
    if elem_bytes <= 0:
        return 0
    elems = 1
    for d in dims or ():
        d = int(d)
        if d <= 0:
            return 0
        if elems > _SPILL_BYTES_CAP // d:
            return 0
        elems *= d
    if elems > _SPILL_BYTES_CAP // elem_bytes:
        return 0
    return elems * elem_bytes


def spill_shape_capture_ok(logical_bytes: int, on_device_bytes: int) -> bool:
    """A captured shape marks a buffer spillable only when its logical size
    is its size on the device: a padded layout copied flat would refill
    wrong."""
    return logical_bytes > 0 and logical_bytes == on_device_bytes


def _pool_name(token: int, pid: int, host_index: int, buf_id: str) -> str:
    return f"{token:016x}-{pid}-{host_index}-{buf_id}{SPILL_SUFFIX}"


def _parse_pool_name(name: str) -> tuple[int, int, int, str] | None:
    if not name.endswith(SPILL_SUFFIX):
        return None
    parts = name[: -len(SPILL_SUFFIX)].split("-", 3)
    if len(parts) != 4:
        return None
    try:
        return (int(parts[0], 16), int(parts[1]), int(parts[2]), parts[3])
    except ValueError:
        return None


class SpillPool:
    """One process's handle on the node-shared pool."""

    def __init__(self, pool_dir: str = consts.SPILL_DIR,
                 budget_bytes: int = 0,
                 ledger: vmem_mod.VmemLedger | None = None,
                 owner_token: int | None = None, pid: int | None = None):
        self.pool_dir = pool_dir
        self.budget_bytes = budget_bytes
        self.ledger = ledger
        self.owner_token = owner_token if owner_token is not None \
            else vmem_mod.owner_token_from_env()
        self.pid = pid if pid is not None else os.getpid()
        os.makedirs(pool_dir, exist_ok=True)
        # two spillers must not both pass the budget's last slice
        self._lock = FileLock(os.path.join(pool_dir, ".budget.lock"))
        self._spilled: dict[int, int] = {}   # this process's, per device
        self.spill_events = 0
        self.fill_events = 0

    def spill(self, host_index: int, buf_id: str, payload: bytes) -> int:
        """Demotes one buffer to the pool; returns the bytes moved. Raises
        SpillBudgetError when the node's budget cannot absorb it."""
        nbytes = len(payload)
        path = os.path.join(self.pool_dir, _pool_name(
            self.owner_token, self.pid, host_index, buf_id))
        with self._lock:
            failpoints.fire("spill.budget", buf=buf_id,
                            host_index=host_index)
            spilled_now = (self.ledger.node_spilled_total()
                           if self.ledger is not None
                           else sum(self._spilled.values()))
            if self.budget_bytes and \
                    spilled_now + nbytes > self.budget_bytes:
                raise SpillBudgetError(
                    f"spill budget exhausted: {spilled_now}B live + "
                    f"{nbytes}B > {self.budget_bytes}B")
            tmp = f"{path}.tmp.{self.pid}"
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                # a partial-write tears the tmp file, never the pool file,
                # and the ledger below is not reached
                failpoints.fire("spill.copy", buf=buf_id, path=tmp,
                                host_index=host_index)
                os.fsync(f.fileno())
            os.rename(tmp, path)
            self._spilled[host_index] = \
                self._spilled.get(host_index, 0) + nbytes
            self.spill_events += 1
            if self.ledger is not None:
                self.ledger.record_spilled(self.pid, host_index,
                                           self._spilled[host_index],
                                           owner_token=self.owner_token)
        return nbytes

    def fill(self, host_index: int, buf_id: str) -> bytes | None:
        """Promotes one buffer out of the pool; None when it holds no such
        buffer (filled already, or reaped)."""
        path = os.path.join(self.pool_dir, _pool_name(
            self.owner_token, self.pid, host_index, buf_id))
        with self._lock:
            try:
                with open(path, "rb") as f:
                    payload = f.read()
            except OSError:
                return None
            self._spilled[host_index] = max(
                0, self._spilled.get(host_index, 0) - len(payload))
            self.fill_events += 1
            if self.ledger is not None:
                self.ledger.record_spilled(self.pid, host_index,
                                           self._spilled[host_index],
                                           owner_token=self.owner_token)
            try:
                os.unlink(path)
            except OSError:
                # an orphan the reaper removes; the accounting is settled
                log.warning("spill pool file %s not removed", path)
        return payload

    def spilled_bytes(self, host_index: int | None = None) -> int:
        if host_index is None:
            return sum(self._spilled.values())
        return self._spilled.get(host_index, 0)

    @staticmethod
    def choose_victims(candidates: list[tuple[str, int, int]],
                       need_bytes: int) -> list[str]:
        """The coldest (buf_id, bytes, last_touch_ns) first until they
        cover `need_bytes`; [] when all of them cannot (a partial eviction
        would thrash without admitting anything)."""
        if need_bytes <= 0:
            return []
        if sum(b for _, b, _ in candidates) < need_bytes:
            return []
        victims: list[str] = []
        covered = 0
        for buf_id, nbytes, _touch in sorted(candidates,
                                             key=lambda c: (c[2], c[0])):
            victims.append(buf_id)
            covered += nbytes
            if covered >= need_bytes:
                break
        return victims


def reap_pool(pool_dir: str = consts.SPILL_DIR,
              stale_s: float | None = None) -> int:
    """Deletes the files of owners that are dead and stale, and torn tmp
    files past the staleness window; returns how many went."""
    if stale_s is None:
        stale_s = vmem_mod.stale_reap_ns() / 1e9
    removed = 0
    try:
        names = os.listdir(pool_dir)
    except OSError:
        return 0
    now = time.time()
    for name in names:
        path = os.path.join(pool_dir, name)
        if ".tmp." in name:
            try:
                if now - os.path.getmtime(path) > stale_s:
                    os.unlink(path)
                    removed += 1
            except OSError:
                continue
            continue
        parsed = _parse_pool_name(name)
        if parsed is None:
            continue
        try:
            dead = not vmem_mod.pid_alive(parsed[1])
            stale = now - os.path.getmtime(path) > stale_s
        except OSError:
            continue
        if dead and stale:
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                log.warning("could not reap spill file %s", path)
    return removed


def pool_totals(pool_dir: str = consts.SPILL_DIR) -> tuple[int, int]:
    """(files, bytes) in the pool."""
    files = total = 0
    try:
        names = os.listdir(pool_dir)
    except OSError:
        return 0, 0
    for name in names:
        if _parse_pool_name(name) is None:
            continue
        try:
            total += os.path.getsize(os.path.join(pool_dir, name))
            files += 1
        except OSError:
            continue
    return files, total


def assert_node_invariants(ledger: vmem_mod.VmemLedger,
                           chip_capacity: dict[int, int],
                           budget_bytes: int) -> None:
    """Resident bytes per device within its physical memory, and the node's
    spilled bytes within the budget; AssertionError with the sums when
    not."""
    for host_index, capacity in chip_capacity.items():
        resident = ledger.device_total(host_index)
        assert resident <= capacity, (
            f"chip {host_index}: resident {resident}B > physical "
            f"{capacity}B — the spill tier failed to keep residency "
            f"under the physical cap")
    if budget_bytes:
        spilled = ledger.node_spilled_total()
        assert spilled <= budget_bytes, (
            f"node spill pool {spilled}B > budget {budget_bytes}B")
