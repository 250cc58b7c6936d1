"""The node's quota-lease ledger: who lent what to whom on which card.

The port of the JAX package's `quota/ledger.py`, whole. One JSON file
under the node's base dir, every mutation under a `FileLock` on a sibling
`.flock` (the market, a restarted market and any reader exclude each
other), landed by tmp + fsync + rename. The file carries one `epoch`,
bumped on every mutation; the market writes it into each affected
tenant's `vtpu.config` as `quota_epoch`, which the interposer's re-read
keys on (`csrc/shim/enforce_quota.cc`).

What a crash leaves:
- every lease has a wall-clock TTL; a granted lease past
  `granted_at + ttl_s` is due, and the next market pass expires it, so a
  market that dies holding grants leaves only TTL-bounded ones;
- a torn or foreign file loads as empty, marked `recovered`, with an
  epoch re-based on wall seconds (the interposer skips a re-read whose
  epoch equals the one it adopted, so a generation after the tear must
  not reuse an epoch from before it); the market's reconcile then
  rewrites every config to its base rate;
- a market that starts revokes every granted lease it finds, so it
  always starts from base truth (`market.QuotaMarketManager.recover`).
"""

from __future__ import annotations

import json
import logging
import os
import time

from vtpu_manager_torch.util.flock import FileLock

log = logging.getLogger(__name__)

LEDGER_NAME = "quota_leases.json"

STATE_GRANTED = "granted"
STATE_REVOKED = "revoked"
STATE_EXPIRED = "expired"


def lease_is_active(lease: dict, now: float) -> bool:
    """Granted and inside its TTL: the one predicate of the settle paths
    and the due scan."""
    if lease.get("state") != STATE_GRANTED:
        return False
    return now < float(lease.get("granted_at", 0.0)) + \
        float(lease.get("ttl_s", 0.0))


class QuotaLeaseLedger:
    """The FileLock'd, atomically rewritten lease file of one node."""

    def __init__(self, base_dir: str, clock=time.time):
        self.path = os.path.join(base_dir, LEDGER_NAME)
        self.clock = clock

    def exists(self) -> bool:
        return os.path.exists(self.path)

    # -- the document -----------------------------------------------------

    def load(self) -> dict:
        """The document; a missing file reads as empty, a torn or foreign
        one as empty with `recovered` set and a recovery epoch (a caller
        that sees `recovered` takes every config's lease as unknown and
        reconciles to base)."""
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return {"epoch": 0, "leases": []}
        except (OSError, json.JSONDecodeError, ValueError):
            log.warning("quota ledger %s unreadable (torn write?); "
                        "recovering as empty", self.path)
            return {"epoch": self._recovery_epoch(), "leases": [],
                    "recovered": True}
        if not isinstance(doc, dict) or \
                not isinstance(doc.get("leases"), list):
            log.warning("quota ledger %s has a foreign shape; "
                        "recovering as empty", self.path)
            return {"epoch": self._recovery_epoch(), "leases": [],
                    "recovered": True}
        doc.setdefault("epoch", 0)
        return doc

    def _recovery_epoch(self) -> int:
        return int(self.clock()) & 0x7FFFFFFF

    def _store(self, doc: dict) -> None:
        doc.pop("recovered", None)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- mutations: each one locked round trip, the epoch bumped ----------

    def grant(self, chip: int, lender: str, borrower: str, pct: int,
              ttl_s: float, now: float | None = None) -> tuple[dict, int]:
        """Appends one granted lease; returns it and the new epoch."""
        now = self.clock() if now is None else now
        with FileLock(f"{self.path}.flock"):
            doc = self.load()
            doc["epoch"] = int(doc["epoch"]) + 1
            lease = {
                "id": f"q{doc['epoch']}-{chip}-{len(doc['leases'])}",
                "chip": int(chip),
                "lender": lender,
                "borrower": borrower,
                "pct": int(pct),
                "granted_at": now,
                "ttl_s": float(ttl_s),
                "state": STATE_GRANTED,
                "updated_at": now,
                "epoch": doc["epoch"],
            }
            doc["leases"].append(lease)
            self._store(doc)
            return lease, doc["epoch"]

    def settle(self, lease_ids, state: str,
               now: float | None = None) -> int:
        """Marks granted leases revoked or expired; returns the epoch,
        bumped once for the batch (one epoch per mutation is what the
        interposer's re-read keys on)."""
        assert state in (STATE_REVOKED, STATE_EXPIRED), state
        ids = set(lease_ids)
        now = self.clock() if now is None else now
        with FileLock(f"{self.path}.flock"):
            doc = self.load()
            touched = False
            for lease in doc["leases"]:
                if lease.get("id") in ids and \
                        lease.get("state") == STATE_GRANTED:
                    lease["state"] = state
                    lease["updated_at"] = now
                    touched = True
            if touched or doc.get("recovered"):
                doc["epoch"] = int(doc["epoch"]) + 1
            self._store(doc)
            return doc["epoch"]

    def compact(self, retain_s: float = 3600.0,
                now: float | None = None) -> None:
        """Drops settled leases older than `retain_s`, never granted
        ones, so the file stays bounded."""
        now = self.clock() if now is None else now
        with FileLock(f"{self.path}.flock"):
            doc = self.load()
            kept = [l for l in doc["leases"]
                    if l.get("state") == STATE_GRANTED
                    or now - float(l.get("updated_at", 0.0)) < retain_s]
            if len(kept) != len(doc["leases"]):
                doc["leases"] = kept
                self._store(doc)

    # -- reads, unlocked: a torn read is a stale one, and every caller
    # reads again next pass ------------------------------------------------

    def epoch(self) -> int:
        return int(self.load()["epoch"])

    def leases(self) -> list[dict]:
        return list(self.load()["leases"])

    def snapshot(self, now: float | None = None) -> "LedgerView":
        """The epoch, the leases, the active ones and their deltas from
        one load: a market phase sees one generation."""
        now = self.clock() if now is None else now
        doc = self.load()
        leases = list(doc["leases"])
        active = [l for l in leases if lease_is_active(l, now)]
        return LedgerView(epoch=int(doc["epoch"]), leases=leases,
                          active=active, deltas=deltas_from(active))

    def active(self, now: float | None = None,
               chip: int | None = None) -> list[dict]:
        now = self.clock() if now is None else now
        return [l for l in self.load()["leases"]
                if lease_is_active(l, now)
                and (chip is None or l.get("chip") == chip)]

    def due(self, now: float | None = None) -> list[dict]:
        """Granted leases whose TTL ran out: the expiry work list."""
        now = self.clock() if now is None else now
        return [l for l in self.load()["leases"]
                if l.get("state") == STATE_GRANTED
                and not lease_is_active(l, now)]

    def deltas(self, now: float | None = None
               ) -> dict[tuple[str, int], int]:
        """(tenant, chip) -> the net signed `lease_core` of the active
        leases: what the config rewrite applies."""
        now = self.clock() if now is None else now
        return deltas_from([l for l in self.load()["leases"]
                            if lease_is_active(l, now)])


class LedgerView:
    """One generation of the ledger, read once (`snapshot`)."""

    __slots__ = ("epoch", "leases", "active", "deltas")

    def __init__(self, epoch: int, leases: list[dict],
                 active: list[dict],
                 deltas: dict[tuple[str, int], int]):
        self.epoch = epoch
        self.leases = leases
        self.active = active
        self.deltas = deltas


def deltas_from(active: list[dict]) -> dict[tuple[str, int], int]:
    out: dict[tuple[str, int], int] = {}
    for lease in active:
        chip = int(lease.get("chip", 0))
        pct = int(lease.get("pct", 0))
        bkey = (lease.get("borrower", ""), chip)
        lkey = (lease.get("lender", ""), chip)
        out[bkey] = out.get(bkey, 0) + pct
        out[lkey] = out.get(lkey, 0) - pct
    return out
