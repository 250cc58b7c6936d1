"""A compile-cache miss satisfied from a warm peer.

The port of the JAX package's `clustercache/fetch.py:47-234`. Both ends of
the wire are here:

- serving: `read_entry_for_serving` backs the node exporter's
  `/cache/entry?key=` route. It reads the raw entry (the 24-byte header
  included, so the fetcher verifies end to end), and an entry that fails
  verification is quarantined, as a local reader would, and never served;
- fetching: `ClusterCompileCache` overrides the store's `_fetch_remote`,
  which the miss path calls under the key's lease (one fetcher per node
  and key; the other tenants wait on the lease and read what lands). It
  takes the peers that advertise exactly this key from `peers.json`,
  downloads within a per-attempt timeout and a total budget, stages the
  bytes in tmp/ (where the `cache.fetch` failpoint tears them), reads
  them back and verifies them before the store's `put`. Every failure
  (a dead peer, an HTTP error, a torn payload, the budget spent) costs
  one rung and, at the end, a local compile. A breaker per peer keeps a
  dead one from costing every later miss a connect timeout.

With no peers file a miss costs one failed open(). `get_or_compile` with
a fingerprint writes the `fps/` marker the advertiser publishes.
"""

from __future__ import annotations

import logging
import os
import secrets
import time
import urllib.error
import urllib.request

from vtpu_manager_torch.clustercache import advertise
from vtpu_manager_torch.compilecache.cache import CompileCache
from vtpu_manager_torch.resilience import failpoints
from vtpu_manager_torch.resilience.policy import CircuitBreaker
from vtpu_manager_torch.util import consts

log = logging.getLogger(__name__)

# the ladder ends well inside the lease's stale budget (300 s), so no
# waiter judges a live fetcher dead
FETCH_TIMEOUT_S = 10.0
FETCH_TOTAL_BUDGET_S = 30.0
MAX_PEERS_TRIED = 3
# no entry of ours is larger: a confused peer cannot balloon the tenant
MAX_FETCH_BYTES = 1 << 30


class FetchError(Exception):
    """One peer attempt failed (transport, HTTP status, oversize)."""


def fetch_entry(endpoint: str, key: str,
                timeout_s: float = FETCH_TIMEOUT_S,
                token: str | None = None) -> bytes:
    """The raw entry (header and payload) from a peer's exporter."""
    req = urllib.request.Request(f"http://{endpoint}/cache/entry?key={key}")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            raw = resp.read(MAX_FETCH_BYTES + 1)
    except (urllib.error.URLError, OSError, ValueError) as e:
        raise FetchError(f"peer {endpoint} fetch failed: {e}") from e
    if len(raw) > MAX_FETCH_BYTES:
        raise FetchError(f"peer {endpoint} entry exceeds "
                         f"{MAX_FETCH_BYTES} bytes")
    return raw


def read_entry_for_serving(root: str, key: str) -> bytes | None:
    """The verified raw entry, or None (a bad key, absent, or corrupt:
    a corrupt entry is quarantined)."""
    if not advertise.valid_entry_key(key):
        return None
    path = os.path.join(root, "entries", key)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    if CompileCache._verify(raw) is None:
        dst = os.path.join(root, "quarantine", f"{key}.{time.time_ns()}")
        try:
            os.rename(path, dst)
            log.error("compile cache entry %s failed verification at "
                      "serve time; quarantined to %s", key, dst)
        except OSError:
            pass
        return None
    return raw


class ClusterCompileCache(CompileCache):
    """The node store, whose miss first tries the peers advertising the
    key, and whose tenants leave `fps/` markers for the advertiser."""

    def __init__(self, root: str, token: str | None = None,
                 fetch_timeout_s: float = FETCH_TIMEOUT_S,
                 total_budget_s: float = FETCH_TOTAL_BUDGET_S, **kwargs):
        super().__init__(root, **kwargs)
        self.token = token if token is not None else \
            os.environ.get(consts.ENV_CACHE_PEER_TOKEN) or None
        self.fetch_timeout_s = fetch_timeout_s
        self.total_budget_s = total_budget_s
        self._breakers: dict[str, CircuitBreaker] = {}

    def get_or_compile(self, key: str, compile_fn,
                       timeout_s: float = 600.0, ctx=None,
                       fingerprint: str = "") -> tuple[bytes, str]:
        payload, outcome = super().get_or_compile(
            key, compile_fn, timeout_s=timeout_s, ctx=ctx)
        # a timeout stored nothing, so it advertises nothing
        if fingerprint and outcome != "timeout":
            advertise.record_fingerprint(self.root, fingerprint, key)
        return payload, outcome

    def _peer_endpoints(self, key: str) -> list[tuple[str, str]]:
        """(node, endpoint) of each peer advertising exactly `key`."""
        out = []
        for peer in advertise.read_peers(self.root):
            if not isinstance(peer, dict):
                continue
            keys = peer.get("keys")
            endpoint = peer.get("endpoint", "")
            if endpoint and isinstance(keys, dict) and key in keys:
                out.append((peer.get("node", ""), endpoint))
        return out

    def _breaker(self, endpoint: str) -> CircuitBreaker:
        breaker = self._breakers.get(endpoint)
        if breaker is None:
            breaker = self._breakers[endpoint] = CircuitBreaker(
                name=f"cache.fetch[{endpoint}]", failure_threshold=3,
                reset_timeout_s=30.0)
        return breaker

    def _fetch_remote(self, key: str) -> bytes | None:
        """The verified payload from the first peer that serves it, or
        None to compile. A CrashFailpoint (a BaseException) passes through
        and leaves the lease and the staged file as a killed fetcher
        would."""
        peers = self._peer_endpoints(key)
        if not peers:
            return None
        deadline = time.monotonic() + self.total_budget_s
        tried = 0
        for node, endpoint in peers:
            if tried >= MAX_PEERS_TRIED or time.monotonic() >= deadline:
                break
            breaker = self._breaker(endpoint)
            if not breaker.allow():
                continue
            tried += 1
            attempt_s = min(self.fetch_timeout_s,
                            max(0.1, deadline - time.monotonic()))
            tmp = os.path.join(
                self.tmp_dir,
                f"{key}.fetch.{os.getpid()}.{secrets.token_hex(4)}")
            try:
                raw = fetch_entry(endpoint, key, timeout_s=attempt_s,
                                  token=self.token)
                # what is verified is what was staged, and what put() lands
                with open(tmp, "wb") as f:
                    f.write(raw)
                failpoints.fire("cache.fetch", key=key, path=tmp, peer=node)
                with open(tmp, "rb") as f:
                    staged = f.read()
                payload = self._verify(staged)
                if payload is None:
                    raise FetchError(f"peer {endpoint} served a torn or "
                                     f"corrupt entry ({len(staged)} bytes)")
            except Exception as e:
                # any failure of one rung: a transport error, an injected
                # one, a torn payload
                breaker.record_failure()
                self.stats.peer_fetch_failures += 1
                self._flush_stats()
                log.warning("peer fetch of %s from %s failed: %s",
                            key[:16], endpoint, e)
                _unlink_quiet(tmp)
                continue
            _unlink_quiet(tmp)
            breaker.record_success()
            self.stats.peer_fetches += 1
            self._flush_stats()
            log.info("compile cache entry %s seeded from peer %s (%s)",
                     key[:16], node, endpoint)
            return payload
        return None


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass
