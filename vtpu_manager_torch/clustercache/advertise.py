"""Which compile-cache entries a node can seed its peers with.

The port of the JAX package's `clustercache/advertise.py:92-375`, cut to
what a peer fetch needs: the annotation's codec, the `fps/` markers, the
device plugin's advertiser and the fetcher's read of `peers.json`. The
scheduler's `warm_term` is not carried (the port has no scheduler).

The node annotation (`consts.node_cache_keys_annotation()`) reads

    <endpoint>|<fp>=<entry_key>,<fp>=<entry_key>,...@<wall_ts>

`endpoint` is the `host:port` of the node's exporter, whose `/cache/entry`
route serves an entry (empty: no peer can fetch); the pairs come hottest
first (the marker's mtime, its last use), at most `--cache-ad-max-pairs`
(8 by default, 32 at most); `fp` is the sanitized program fingerprint and
`key` the 64-hex entry key a fetcher must match exactly. A stale,
unparseable or over-long annotation reads as None; a malformed pair is
skipped. The bytes are the JAX codec's, so either package reads the
other's advertisement.

`fps/<fp>` holds the entry key a tenant last used for that fingerprint
(mtime: when), written by the cluster client at `get_or_compile`; the
advertiser scans markers, not payloads. Each tick the advertiser patches
this node's annotation and writes every other node's fresh advertisement
into `<root>/peers.json` (`{"ts": ..., "peers": [{"node", "endpoint",
"keys": {key: fp}}]}`), which tenants read without a kube client.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import threading
import time
from dataclasses import dataclass

from vtpu_manager_torch.compilecache.keys import sanitize_fingerprint
from vtpu_manager_torch.resilience import failpoints
from vtpu_manager_torch.resilience.policy import RetryPolicy
from vtpu_manager_torch.util import consts, stalecodec

log = logging.getLogger(__name__)

MAX_AD_AGE_S = 120.0
MAX_AD_KEYS = 8           # pairs advertised by default
MAX_AD_KEYS_LIMIT = 32    # the most a flag may ask for, and a parse reads
# one advertisement's share of the node object's annotations, and the
# parse's bound on what it splits
MAX_AD_LEN = 8192
# how old peers.json may be before a fetcher treats the fleet as unknown
PEERS_STALE_S = 300.0
FPS_SUBDIR = "fps"

_KEY_RE = re.compile(r"^[0-9a-f]{64}$")


def valid_entry_key(key: str) -> bool:
    """A well-formed entry key (64 lowercase hex). It becomes a file name
    under entries/, so anything else is refused."""
    return bool(_KEY_RE.match(key or ""))


@dataclass(frozen=True)
class NodeWarmKeys:
    endpoint: str           # "host:port", or "" (no fetch)
    pairs: tuple            # ((fp, key), ...) hottest first
    ts: float

    def encode(self) -> str:
        body = ",".join(f"{fp}={key}" for fp, key in self.pairs)
        return stalecodec.stamp(f"{self.endpoint}|{body}", self.ts)


def parse_warm_keys(raw: str | None, now: float | None = None,
                    max_age_s: float = MAX_AD_AGE_S
                    ) -> NodeWarmKeys | None:
    """The advertisement, or None when absent, malformed or stale."""
    split = stalecodec.split_stamp(raw, max_len=MAX_AD_LEN)
    if split is None:
        return None
    body, ts = split
    if not stalecodec.is_fresh(ts, now, max_age_s):
        return None
    endpoint, sep, pairs_raw = body.partition("|")
    if not sep:
        return None
    pairs = []
    for seg in pairs_raw.split(","):
        if not seg:
            continue
        fp, _, key = seg.partition("=")
        if not fp or fp != sanitize_fingerprint(fp) \
                or not valid_entry_key(key):
            continue
        pairs.append((fp, key))
        if len(pairs) >= MAX_AD_KEYS_LIMIT:
            break
    return NodeWarmKeys(endpoint=endpoint, pairs=tuple(pairs), ts=ts)


def record_fingerprint(root: str, fingerprint: str, key: str) -> None:
    """Writes or refreshes the `fps/<fp>` marker. A failure is logged and
    dropped: the marker is advertisement, never the tenant's compile."""
    fp = sanitize_fingerprint(fingerprint)
    if not fp or not valid_entry_key(key):
        return
    fps_dir = os.path.join(root, FPS_SUBDIR)
    path = os.path.join(fps_dir, fp)
    try:
        try:
            with open(path) as f:
                if f.read() == key:
                    os.utime(path)
                    return
        except OSError:
            pass
        os.makedirs(fps_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(key)
        os.rename(tmp, path)
    except OSError:
        log.debug("fingerprint marker write failed for %s", fp,
                  exc_info=True)


def scan_warm_pairs(root: str, max_keys: int = MAX_AD_KEYS) -> list:
    """((fp, key), ...) hottest first, only keys whose entry exists and
    holds at least a header: an evicted entry draws no fetch."""
    fps_dir = os.path.join(root, FPS_SUBDIR)
    entries_dir = os.path.join(root, "entries")
    try:
        names = os.listdir(fps_dir)
    except OSError:
        return []
    rows = []
    for name in names:
        if name.endswith(".tmp") or sanitize_fingerprint(name) != name:
            continue
        path = os.path.join(fps_dir, name)
        try:
            mtime = os.stat(path).st_mtime
            with open(path) as f:
                key = f.read().strip()
        except OSError:
            continue
        if not valid_entry_key(key):
            continue
        try:
            if os.stat(os.path.join(entries_dir, key)).st_size < 24:
                continue
        except OSError:
            continue
        rows.append((mtime, name, key))
    rows.sort(reverse=True)
    return [(fp, key) for _m, fp, key in rows[:max_keys]]


class CacheAdvertiser:
    """Publishes this node's warm keys and writes the fleet's into
    `peers.json`, every `interval_s` (the device plugin's thread)."""

    def __init__(self, client, node_name: str, cache_root: str,
                 endpoint: str = "", policy: RetryPolicy | None = None,
                 interval_s: float = 15.0, max_keys: int = MAX_AD_KEYS):
        self.client = client
        self.node_name = node_name
        self.cache_root = cache_root
        self.endpoint = endpoint
        self.policy = policy or RetryPolicy(max_attempts=3, deadline_s=10.0)
        self.interval_s = interval_s
        self.max_keys = max(1, min(max_keys, MAX_AD_KEYS_LIMIT))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def advertisement(self, now: float | None = None) -> NodeWarmKeys:
        return NodeWarmKeys(
            endpoint=self.endpoint,
            pairs=tuple(scan_warm_pairs(self.cache_root, self.max_keys)),
            ts=time.time() if now is None else now)

    def publish_once(self) -> NodeWarmKeys:
        ad = self.advertisement()
        failpoints.fire("cache.advertise", node=self.node_name)
        self.policy.run(
            lambda: self.client.patch_node_annotations(
                self.node_name,
                {consts.node_cache_keys_annotation(): ad.encode()}),
            op="clustercache.advertise_patch")
        return ad

    def refresh_peers(self, now: float | None = None) -> int:
        """One node LIST into `peers.json`; the number of peers written."""
        now = time.time() if now is None else now
        ann = consts.node_cache_keys_annotation()
        peers = []
        for node in self.client.list_nodes():
            meta = node.get("metadata") or {}
            name = meta.get("name", "")
            if not name or name == self.node_name:
                continue
            warm = parse_warm_keys(
                (meta.get("annotations") or {}).get(ann), now=now)
            if warm is None or not warm.endpoint or not warm.pairs:
                continue
            peers.append({"node": name, "endpoint": warm.endpoint,
                          "keys": {key: fp for fp, key in warm.pairs}})
        path = os.path.join(self.cache_root, consts.CACHE_PEERS_NAME)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"ts": now, "peers": peers}, f, separators=(",", ":"))
        os.rename(tmp, path)
        return len(peers)

    def tick(self) -> None:
        self.publish_once()
        self.refresh_peers()

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:
                    # a failed tick costs freshness only: the annotation
                    # and peers.json age out by their stamps
                    log.warning("cache advertisement tick failed",
                                exc_info=True)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="vtpu-cache-advertiser")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


def read_peers(cache_root: str, now: float | None = None) -> list[dict]:
    """The peer rows of `peers.json`; [] when it is absent, torn, or
    stale (the fetcher then compiles)."""
    path = os.path.join(cache_root, consts.CACHE_PEERS_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    if not isinstance(doc, dict):
        return []
    try:
        ts = float(doc.get("ts", 0.0))
    except (TypeError, ValueError):
        return []
    now = time.time() if now is None else now
    if not math.isfinite(ts) or not (
            -stalecodec.FUTURE_SKEW_TOLERANCE_S <= now - ts
            <= PEERS_STALE_S):
        return []
    peers = doc.get("peers")
    return peers if isinstance(peers, list) else []
