"""The compile cache's node counters, as the node exporter reads them.

The port of the part of the JAX package's `compilecache/cache.py` that the
exporter appends to every scrape: `STAT_FIELDS`, `node_totals` and
`render_node_metrics`. Under the cache root, `stats/<id>.json` holds each
client's counters and `stats/aggregate.json` those of clients that exited
(folded under `stats/aggregate.json.lock`), and `entries/` the cached
executables. No cache root (no tenant uses the cache) renders the
families' headers only. The cache itself is not ported yet.
"""

from __future__ import annotations

import json
import os

from vtpu_manager_torch.util.flock import FileLock, LockTimeout

STAT_FIELDS = ("hits", "misses", "single_flight_waits", "evictions",
               "quarantined", "peer_fetches", "peer_fetch_failures")


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
