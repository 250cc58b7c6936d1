"""The node pressure annotation: the step rings' feedback to the scheduler.

The port of the JAX package's `telemetry/pressure.py`, without
`pressure_penalty`, which belongs to the scheduler. The node agent
publishes what its tenants experience (the largest throttle-wait fraction
over the last window and the memory left under the step high-waters) as a
node annotation, `<throttle_frac>:<hbm_headroom_bytes>@<wall_ts>`. The
JAX scheduler decodes it and scores by it as a soft penalty; the stamp
lets a publisher that stopped decay to no signal.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass

from vtpu_manager_torch.util import consts, stalecodec

log = logging.getLogger(__name__)

# a rollup older than this reads as no signal
MAX_PRESSURE_AGE_S = 120.0


@dataclass(frozen=True)
class NodePressure:
    throttle_frac: float
    hbm_headroom_bytes: int
    ts: float

    def encode(self) -> str:
        return stalecodec.stamp(
            f"{self.throttle_frac:.4f}:{self.hbm_headroom_bytes}", self.ts)


def parse_pressure(raw: str | None, now: float | None = None,
                   max_age_s: float = MAX_PRESSURE_AGE_S
                   ) -> NodePressure | None:
    """The annotation decoded; None when absent, malformed (a NaN or an
    infinity included) or stale."""
    split = stalecodec.split_stamp(raw)
    if split is None:
        return None
    body, ts = split
    frac_raw, _, headroom_raw = body.partition(":")
    try:
        frac = float(frac_raw)
        headroom = int(headroom_raw)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(frac):
        return None
    if not stalecodec.is_fresh(ts, now, max_age_s):
        return None
    return NodePressure(min(max(frac, 0.0), 1.0), max(headroom, 0), ts)


class PressurePublisher:
    """Scans the rings and patches the node annotation, every `interval_s`
    on a thread of its own. A failed tick is logged and the next one
    tries again: the annotation is advisory, and its stamp ages it out."""

    def __init__(self, client, node_name: str, aggregator,
                 node_hbm_total: int, policy=None,
                 interval_s: float = 15.0):
        from vtpu_manager_torch.resilience.policy import RetryPolicy
        self.client = client
        self.node_name = node_name
        self.aggregator = aggregator
        self.node_hbm_total = node_hbm_total
        self.policy = policy or RetryPolicy(max_attempts=3, deadline_s=10.0)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def publish_once(self) -> NodePressure:
        self.aggregator.scan()
        frac, headroom = self.aggregator.pressure(self.node_hbm_total)
        pressure = NodePressure(frac, headroom, time.time())
        self.policy.run(
            lambda: self.client.patch_node_annotations(
                self.node_name,
                {consts.node_pressure_annotation(): pressure.encode()}),
            op="telemetry.pressure_patch")
        return pressure

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.publish_once()
                except Exception:  # noqa: BLE001 - advisory; next tick
                    log.warning("node pressure publish failed",
                                exc_info=True)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="vtpu-pressure")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
