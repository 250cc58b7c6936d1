"""Per-class safe memory ratios, and the publisher of the node's rollup.

The port of the JAX package's `overcommit/policy.py`. Per tenant the ring's
memory high-water is the working-set envelope; per workload class the p95
of high-water / cap across its tenants, times a safety factor, is the part
of the cap the class touches, and its inverse the raw ratio (at most
MAX_RATIO). The class's least confident tenant scales the claim:
ratio = 1 + (raw - 1) x confidence, so a class going stale decays to 1.0
and a class with fewer than MIN_CLASS_TENANTS sampled tenants is 1.0.

The publisher runs in the device plugin: each tick it folds the rings
(`overcommit/ledger.py`), computes the rollup, adds the node's spill signal
and patches the node annotation (`consts.node_overcommit_annotation`),
after reaping the host pool's files of dead spillers when it has a pool.
"""

from __future__ import annotations

import logging
import threading
import time

from vtpu_manager_torch.overcommit.ratio import MAX_RATIO, NodeOvercommit
from vtpu_manager_torch.util import consts

log = logging.getLogger(__name__)

# the working-set percentile across a class's tenants
HIGHWATER_PERCENTILE = 0.95
# slack on the measured envelope; latency-critical working sets get more
SAFETY_FACTOR = {"lat": 1.5, "thr": 1.2, "def": 1.35}
# the envelope's floor: no working set advertises more than MAX_RATIO
MIN_ENVELOPE_FRACTION = 1.0 / MAX_RATIO
# one tenant's high-water says nothing about the mix a ratio admits
MIN_CLASS_TENANTS = 2


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile of a sorted list."""
    if not sorted_vals:
        return 1.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class OvercommitPolicy:
    """Folds one node's evidence (an `OvercommitLedger`) into a rollup."""

    def __init__(self, ledger, max_ratio: float = MAX_RATIO):
        self.ledger = ledger
        self.max_ratio = max_ratio

    def compute(self, now_wall: float | None = None) -> NodeOvercommit:
        now_wall = time.time() if now_wall is None else now_wall
        samples = self.ledger.hbm_fraction_samples(now_wall)
        ratios = {key: self._class_ratio(key, samples.get(key, []))
                  for key in ("lat", "thr", "def")}
        spill_frac, spilled_bytes = self.ledger.node_spill_signal(now_wall)
        return NodeOvercommit(ratios=ratios, spill_frac=spill_frac,
                              spilled_bytes=spilled_bytes, ts=now_wall)

    def _class_ratio(self, key: str,
                     samples: list[tuple[float, float]]) -> float:
        live = [(f, c) for f, c in samples if c > 0.0]
        if len(live) < MIN_CLASS_TENANTS:
            return 1.0
        fracs = sorted(min(max(f, 0.0), 1.0) for f, _ in live)
        envelope = _percentile(fracs, HIGHWATER_PERCENTILE) \
            * SAFETY_FACTOR[key]
        envelope = max(envelope, MIN_ENVELOPE_FRACTION)
        raw = min(1.0 / envelope, self.max_ratio)
        conf = min(c for _, c in live)
        return round(1.0 + (raw - 1.0) * conf, 2)


class OvercommitPublisher:
    """Computes the policy and patches the node annotation every
    `interval_s` on a thread of its own. A failed tick is logged and the
    next one tries again: the annotation's stamp decays a silent publisher
    to ratio 1.0. With `pool_dir`, each tick first reaps the files of
    spillers that died (`spill.reap_pool`)."""

    def __init__(self, client, node_name: str, policy: OvercommitPolicy,
                 retry_policy=None, interval_s: float = 15.0,
                 pool_dir: str | None = None):
        from vtpu_manager_torch.resilience.policy import RetryPolicy
        self.client = client
        self.node_name = node_name
        self.policy = policy
        self.retry_policy = retry_policy or RetryPolicy(max_attempts=3,
                                                        deadline_s=10.0)
        self.interval_s = interval_s
        self.pool_dir = pool_dir
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def publish_once(self) -> NodeOvercommit:
        if self.pool_dir is not None:
            from vtpu_manager_torch.overcommit import spill
            spill.reap_pool(self.pool_dir)
        self.policy.ledger.fold()
        oc = self.policy.compute()
        self.retry_policy.run(
            lambda: self.client.patch_node_annotations(
                self.node_name,
                {consts.node_overcommit_annotation(): oc.encode()}),
            op="overcommit.policy_patch")
        return oc

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.publish_once()
                except Exception:  # noqa: BLE001 - advisory; next tick
                    log.warning("overcommit policy publish failed",
                                exc_info=True)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="vtpu-overcommit")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
