"""The quota market's node-side names the port needs.

The port's copy of `vtpu_manager/quota/__init__.py:46-58` and
`quota/market.py:52-56, 118-120`: the webhook-normalized workload class
a pod declares, its config ABI value, and the effective compute percent
under a lease. The market manager itself (`quota/market.py`) is a
plane and is not ported; the interposer adopts what it writes
(`csrc/shim/enforce_quota.cc`).
"""

from __future__ import annotations

from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.util import consts

# class annotation value -> config ABI value
CLASS_TO_ABI = {
    consts.WORKLOAD_CLASS_LATENCY_CRITICAL: vc.WORKLOAD_CLASS_LATENCY,
    consts.WORKLOAD_CLASS_THROUGHPUT: vc.WORKLOAD_CLASS_THROUGHPUT,
}


def workload_class_of(pod: dict) -> str:
    """The pod's normalized workload class ("" = unclassified), from the
    webhook-stamped annotation only; an unnormalized value is ignored."""
    anns = (pod.get("metadata") or {}).get("annotations") or {}
    raw = anns.get(consts.workload_class_annotation(), "")
    return raw if raw in consts.WORKLOAD_CLASSES else ""


def workload_class_abi(cls: str) -> int:
    """Annotation value -> config ABI value (0 for unclassified)."""
    return CLASS_TO_ABI.get(cls, vc.WORKLOAD_CLASS_NONE)


def effective_core(hard: int, lease: int) -> int:
    """The compute percent under a lease, clamped to a card's share
    (the interposer's `EffectiveCorePct`)."""
    return max(0, min(100, hard + lease))
