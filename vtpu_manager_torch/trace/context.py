"""A trace context: a pod's trace id and its sampling decision, made once.

The port of the JAX package's `trace/context.py`. The context is minted at
admission and crosses every process boundary the allocation path crosses,
through the channels the node already has: pod annotations between the
control-plane processes, and container environment variables into the
tenant. DRA claims carry no annotation; their stages join the timeline by
the pod's uid instead (`assemble.py` joins on either key).

Sampling is decided once, at the mint, and propagated: every later stage
records or skips alike, or a timeline assembles with holes that read as
latency. The decision is a deterministic function of the trace id (an
fnv64 bucket), so a pod's fate is reproducible, a fleet-wide rate needs
no coordination, and a stage that sees only the uid reaches the mint's
verdict by computing it again.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from vtpu_manager_torch.config.vmem import fnv64
from vtpu_manager_torch.util import consts

_SAMPLE_BUCKETS = 1 << 20


@dataclass(frozen=True)
class TraceContext:
    trace_id: str
    pod_uid: str = ""
    sampled: bool = True


def _sample(trace_id: str, rate: float) -> bool:
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (fnv64(trace_id) % _SAMPLE_BUCKETS) < int(rate * _SAMPLE_BUCKETS)


def mint(pod: dict, rate: float = 1.0) -> TraceContext:
    """A new context for a pod at admission: its trace id is the pod's uid
    when the API server has assigned one, else random."""
    meta = pod.get("metadata") or {}
    uid = meta.get("uid", "")
    trace_id = uid or os.urandom(8).hex()
    return TraceContext(trace_id=trace_id, pod_uid=uid,
                        sampled=_sample(trace_id, rate))


def from_pod(pod: dict) -> TraceContext | None:
    """The context an earlier stage put on the pod's annotations; None for
    a pod admitted without tracing."""
    meta = pod.get("metadata") or {}
    anns = meta.get("annotations") or {}
    trace_id = anns.get(consts.trace_id_annotation())
    if not trace_id:
        return None
    sampled = anns.get(consts.trace_sampled_annotation(), "true") == "true"
    return TraceContext(trace_id=trace_id, pod_uid=meta.get("uid", ""),
                        sampled=sampled)


def from_env(environ: dict | None = None) -> TraceContext | None:
    """The context the device plugin put in a tenant's environment."""
    env = os.environ if environ is None else environ
    trace_id = env.get(consts.ENV_TRACE_ID, "")
    if not trace_id:
        return None
    return TraceContext(
        trace_id=trace_id,
        pod_uid=env.get(consts.ENV_POD_UID, ""),
        sampled=env.get(consts.ENV_TRACE_SAMPLED, "true") == "true")


def for_claim(claim: dict, rate: float = 1.0) -> TraceContext | None:
    """The context of a DRA claim, which carries no trace annotation: it
    joins the timeline of the first pod the claim is reserved for (else
    the claim's own uid), and samples that uid again. The mint takes the
    pod's uid as its trace id whenever the pod has one, so both reach the
    same verdict; a pod minted before it had a uid can only lose its DRA
    spans this way, never gain an orphan timeline."""
    meta = claim.get("metadata") or {}
    reserved = ((claim.get("status") or {}).get("reservedFor")) or []
    pod_uid = ""
    for ref in reserved:
        if ref.get("resource", "pods") == "pods" and ref.get("uid"):
            pod_uid = ref["uid"]
            break
    uid = meta.get("uid", "")
    if not pod_uid and not uid:
        return None
    join_uid = pod_uid or uid
    return TraceContext(trace_id="", pod_uid=join_uid,
                        sampled=_sample(join_uid, rate))


def for_uid(pod_uid: str, rate: float = 1.0) -> TraceContext | None:
    """The context of a stage that knows only the pod's uid: it joins by
    the uid, sampled again as in `for_claim`."""
    if not pod_uid:
        return None
    return TraceContext(trace_id="", pod_uid=pod_uid,
                        sampled=_sample(pod_uid, rate))
