"""Claim resolution: an allocated ResourceClaim's results as partitions.

The port's own copy of the JAX package's `claimresolve/resolve.py:16-86`.
The webhook, the monitor and the kubelet plugin answer "which devices and
what share of each does this claim hold" with it, from the claim object
alone: each result of this driver, with the opaque parameters that apply
to its request.
"""

from __future__ import annotations

from dataclasses import dataclass

from vtpu_manager_torch.util import consts


@dataclass(frozen=True)
class PartitionKey:
    device: str               # DRA device name (vtpu-<index>[-<slot>])
    cores: int | None         # None: no opaque config, the consumer takes
    memory_mib: int | None    # the allocated device's own capacity
    # the spec.devices.requests[] entry this result satisfies; a
    # prioritized-list sub-request ("parent/sub") counts as its parent,
    # which is what containers name
    request: str = ""


def pod_claim_names(pod: dict) -> list[tuple[str, str]]:
    """(namespace, claim name) of every claim the pod references, directly
    or through a template (status.resourceClaimStatuses), in order and
    without repeats."""
    ns = (pod.get("metadata") or {}).get("namespace", "default")
    out = []
    for entry in ((pod.get("spec") or {}).get("resourceClaims") or []):
        name = entry.get("resourceClaimName")
        if name:
            out.append((ns, name))
    for status in ((pod.get("status") or {}).get("resourceClaimStatuses")
                   or []):
        name = status.get("resourceClaimName")
        if name:
            out.append((ns, name))
    return list(dict.fromkeys(out))


def resolve_claim_partitions(claim: dict) -> list[PartitionKey]:
    """The partitions of one allocated ResourceClaim for this driver. The
    last opaque config of this driver that names a result's request (or
    names none) gives its parameters."""
    allocation = ((claim.get("status") or {}).get("allocation") or {})
    results = ((allocation.get("devices") or {}).get("results") or [])
    configs = ((allocation.get("devices") or {}).get("config") or [])

    def params_for(result: dict) -> dict:
        request = result.get("request", "")
        chosen: dict = {}
        for entry in configs:
            opaque = entry.get("opaque") or {}
            if opaque.get("driver") != consts.DRA_DRIVER_NAME:
                continue
            requests = entry.get("requests") or []
            if not requests or request in requests:
                chosen = opaque.get("parameters") or {}
        return chosen

    out = []
    for result in results:
        if result.get("driver") != consts.DRA_DRIVER_NAME:
            continue
        params = params_for(result)
        cores = params.get("cores")
        memory = params.get("memoryMiB")
        out.append(PartitionKey(
            device=result.get("device", ""),
            cores=int(cores) if cores is not None else None,
            memory_mib=int(memory) if memory is not None else None,
            request=(result.get("request", "") or "").split("/", 1)[0]))
    return out


def pod_partitions(pod: dict, claims_by_name: dict[tuple[str, str], dict]
                   ) -> list[PartitionKey]:
    out = []
    for key in pod_claim_names(pod):
        claim = claims_by_name.get(key)
        if claim is not None:
            out.extend(resolve_claim_partitions(claim))
    return out
