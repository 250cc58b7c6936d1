"""Kubelet's view of which container holds devices: the exporter's check of
its own config directories.

The port of the JAX package's `client/pod_resources.py`. One List call on
kubelet's pod-resources socket (`/v1alpha1.PodResources/List`), a
connection per call, gives the live container names; kubelet's
device-manager checkpoint gives the (pod_uid, container) pairs. `grpc` is
imported only inside `list_pod_resources`, and the reply is decoded by
the port's own codec (`deviceplugin/api/podresources_messages.py`): a node
without grpc, or without the socket, falls back to the checkpoint, and
with neither the check is off rather than the scrape failing.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

from vtpu_manager_torch.deviceplugin import checkpoint as ckpt
from vtpu_manager_torch.deviceplugin.api import podresources_messages as pr
from vtpu_manager_torch.util import consts

log = logging.getLogger(__name__)

POD_RESOURCES_SOCKET = "/var/lib/kubelet/pod-resources/kubelet.sock"
_MAX_MSG = 16 * 1024 * 1024          # kubelet's defaultPodResourcesMaxSize
_CALL_TIMEOUT_S = 2.0


@dataclass(frozen=True)
class ContainerEntry:
    pod_name: str
    namespace: str
    container: str
    resource: str
    device_ids: tuple[str, ...]


@dataclass(frozen=True)
class KubeletView:
    """What kubelet says about the node's device holders, in whichever key
    spaces answered: `containers`, the container names live on the socket
    (v1alpha1 names pods, not uids); `pairs`, the (pod_uid, container)
    pairs of the checkpoint, the key the config directories use but
    possibly stale. `source` is "podresources+checkpoint", "podresources",
    "checkpoint" or "". With both up a judgment needs both: a name alone
    would vouch for a spoofed `bogus-uid_main` whenever any pod runs a
    container called `main`."""
    source: str
    containers: frozenset[str] | None = None
    pairs: frozenset[tuple[str, str]] | None = None

    def corroborates(self, pod_uid: str, container: str) -> bool | None:
        """True or False when the view can judge; None when no source
        answered (skip, do not alarm)."""
        if self.pairs is not None and self.containers is not None:
            return ((pod_uid, container) in self.pairs
                    and container in self.containers)
        if self.pairs is not None:
            return (pod_uid, container) in self.pairs
        if self.containers is not None:
            return container in self.containers
        return None


def list_pod_resources(socket_path: str = POD_RESOURCES_SOCKET,
                       timeout_s: float = _CALL_TIMEOUT_S
                       ) -> list[ContainerEntry] | None:
    """One List call; None when the socket or grpc is missing or the call
    fails."""
    if not os.path.exists(socket_path):
        return None
    try:
        import grpc
    except ImportError:
        return None
    try:
        with grpc.insecure_channel(
                f"unix://{socket_path}",
                options=[("grpc.max_receive_message_length", _MAX_MSG)],
        ) as channel:
            call = channel.unary_unary(
                pr.LIST_METHOD,
                request_serializer=lambda m: m.encode(),
                response_deserializer=pr.ListPodResourcesResponse.decode)
            resp = call(pr.ListPodResourcesRequest(), timeout=timeout_s)
    except Exception as e:  # noqa: BLE001 - any failure: fall back
        log.warning("pod-resources List failed on %s: %s", socket_path, e)
        return None
    return [ContainerEntry(pod.name, pod.namespace, container.name,
                           dev.resource_name, tuple(dev.device_ids))
            for pod in resp.pod_resources
            for container in pod.containers
            for dev in container.devices]


def kubelet_view(socket_path: str = POD_RESOURCES_SOCKET,
                 checkpoint_path: str = ckpt.KUBELET_CHECKPOINT
                 ) -> KubeletView:
    """Every source that answers, combined (see KubeletView)."""
    domain = consts.resource_domain()
    entries = list_pod_resources(socket_path)
    containers = (frozenset(e.container for e in entries
                            if e.resource.startswith(domain))
                  if entries is not None else None)
    cps = ckpt.read_checkpoint(checkpoint_path)
    pairs = (frozenset((c.pod_uid, c.container) for c in cps
                       if c.resource.startswith(domain))
             if cps else None)
    source = "+".join(
        name for name, got in (("podresources", containers is not None),
                               ("checkpoint", pairs is not None)) if got)
    return KubeletView(source=source, containers=containers, pairs=pairs)
