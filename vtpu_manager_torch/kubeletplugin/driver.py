"""The DRA kubelet plugin's driver: NodePrepareResources and
NodeUnprepareResources.

The port of the JAX package's `kubeletplugin/driver.py:32-240`. Kubelet
names the claims of a pod; the driver fetches each from the API server
(`ClaimSource`), prepares it through `DeviceState` and answers, per
claim, the CDI device ids kubelet hands the container runtime, grouped by
the request each device satisfies, or the claim's error. One bad claim
fails its own entry, never the batch.

The driver speaks the plain messages of `api/messages.py`; `serve()`
converts to and from the generated `dra_pb2` messages at the socket and
is the only place that imports `grpc` and `protobuf`, so the driver runs
on a machine without them.
"""

from __future__ import annotations

import logging
import os

from vtpu_manager_torch.client.kube import KubeClient, KubeError
from vtpu_manager_torch.kubeletplugin.api import messages as api
from vtpu_manager_torch.kubeletplugin.device_state import (DeviceState,
                                                           PrepareError)
from vtpu_manager_torch.resilience.policy import (CircuitBreaker,
                                                  CircuitOpenError,
                                                  KubeResilience, RetryPolicy)

log = logging.getLogger(__name__)

DRA_PLUGIN_DIR = "/var/lib/kubelet/plugins/vtpu-dra"


class ClaimLookupError(RuntimeError):
    """A transient API failure, distinct from a claim that does not exist,
    so kubelet retries instead of reporting a misleading not-found."""


class ClaimSource:
    """Where Prepare gets claim objects: the API server, or `local` (uid ->
    claim) in tests. Fetches retry transient failures under a deadline
    that fits kubelet's Prepare budget, and a breaker rejects them locally
    during a sustained outage. A 404 is a result (None): it is neither
    retried nor counted against the breaker."""

    def __init__(self, client: KubeClient | None = None,
                 resilience: KubeResilience | None = None):
        self.client = client
        self.local: dict[str, dict] = {}
        self.resilience = resilience or KubeResilience(
            policy=RetryPolicy(max_attempts=3, deadline_s=5.0),
            breaker=CircuitBreaker(name="dra.claims"))

    def get(self, uid: str, name: str, namespace: str) -> dict | None:
        """The claim, or None when it does not exist or its uid is not
        `uid` (a claim recreated under the same name). Raises
        ClaimLookupError when the API could not answer."""
        claim = None
        if uid in self.local:
            claim = self.local[uid]
        elif self.client is not None:
            getter = getattr(self.client, "get_resourceclaim", None)
            if getter is not None:
                def fetch():
                    try:
                        return getter(namespace, name)
                    except KubeError as e:
                        if e.status == 404:
                            return None
                        raise
                try:
                    claim = self.resilience.call(fetch, op="dra.claim_get")
                except CircuitOpenError as e:
                    log.warning("claim %s/%s lookup rejected: %s",
                                namespace, name, e)
                    raise ClaimLookupError(str(e)) from e
                except Exception as e:
                    log.warning("claim %s/%s lookup failed: %s",
                                namespace, name, e)
                    raise ClaimLookupError(str(e)) from e
        if claim is None:
            return None
        found_uid = (claim.get("metadata") or {}).get("uid", "")
        if found_uid != uid:
            log.warning("claim %s/%s uid mismatch: want %s found %s",
                        namespace, name, uid, found_uid)
            return None
        return claim


class DraDriver:
    def __init__(self, node_name: str, claim_source: ClaimSource,
                 state: DeviceState, plugin_dir: str = DRA_PLUGIN_DIR):
        self.node_name = node_name
        self.state = state
        self.claims = claim_source
        self.plugin_dir = plugin_dir
        self.socket_path = os.path.join(plugin_dir, "dra.sock")
        self._server = None

    def claim_uids_for_pod(self, pod_uid: str,
                           claim_uid: str | None = None) -> list[str]:
        """The prepared claims a pod owns, by the claims' reservedFor;
        with `claim_uid`, only that claim is looked up."""
        if claim_uid is not None:
            prepared = self.state.checkpoint.claims.get(claim_uid)
            if prepared is None:
                return []
            targets = [(claim_uid, prepared)]
        else:
            # a copy: prepare and unprepare change it from other threads
            targets = list(self.state.checkpoint.claims.items())
        out = []
        for uid, prepared in targets:
            claim = self.claims.get(uid, prepared.name, prepared.namespace)
            reserved = ((claim or {}).get("status") or {}).get(
                "reservedFor") or []
            if any(ref.get("uid") == pod_uid for ref in reserved):
                out.append(uid)
        return out

    # -- the RPCs -------------------------------------------------------------

    def node_prepare(self, request: api.NodePrepareResourcesRequest
                     ) -> api.NodePrepareResourcesResponse:
        resp = api.NodePrepareResourcesResponse()
        for claim_ref in request.claims:
            entry = resp.claims.setdefault(
                claim_ref.uid, api.NodePrepareResourceResponse())
            try:
                claim = self.claims.get(claim_ref.uid, claim_ref.name,
                                        claim_ref.namespace)
            except ClaimLookupError as e:
                entry.error = f"claim lookup failed (transient): {e}"
                continue
            if claim is None:
                entry.error = (f"claim {claim_ref.namespace}/"
                               f"{claim_ref.name} not found")
                continue
            try:
                cdi_ids = self.state.prepare_claim(claim)
            except Exception as e:  # noqa: BLE001 - fails this entry only
                if not isinstance(e, PrepareError):
                    log.exception("prepare %s failed unexpectedly",
                                  claim_ref.uid)
                entry.error = str(e)
                continue
            prepared = self.state.checkpoint.claims.get(claim_ref.uid)
            pdevices = prepared.devices if prepared else []
            # one group per request; a single-request claim's devices carry
            # no request: one group with no `requests`, which kubelet
            # applies to every container of the claim
            groups: dict[str, list[dict]] = {}
            for d in pdevices:
                groups.setdefault(d.get("request", ""), []).append(d)
            if not groups:
                groups[""] = []
            for request_name in sorted(groups):
                requests = [request_name] if request_name else []
                first = None
                for d in groups[request_name]:
                    device = api.Device(requests=list(requests),
                                        pool_name=self.node_name,
                                        device_name=d["device"])
                    entry.devices.append(device)
                    if first is None:
                        first = device
                if first is None:
                    first = api.Device(requests=list(requests),
                                       pool_name=self.node_name)
                    entry.devices.append(first)
                group_cdis = list(dict.fromkeys(
                    d["cdi"] for d in groups[request_name] if d.get("cdi")))
                if not group_cdis and not request_name:
                    group_cdis = list(cdi_ids)   # the claim-level device
                first.cdi_device_ids.extend(group_cdis)
        return resp

    def node_unprepare(self, request: api.NodeUnprepareResourcesRequest
                       ) -> api.NodeUnprepareResourcesResponse:
        resp = api.NodeUnprepareResourcesResponse()
        for claim_ref in request.claims:
            entry = resp.claims.setdefault(
                claim_ref.uid, api.NodeUnprepareResourceResponse())
            try:
                self.state.unprepare_claim(claim_ref.uid)
            except Exception as e:  # noqa: BLE001 - must not wedge teardown
                log.warning("unprepare %s failed: %s", claim_ref.uid, e)
                entry.error = str(e)
        return resp

    # -- serving --------------------------------------------------------------

    def _handlers(self):
        import grpc

        from vtpu_manager_torch.deviceplugin.base import to_proto, unary
        from vtpu_manager_torch.kubeletplugin.api import dra_pb2 as pb

        def claims(msg) -> list[api.Claim]:
            return [api.Claim(c.uid, c.name, c.namespace) for c in msg.claims]

        def prepare(req, ctx):
            return to_proto(self.node_prepare(
                api.NodePrepareResourcesRequest(claims(req))),
                pb.NodePrepareResourcesResponse)

        def unprepare(req, ctx):
            return to_proto(self.node_unprepare(
                api.NodeUnprepareResourcesRequest(claims(req))),
                pb.NodeUnprepareResourcesResponse)

        return grpc.method_handlers_generic_handler("v1beta1dra.DRAPlugin", {
            "NodePrepareResources": unary(
                prepare, pb.NodePrepareResourcesRequest,
                pb.NodePrepareResourcesResponse),
            "NodeUnprepareResources": unary(
                unprepare, pb.NodeUnprepareResourcesRequest,
                pb.NodeUnprepareResourcesResponse),
        })

    def serve(self) -> None:
        from concurrent import futures

        import grpc
        os.makedirs(self.plugin_dir, exist_ok=True)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers((self._handlers(),))
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        log.info("DRA driver serving on %s", self.socket_path)

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=1)
