"""The Kubernetes API the node agent uses: the protocol and the in-cluster
REST client.

The port of the JAX package's `client/kube.py`: `KubeError`, the
`KubeClient` protocol (cut to the verbs the port's components call), the
in-cluster client `InClusterClient` (`:91-310`) with every verb the JAX
one has, and the watch helpers `parse_watch_line` and
`raise_on_watch_error` (`:312-333`). Objects are plain dicts in the API's
JSON shape, so a component takes any client with these methods:
`client.fake.FakeKubeClient` in tests, `InClusterClient` in a cluster.

`InClusterClient` is REST over the pod's service account with `urllib`
and `ssl` (the card machine has no Kubernetes package). Its requests are
the JAX client's, byte for byte: method, path, query, headers and JSON
body. The JAX client's failure-injection hook (`failpoints.fire`) is not
ported. An HTTP error becomes `KubeError(status)`, with the server's
Retry-After; a transport failure (refused, reset, DNS, timeout) becomes
`KubeError(0)`, the class a retry policy retries by definition.
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import urllib.error
import urllib.request
from typing import Iterable, Protocol

log = logging.getLogger(__name__)


class KubeError(RuntimeError):
    def __init__(self, status: int, message: str,
                 retry_after: float | None = None):
        super().__init__(f"kube api {status}: {message}")
        self.status = status
        # the API server's pacing hint (Retry-After on 429/5xx)
        self.retry_after = retry_after


def _retry_after_s(headers) -> float | None:
    """Seconds from a Retry-After header; None when absent or not a number
    (the HTTP-date form is ignored: the API server sends seconds)."""
    raw = headers.get("Retry-After") if headers is not None else None
    if not raw:
        return None
    try:
        return max(0.0, float(raw))
    except (TypeError, ValueError):
        return None


class KubeClient(Protocol):
    def get_node(self, name: str) -> dict: ...
    def patch_node_annotations(self, name: str, annotations: dict) -> dict: ...
    def list_pods(self, namespace: str | None = None,
                  node_name: str | None = None,
                  field_selector: str | None = None) -> list[dict]: ...
    def get_pod(self, namespace: str, name: str) -> dict: ...
    def patch_pod_annotations(self, namespace: str, name: str,
                              annotations: dict) -> dict: ...
    def watch_pods(self, resource_version: str,
                   timeout_s: float = 30.0) -> Iterable[dict]: ...
    def watch_nodes(self, resource_version: str,
                    timeout_s: float = 30.0) -> Iterable[dict]: ...


SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
_RESOURCE = "/apis/resource.k8s.io/v1beta1"
_LEASE_BASE = "/apis/coordination.k8s.io/v1/namespaces"


class InClusterClient:
    """REST client over the pod's service account. `api_server`, the token
    and the CA default to what a pod is given (KUBERNETES_SERVICE_HOST and
    _PORT, the mounted service-account files)."""

    def __init__(self, api_server: str | None = None,
                 token_path: str = f"{SERVICE_ACCOUNT_DIR}/token",
                 ca_path: str = f"{SERVICE_ACCOUNT_DIR}/ca.crt"):
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.base = api_server or f"https://{host}:{port}"
        with open(token_path) as f:
            self._token = f.read().strip()
        self._ctx = ssl.create_default_context(cafile=ca_path)

    # -- plumbing -------------------------------------------------------------

    def _open(self, req: urllib.request.Request, timeout: float):
        req.add_header("Authorization", f"Bearer {self._token}")
        req.add_header("Accept", "application/json")
        try:
            return urllib.request.urlopen(req, context=self._ctx,
                                          timeout=timeout)
        except urllib.error.HTTPError as e:
            raise KubeError(e.code, e.read().decode(errors="replace"),
                            retry_after=_retry_after_s(e.headers)) from e
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            # the request may never have reached the API server
            raise KubeError(0, f"transport: {e}") from e

    def _request(self, method: str, path: str, body: dict | None = None,
                 content_type: str = "application/json") -> dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.base + path, data=data,
                                     method=method)
        if data is not None:
            req.add_header("Content-Type", content_type)
        with self._open(req, timeout=30) as resp:
            try:
                raw = resp.read()
            except (TimeoutError, OSError) as e:
                raise KubeError(0, f"transport: {e}") from e
        return json.loads(raw) if raw else {}

    def _merge_patch(self, path: str, annotations: dict) -> dict:
        return self._request("PATCH", path,
                             {"metadata": {"annotations": annotations}},
                             content_type="application/merge-patch+json")

    # -- nodes and pods -------------------------------------------------------

    def list_nodes(self) -> list[dict]:
        return self._request("GET", "/api/v1/nodes").get("items", [])

    def get_node(self, name: str) -> dict:
        return self._request("GET", f"/api/v1/nodes/{name}")

    def patch_node_annotations(self, name: str, annotations: dict) -> dict:
        return self._merge_patch(f"/api/v1/nodes/{name}", annotations)

    def list_pods(self, namespace: str | None = None,
                  node_name: str | None = None,
                  field_selector: str | None = None) -> list[dict]:
        path = (f"/api/v1/namespaces/{namespace}/pods" if namespace
                else "/api/v1/pods")
        selectors = [s for s in (node_name and f"spec.nodeName={node_name}",
                                 field_selector) if s]
        if selectors:
            path += "?fieldSelector=" + ",".join(selectors)
        return self._request("GET", path).get("items", [])

    def list_pods_with_version(self) -> tuple[list[dict], str]:
        return self._list_with_version("/api/v1/pods")

    def list_nodes_with_version(self) -> tuple[list[dict], str]:
        return self._list_with_version("/api/v1/nodes")

    def _list_with_version(self, path: str) -> tuple[list[dict], str]:
        doc = self._request("GET", path)
        return (doc.get("items", []),
                (doc.get("metadata") or {}).get("resourceVersion", ""))

    def watch_pods(self, resource_version: str,
                   timeout_s: float = 30.0) -> Iterable[dict]:
        return self._watch("/api/v1/pods", resource_version, timeout_s)

    def watch_nodes(self, resource_version: str,
                    timeout_s: float = 30.0) -> Iterable[dict]:
        return self._watch("/api/v1/nodes", resource_version, timeout_s)

    def _watch(self, path: str, resource_version: str,
               timeout_s: float) -> Iterable[dict]:
        """Yields the watch events ({"type", "object"}) as the server sends
        them and returns when it closes the stream (timeoutSeconds). A
        compacted resourceVersion raises KubeError(410), whether the server
        says so by the HTTP status or by an in-stream ERROR event."""
        query = (f"?watch=true&allowWatchBookmarks=true"
                 f"&resourceVersion={resource_version}"
                 f"&timeoutSeconds={max(1, int(timeout_s))}")
        req = urllib.request.Request(self.base + path + query, method="GET")
        with self._open(req, timeout=timeout_s + 30) as resp:
            for line in resp:
                event = parse_watch_line(line)
                if event is None:
                    continue
                raise_on_watch_error(event)
                yield event

    def get_pod(self, namespace: str, name: str) -> dict:
        return self._request("GET",
                             f"/api/v1/namespaces/{namespace}/pods/{name}")

    def patch_pod_annotations(self, namespace: str, name: str,
                              annotations: dict) -> dict:
        return self._merge_patch(
            f"/api/v1/namespaces/{namespace}/pods/{name}", annotations)

    def bind_pod(self, namespace: str, name: str, node: str) -> None:
        self._request("POST",
                      f"/api/v1/namespaces/{namespace}/pods/{name}/binding",
                      {"apiVersion": "v1", "kind": "Binding",
                       "metadata": {"name": name, "namespace": namespace},
                       "target": {"apiVersion": "v1", "kind": "Node",
                                  "name": node}})

    def delete_pod(self, namespace: str, name: str,
                   grace_seconds: int | None = None) -> None:
        path = f"/api/v1/namespaces/{namespace}/pods/{name}"
        if grace_seconds is not None:
            path += f"?gracePeriodSeconds={grace_seconds}"
        self._request("DELETE", path)

    def evict_pod(self, namespace: str, name: str) -> None:
        self._request("POST",
                      f"/api/v1/namespaces/{namespace}/pods/{name}/eviction",
                      {"apiVersion": "policy/v1", "kind": "Eviction",
                       "metadata": {"name": name, "namespace": namespace}})

    def create_event(self, namespace: str, event: dict) -> None:
        self._request("POST", f"/api/v1/namespaces/{namespace}/events", event)

    def list_pdbs(self, namespace: str | None = None) -> list[dict]:
        path = (f"/apis/policy/v1/namespaces/{namespace}"
                "/poddisruptionbudgets" if namespace
                else "/apis/policy/v1/poddisruptionbudgets")
        return self._request("GET", path).get("items", [])

    # -- coordination leases --------------------------------------------------

    def get_lease(self, namespace: str, name: str) -> dict:
        return self._request("GET",
                             f"{_LEASE_BASE}/{namespace}/leases/{name}")

    def create_lease(self, namespace: str, name: str,
                     annotations: dict) -> dict:
        return self._request(
            "POST", f"{_LEASE_BASE}/{namespace}/leases",
            {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
             "metadata": {"name": name, "namespace": namespace,
                          "annotations": annotations},
             "spec": {}})

    def update_lease(self, namespace: str, name: str, annotations: dict,
                     resource_version: str) -> dict:
        # a PUT naming the expected resourceVersion: a stale writer gets 409
        return self._request(
            "PUT", f"{_LEASE_BASE}/{namespace}/leases/{name}",
            {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
             "metadata": {"name": name, "namespace": namespace,
                          "annotations": annotations,
                          "resourceVersion": resource_version},
             "spec": {}})

    # -- DRA objects ----------------------------------------------------------

    def get_resourceclaim(self, namespace: str, name: str) -> dict:
        return self._request(
            "GET", f"{_RESOURCE}/namespaces/{namespace}/resourceclaims/{name}")

    def create_resourceclaim_template(self, template: dict) -> dict:
        ns = template["metadata"].get("namespace", "default")
        return self._request(
            "POST", f"{_RESOURCE}/namespaces/{ns}/resourceclaimtemplates",
            template)

    def apply_resourceslice(self, slice_doc: dict) -> dict:
        """PUT the slice; a 404 (first publication) falls back to POST."""
        name = slice_doc["metadata"]["name"]
        try:
            return self._request("PUT", f"{_RESOURCE}/resourceslices/{name}",
                                 slice_doc)
        except KubeError as e:
            if e.status != 404:
                raise
            return self._request("POST", f"{_RESOURCE}/resourceslices",
                                 slice_doc)


def in_cluster_client(service_account_dir: str = SERVICE_ACCOUNT_DIR
                      ) -> InClusterClient | None:
    """The client over the service account whose token and CA lie in
    `service_account_dir`, or None (logged) when this process has no API
    access there."""
    try:
        return InClusterClient(
            token_path=os.path.join(service_account_dir, "token"),
            ca_path=os.path.join(service_account_dir, "ca.crt"))
    except (OSError, ssl.SSLError) as e:
        log.warning("no API server access: %s", e)
        return None


# -- watch frames ---------------------------------------------------------------

def parse_watch_line(line: bytes) -> dict | None:
    """One newline-delimited watch frame as an event, or None for a blank or
    undecodable one (a torn last line when the server hangs up is normal:
    the next watch starts again from the last version applied)."""
    line = line.strip()
    if not line:
        return None
    try:
        return json.loads(line)
    except json.JSONDecodeError:
        log.debug("undecodable watch frame (%d bytes), skipping", len(line))
        return None


def raise_on_watch_error(event: dict) -> None:
    """An in-stream ERROR event carries a Status: raised as KubeError with
    its code, so a 410 there relists as the HTTP 410 does."""
    if event.get("type") != "ERROR":
        return
    status = event.get("object") or {}
    code = int(status.get("code") or 500)
    raise KubeError(code, str(status.get("message", "watch error")))
