"""The Kubernetes API the node agent uses, as a protocol.

The port of the JAX package's `client/kube.py:32-90` (`KubeError` and the
`KubeClient` protocol), cut to the verbs the device plugin and the device
manager call. Objects are plain dicts in the API's JSON shape, so a
component takes any client with these methods: `client.fake.FakeKubeClient`
in tests and on the card, the in-cluster REST client in a cluster (not
ported yet: `cmd/device_plugin.py` refuses to run without `--fake-client`).
"""

from __future__ import annotations

from typing import Iterable, Protocol


class KubeError(RuntimeError):
    def __init__(self, status: int, message: str,
                 retry_after: float | None = None):
        super().__init__(f"kube api {status}: {message}")
        self.status = status
        # the API server's pacing hint (Retry-After on 429/5xx)
        self.retry_after = retry_after


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
