"""An in-memory KubeClient: pods, nodes, annotation patches and a watch,
and the DRA objects (ResourceClaims, ResourceSlices).

The port of the JAX package's `client/fake.py:35, 343-372`
(`FakeKubeClient`), cut to what the device plugin, the device manager and
the DRA kubelet plugin use. Thread-safe; every
read returns a copy. Every change appends an ADDED / MODIFIED / DELETED
event under one increasing resourceVersion; `watch_pods` / `watch_nodes`
return the events after a version and a trailing BOOKMARK, and raise
KubeError(410) for a version older than what is retained. Each verb fires
the JAX fake's failpoint (`kube.request` with `op=<verb>`, `kube.watch`
with `op=<kind>`), so a spec armed with a `match` selects the same calls.
"""

from __future__ import annotations

import copy
import threading
from collections import deque

from vtpu_manager_torch.client.kube import KubeError
from vtpu_manager_torch.resilience import failpoints

WATCH_RETENTION = 100_000      # events kept per kind


class FakeKubeClient:
    def __init__(self, upsert_on_patch: bool = False):
        # upsert_on_patch: a patch of an unknown pod creates it (for the
        # entry point's fake mode; tests keep the API's 404)
        self.upsert_on_patch = upsert_on_patch
        self._lock = threading.RLock()
        self.nodes: dict[str, dict] = {}
        self.pods: dict[tuple[str, str], dict] = {}
        self.resourceclaims: dict[tuple[str, str], dict] = {}
        self.resourceslices: dict[str, dict] = {}
        self._rv = 0
        self._events: dict[str, deque] = {"pods": deque(), "nodes": deque()}
        self._compacted_rv: dict[str, int] = {"pods": 0, "nodes": 0}

    # -- watch --------------------------------------------------------------

    def _record_event(self, kind: str, type_: str, obj: dict) -> None:
        """Appends one watch event (the caller holds the lock)."""
        self._rv += 1
        queue = self._events[kind]
        queue.append((self._rv, type_, copy.deepcopy(obj)))
        while len(queue) > WATCH_RETENTION:
            dropped_rv, _, _ = queue.popleft()
            self._compacted_rv[kind] = dropped_rv

    def compact_watch_events(self) -> None:
        """Forgets every retained event: a watcher behind now gets 410."""
        with self._lock:
            for kind, queue in self._events.items():
                queue.clear()
                self._compacted_rv[kind] = self._rv

    def _watch(self, kind: str, resource_version: str) -> list[dict]:
        failpoints.fire("kube.watch", op=kind)
        try:
            after = int(resource_version or 0)
        except ValueError as e:
            raise KubeError(400, f"bad resourceVersion "
                                 f"{resource_version!r}") from e
        with self._lock:
            if after < self._compacted_rv[kind]:
                raise KubeError(410, f"too old resource version: {after} "
                                     f"({self._compacted_rv[kind]})")
            out = [{"type": t, "object": obj, "resourceVersion": str(rv)}
                   for rv, t, obj in self._events[kind] if rv > after]
            out.append({"type": "BOOKMARK",
                        "object": {"metadata":
                                   {"resourceVersion": str(self._rv)}},
                        "resourceVersion": str(self._rv)})
            return out

    def watch_pods(self, resource_version: str,
                   timeout_s: float = 30.0) -> list[dict]:
        return self._watch("pods", resource_version)

    def watch_nodes(self, resource_version: str,
                    timeout_s: float = 30.0) -> list[dict]:
        return self._watch("nodes", resource_version)

    # -- fixtures -------------------------------------------------------------

    def add_node(self, node: dict) -> None:
        with self._lock:
            name = node["metadata"]["name"]
            type_ = "MODIFIED" if name in self.nodes else "ADDED"
            self.nodes[name] = copy.deepcopy(node)
            self._record_event("nodes", type_, self.nodes[name])

    def add_pod(self, pod: dict) -> None:
        meta = pod["metadata"]
        key = (meta.get("namespace", "default"), meta["name"])
        with self._lock:
            type_ = "MODIFIED" if key in self.pods else "ADDED"
            self.pods[key] = copy.deepcopy(pod)
            self._record_event("pods", type_, self.pods[key])

    # -- KubeClient -----------------------------------------------------------

    def list_nodes(self) -> list[dict]:
        failpoints.fire("kube.request", op="list_nodes")
        with self._lock:
            return [copy.deepcopy(n) for n in self.nodes.values()]

    def get_node(self, name: str) -> dict:
        failpoints.fire("kube.request", op="get_node")
        with self._lock:
            if name not in self.nodes:
                raise KubeError(404, f"node {name} not found")
            return copy.deepcopy(self.nodes[name])

    @staticmethod
    def _patch(obj: dict, annotations: dict) -> None:
        anns = obj.setdefault("metadata", {}).setdefault("annotations", {})
        for k, v in annotations.items():
            if v is None:
                anns.pop(k, None)
            else:
                anns[k] = v

    def patch_node_annotations(self, name: str, annotations: dict) -> dict:
        failpoints.fire("kube.request", op="patch_node_annotations")
        with self._lock:
            node = self.nodes.get(name)
            if node is None:
                raise KubeError(404, f"node {name} not found")
            self._patch(node, annotations)
            self._record_event("nodes", "MODIFIED", node)
            return copy.deepcopy(node)

    def list_pods(self, namespace=None, node_name=None,
                  field_selector=None) -> list[dict]:
        # only the selector the real client sends: anything else fails
        # here rather than pass against behaviour the API lacks
        if field_selector not in (None, "", "spec.nodeName!="):
            raise NotImplementedError(
                f"unsupported field_selector {field_selector!r}")
        failpoints.fire("kube.request", op="list_pods")
        with self._lock:
            out = []
            for (ns, _), pod in self.pods.items():
                on = (pod.get("spec") or {}).get("nodeName")
                if namespace and ns != namespace:
                    continue
                if node_name and on != node_name:
                    continue
                if field_selector and not on:
                    continue
                out.append(copy.deepcopy(pod))
            return out

    def get_pod(self, namespace: str, name: str) -> dict:
        failpoints.fire("kube.request", op="get_pod")
        with self._lock:
            pod = self.pods.get((namespace, name))
            if pod is None:
                raise KubeError(404, f"pod {namespace}/{name} not found")
            return copy.deepcopy(pod)

    def patch_pod_annotations(self, namespace: str, name: str,
                              annotations: dict) -> dict:
        failpoints.fire("kube.request", op="patch_pod_annotations")
        with self._lock:
            pod = self.pods.get((namespace, name))
            if pod is None:
                if not self.upsert_on_patch:
                    raise KubeError(404, f"pod {namespace}/{name} not found")
                pod = {"metadata": {"name": name, "namespace": namespace,
                                    "annotations": {}},
                       "spec": {}, "status": {"phase": "Pending"}}
                self.pods[(namespace, name)] = pod
            self._patch(pod, annotations)
            self._record_event("pods", "MODIFIED", pod)
            return copy.deepcopy(pod)

    # -- DRA objects ----------------------------------------------------------

    def add_resourceclaim(self, claim: dict) -> None:
        meta = claim["metadata"]
        with self._lock:
            self.resourceclaims[(meta.get("namespace", "default"),
                                 meta["name"])] = copy.deepcopy(claim)

    def get_resourceclaim(self, namespace: str, name: str) -> dict:
        with self._lock:
            claim = self.resourceclaims.get((namespace, name))
            if claim is None:
                raise KubeError(404,
                                f"resourceclaim {namespace}/{name} not found")
            return copy.deepcopy(claim)

    def apply_resourceslice(self, slice_doc: dict) -> dict:
        with self._lock:
            self.resourceslices[slice_doc["metadata"]["name"]] = \
                copy.deepcopy(slice_doc)
            return copy.deepcopy(slice_doc)
