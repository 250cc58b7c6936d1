"""A Kubernetes API server stand-in over TLS, for `InClusterClient`.

Serves the REST paths the in-cluster client calls (nodes, pods and their
subresources, events, PodDisruptionBudgets, leases, ResourceClaims,
ResourceClaimTemplates, ResourceSlices, and pod and node watches) from a
`FakeKubeClient` as its store, on 127.0.0.1 at a free port, over TLS with
the given certificate pair. A request needs the bearer token it was
given, as the API server needs the service account's.

Every request is recorded (`requests`: method, path with query, the
Authorization, Accept and Content-Type headers, and the decoded body), so
a test can hold two clients' requests to each other and a phase can show
what reached the server. `script(method, path, status, ...)` makes the
next matching request fail, or answer a watch with the given frames, once:
a 429 with Retry-After, a 500, a watch whose last line is torn or that
carries an in-stream 410.

    stub = ApiStub(cert, key, token="t")
    stub.start()                   # stub.url is https://127.0.0.1:<port>
    client = InClusterClient(stub.url, token_path, ca_path)
    ...
    stub.stop()
"""

from __future__ import annotations

import copy
import json
import re
import ssl
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.client.kube import KubeError

_RESOURCE = "/apis/resource.k8s.io/v1beta1"
_LEASES = "/apis/coordination.k8s.io/v1/namespaces"


@dataclass
class Scripted:
    """One scripted answer: an HTTP error, or (with `frames`) a 200 watch
    stream of exactly these bytes."""
    method: str
    path: str
    status: int = 200
    body: dict = field(default_factory=dict)
    headers: dict = field(default_factory=dict)
    frames: list[bytes] | None = None


def _status(code: int, message: str) -> dict:
    return {"kind": "Status", "apiVersion": "v1", "status": "Failure",
            "code": code, "message": message}


class ApiStub:
    def __init__(self, cert_file: str, key_file: str, token: str = "stub",
                 store: FakeKubeClient | None = None):
        self.token = token
        self.store = store or FakeKubeClient()
        self.requests: list[dict] = []
        self.events: list[dict] = []
        self.leases: dict[tuple[str, str], dict] = {}
        self.templates: dict[tuple[str, str], dict] = {}
        self._scripted: list[Scripted] = []
        self._lock = threading.Lock()
        self._rv = 0
        self._ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self._ctx.load_cert_chain(cert_file, key_file)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.url = ""

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> str:
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:
                pass

            def _serve(self) -> None:
                stub._dispatch(self)

            do_GET = do_PUT = do_POST = do_PATCH = do_DELETE = _serve

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self._httpd.socket = self._ctx.wrap_socket(self._httpd.socket,
                                                   server_side=True)
        self.url = f"https://127.0.0.1:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="apistub")
        self._thread.start()
        return self.url

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = None

    def script(self, method: str, path: str, status: int = 200,
               body: dict | None = None, headers: dict | None = None,
               frames: list[bytes] | None = None) -> None:
        """The next request with this method and path (query left out)
        gets this answer instead of the store's."""
        with self._lock:
            self._scripted.append(Scripted(method, path, status, body or {},
                                           headers or {}, frames))

    def requests_to(self, method: str, prefix: str) -> list[dict]:
        with self._lock:
            return [r for r in self.requests
                    if r["method"] == method and r["path"].startswith(prefix)]

    # -- serving --------------------------------------------------------------

    def _dispatch(self, h: BaseHTTPRequestHandler) -> None:
        length = int(h.headers.get("Content-Length") or 0)
        raw = h.rfile.read(length) if length else b""
        try:
            body = json.loads(raw) if raw else None
        except json.JSONDecodeError:
            body = {"undecodable": raw.decode(errors="replace")}
        split = urlsplit(h.path)
        with self._lock:
            self.requests.append({
                "method": h.command, "path": h.path,
                "authorization": h.headers.get("Authorization"),
                "accept": h.headers.get("Accept"),
                "content_type": h.headers.get("Content-Type"),
                "body": body})
            scripted = next((s for s in self._scripted
                             if (s.method, s.path) == (h.command,
                                                       split.path)), None)
            if scripted is not None:
                self._scripted.remove(scripted)
        if h.headers.get("Authorization") != f"Bearer {self.token}":
            return self._reply(h, 401, _status(401, "Unauthorized"))
        if scripted is not None:
            if scripted.frames is not None:
                return self._stream(h, scripted.frames)
            return self._reply(h, scripted.status,
                               scripted.body or _status(scripted.status,
                                                        "scripted"),
                               scripted.headers)
        query = {k: v[-1] for k, v in parse_qs(split.query).items()}
        try:
            if query.get("watch") == "true":
                return self._stream(h, self._watch_frames(split.path, query))
            code, doc = self._route(h.command, split.path, query, body)
        except KubeError as e:
            code, doc = e.status, _status(e.status, str(e))
        self._reply(h, code, doc)

    @staticmethod
    def _reply(h, code: int, doc: dict, headers: dict | None = None) -> None:
        data = json.dumps(doc).encode()
        h.send_response(code)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            h.send_header(k, str(v))
        h.end_headers()
        h.wfile.write(data)

    @staticmethod
    def _stream(h, frames: list[bytes]) -> None:
        """A watch: the frames, then the connection closes (the server's
        timeoutSeconds)."""
        h.send_response(200)
        h.send_header("Content-Type", "application/json")
        h.send_header("Connection", "close")
        h.end_headers()
        for frame in frames:
            h.wfile.write(frame)
        h.wfile.flush()
        h.close_connection = True

    def _watch_frames(self, path: str, query: dict) -> list[bytes]:
        kind = {"/api/v1/pods": "pods", "/api/v1/nodes": "nodes"}.get(path)
        if kind is None:
            raise KubeError(404, f"no watch on {path}")
        try:
            events = self.store._watch(kind, query.get("resourceVersion", ""))
        except KubeError as e:
            # an expired version: the API server's in-stream ERROR event
            events = [{"type": "ERROR", "object": _status(e.status, str(e))}]
        return [json.dumps(e).encode() + b"\n" for e in events]

    # -- the REST paths -------------------------------------------------------

    def _route(self, method: str, path: str, query: dict,
               body: dict | None) -> tuple[int, dict]:
        store = self.store
        parts = path.strip("/").split("/")
        m = re.fullmatch(r"/api/v1/nodes(?:/([^/]+))?", path)
        if m:
            name = m.group(1)
            if name is None and method == "GET":
                return 200, {"kind": "NodeList",
                             "metadata": {"resourceVersion": str(store._rv)},
                             "items": [store.get_node(n)
                                       for n in sorted(store.nodes)]}
            if method == "GET":
                return 200, store.get_node(name)
            if method == "PATCH":
                return 200, store.patch_node_annotations(
                    name, self._annotations(body))
        m = re.fullmatch(r"/api/v1(?:/namespaces/([^/]+))?/pods", path)
        if m and method == "GET":
            return 200, {"kind": "PodList",
                         "metadata": {"resourceVersion": str(store._rv)},
                         "items": self._list_pods(
                             m.group(1), query.get("fieldSelector", ""))}
        m = re.fullmatch(r"/api/v1/namespaces/([^/]+)/pods/([^/]+)(?:/(\w+))?",
                         path)
        if m:
            ns, name, sub = m.groups()
            return self._pod(method, ns, name, sub, body)
        if (re.fullmatch(r"/api/v1/namespaces/[^/]+/events", path)
                and method == "POST"):
            with self._lock:
                self.events.append(body)
            return 201, body
        if path.endswith("/poddisruptionbudgets") and method == "GET":
            return 200, {"kind": "PodDisruptionBudgetList", "items": []}
        if path.startswith(_LEASES + "/"):
            return self._lease(method, parts[4], parts[6:], body)
        m = re.fullmatch(_RESOURCE + r"/namespaces/([^/]+)/resourceclaims/"
                         r"([^/]+)", path)
        if m and method == "GET":
            return 200, store.get_resourceclaim(*m.groups())
        m = re.fullmatch(_RESOURCE + r"/namespaces/([^/]+)/"
                         r"resourceclaimtemplates", path)
        if m and method == "POST":
            key = (m.group(1), body["metadata"]["name"])
            with self._lock:
                if key in self.templates:
                    raise KubeError(409, f"template {key} exists")
                self.templates[key] = body
            return 201, body
        m = re.fullmatch(_RESOURCE + r"/resourceslices(?:/([^/]+))?", path)
        if m:
            return self._slice(method, m.group(1), body)
        raise KubeError(404, f"{method} {path}: no such path")

    @staticmethod
    def _annotations(body: dict | None) -> dict:
        return ((body or {}).get("metadata") or {}).get("annotations") or {}

    def _list_pods(self, namespace: str | None, selector: str) -> list[dict]:
        pods = self.store.list_pods(namespace)
        for term in filter(None, selector.split(",")):
            key, op, value = re.fullmatch(r"([\w.]+)(!=|=)(.*)",
                                          term).groups()
            if key != "spec.nodeName":
                raise KubeError(400, f"field selector {term!r} not served")
            pods = [p for p in pods
                    if (((p.get("spec") or {}).get("nodeName") or "")
                        == value) == (op == "=")]
        return pods

    def _pod(self, method: str, ns: str, name: str, sub: str | None,
             body: dict | None) -> tuple[int, dict]:
        store = self.store
        if sub is None and method == "GET":
            return 200, store.get_pod(ns, name)
        if sub is None and method == "PATCH":
            return 200, store.patch_pod_annotations(ns, name,
                                                    self._annotations(body))
        if (sub is None and method == "DELETE") or sub == "eviction":
            pod = store.get_pod(ns, name)
            with store._lock:
                del store.pods[(ns, name)]
                store._record_event("pods", "DELETED", pod)
            return (201 if sub else 200), _status(200, "deleted") | {
                "status": "Success"}
        if sub == "binding" and method == "POST":
            pod = store.get_pod(ns, name)
            pod.setdefault("spec", {})["nodeName"] = body["target"]["name"]
            store.add_pod(pod)
            return 201, _status(201, "bound") | {"status": "Success"}
        raise KubeError(405, f"{method} on pod {sub or ''} not served")

    def _lease(self, method: str, ns: str, rest: list[str],
               body: dict | None) -> tuple[int, dict]:
        with self._lock:
            if method == "GET" and len(rest) == 1:
                lease = self.leases.get((ns, rest[0]))
                if lease is None:
                    raise KubeError(404, f"lease {ns}/{rest[0]} not found")
                return 200, copy.deepcopy(lease)
            if method == "POST" and not rest:
                key = (ns, body["metadata"]["name"])
                if key in self.leases:
                    raise KubeError(409, f"lease {key} exists")
            elif method == "PUT" and len(rest) == 1:
                key = (ns, rest[0])
                current = self.leases.get(key)
                if current is None:
                    raise KubeError(404, f"lease {key} not found")
                if (current["metadata"]["resourceVersion"]
                        != body["metadata"].get("resourceVersion")):
                    raise KubeError(409, f"lease {key}: stale version")
            else:
                raise KubeError(405, f"{method} on leases not served")
            lease = copy.deepcopy(body)
            self._rv += 1
            lease["metadata"]["resourceVersion"] = str(self._rv)
            self.leases[key] = lease
            return (201 if method == "POST" else 200), copy.deepcopy(lease)

    def _slice(self, method: str, name: str | None,
               body: dict | None) -> tuple[int, dict]:
        slices = self.store.resourceslices
        if method == "PUT" and name is not None:
            if name not in slices:
                raise KubeError(404, f"resourceslice {name} not found")
            return 200, self.store.apply_resourceslice(body)
        if method == "POST" and name is None:
            if body["metadata"]["name"] in slices:
                raise KubeError(409, "resourceslice exists")
            return 201, self.store.apply_resourceslice(body)
        if method == "GET" and name is not None:
            if name not in slices:
                raise KubeError(404, f"resourceslice {name} not found")
            return 200, copy.deepcopy(slices[name])
        raise KubeError(405, f"{method} on resourceslices not served")
