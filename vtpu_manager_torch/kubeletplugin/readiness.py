"""The DRA kubelet plugin's health endpoint: /healthz and /readyz.

The port of the JAX package's `kubeletplugin/readiness.py:24-92`.
`/readyz` answers 200 only while every registered component reports
ready, else 503 with a JSON body naming the failing ones (the
registration socket that could not be served, say); `/healthz` is
liveness, 200 while the process serves.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

log = logging.getLogger(__name__)


class Readiness:
    """Thread-safe component-status registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._components: dict[str, tuple[bool, str]] = {}

    def set(self, component: str, ready: bool, reason: str = "") -> None:
        with self._lock:
            self._components[component] = (ready, reason)

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {name: {"ready": ok, "reason": reason}
                    for name, (ok, reason) in self._components.items()}

    def ready(self) -> bool:
        with self._lock:
            return all(ok for ok, _ in self._components.values())


class ReadinessServer:
    def __init__(self, readiness: Readiness, port: int = 0,
                 host: str = "127.0.0.1"):
        self.readiness = readiness
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok"})
                elif self.path == "/readyz":
                    snap = outer.readiness.snapshot()
                    if outer.readiness.ready():
                        self._reply(200, {"status": "ok",
                                          "components": snap})
                    else:
                        failing = {k: v for k, v in snap.items()
                                   if not v["ready"]}
                        self._reply(503, {"status": "not ready",
                                          "components": failing})
                else:
                    self._reply(404, {"error": "not found"})

            def _reply(self, code: int, body: dict):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, fmt, *args):   # not to stderr
                log.debug("readyz: " + fmt, *args)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="vtpu-readyz")
        self._thread.start()
        log.info("readiness endpoint on :%d", self.port)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
